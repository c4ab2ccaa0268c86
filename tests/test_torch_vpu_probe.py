"""``ops.vpu_probe``: the plain versions of K4 and K5 against the TPU kernels
they port (``tools/vpu_probe.py::fma_kernel`` / ``pattern_kernel``, run in
Pallas interpret mode on blocks of exactly (1, 36, 11, 240), since
``pattern_kernel`` builds its zero pads from the module's R, C, W); the
wrappers' routing and refusals; and, on a card only, the CUDA kernels
against the plain versions.

JAX is imported inside a fixture, so that the card tests of this file also
run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_vpu_probe.py

Tolerances. K4: bit-equal in f32 and bf16 (XLA contracts the kernel's
``acc + x * w`` into one multiply-add, which the plain version's
``torch.addcmul`` chain also computes). K5, f32: the plain version keeps
the TPU kernel's order of operations with every product rounded, while
XLA's CPU backend contracts ``x * k + 0.5 * left`` into one fused
multiply-add, which moves ``s`` by an ulp where it lands; through the
softmax that is at most 16 ulps of each output (measured: 10.2 x 2^-23
relative at most; with the contraction emulated the two agree within 4
ulps, the gap between XLA's and PyTorch's ``exp``). K5, bf16: within 2^-8
with argmax agreement >= 99.9% (measured: bit-equal). Kernels against
plain versions on the card: K4 f32 bit-equal (a kernel that rounds ``acc
+ x * w`` twice is off by up to 3e-5 at |acc| ~ 30 and fails), bf16 within
one bf16 ulp of the value; K5 f32 within 1e-6, bf16 within 2^-8.
"""

import functools
import importlib.util
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from iterative_inference_segm_tpu_torch.ops.vpu_probe import (  # noqa: E402
    fma_chain,
    fma_chain_reference,
    pattern_softmax,
    pattern_softmax_reference,
)
from iterative_inference_segm_tpu_torch.tools import vpu_probe as tool  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
W8 = np.linspace(0.9, 1.1, 8, dtype=np.float32)
F32_ULPS = 16 * 2.0**-23


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = importlib.util.spec_from_file_location("vpu_probe", ROOT / "tools" / "vpu_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return types.SimpleNamespace(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, probe=probe)


def _block(jx):
    p = jx.probe
    return jx.pl.BlockSpec((1, p.R, p.C, p.W), lambda i: (i, 0, 0, 0), memory_space=jx.pltpu.VMEM)


def _x(jx, dtype, seed=0, n=2):
    """Two blocks of N(0, 1) at ``dtype``; the same values in both packages."""
    p = jx.probe
    x = np.random.default_rng(seed).normal(size=(n, p.R, p.C, p.W)).astype(np.float32)
    xj = jx.jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.asarray(xj.astype(jx.jnp.float32)))
    return xj, xt.to(torch.bfloat16 if dtype == jx.jnp.bfloat16 else torch.float32)


def _fma_interpret(jx, x, n_fma):
    """``fma_kernel`` with the BlockSpecs of ``make_fma_loop``, interpreted."""
    call = jx.pl.pallas_call(
        functools.partial(jx.probe.fma_kernel, n_fma=n_fma),
        out_shape=jx.jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(x.shape[0],),
        in_specs=[_block(jx), jx.pl.BlockSpec(memory_space=jx.pltpu.SMEM)],
        out_specs=_block(jx),
        interpret=jx.pltpu.InterpretParams(),
    )
    return np.asarray(call(x, jx.jnp.asarray(W8.reshape(8, 1))).astype(jx.jnp.float32))


def _pattern_interpret(jx, x, k):
    """``pattern_kernel`` with the BlockSpecs of ``run_patterns``, interpreted."""
    p = jx.probe
    call = jx.pl.pallas_call(
        p.pattern_kernel,
        out_shape=jx.jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(x.shape[0],),
        in_specs=[_block(jx), jx.pl.BlockSpec((1, p.C, 1), lambda i: (0, 0, 0), memory_space=jx.pltpu.VMEM)],
        out_specs=_block(jx),
        interpret=jx.pltpu.InterpretParams(),
    )
    return np.asarray(call(x, k).astype(jx.jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_fma", [2, 26])
def test_fma_plain_is_bit_equal_to_pallas_kernel(jx, dtype, n_fma):
    xj, xt = _x(jx, getattr(jx.jnp, dtype))
    want = _fma_interpret(jx, xj, n_fma)
    got = fma_chain_reference(xt, W8, n_fma)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_fma_plain_differs_from_two_roundings(jx):
    """The contraction matters: ``acc + x * w`` rounded twice is not it."""
    xj, xt = _x(jx, jx.jnp.float32)
    want = _fma_interpret(jx, xj, 26)
    acc = xt.clone()
    for i in range(26):
        acc = acc + xt * float(W8[i % 8])
    assert np.abs(acc.numpy() - want).max() > 0


def test_pattern_plain_matches_pallas_kernel_f32(jx):
    xj, xt = _x(jx, jx.jnp.float32, seed=1)
    k = np.linspace(0.5, 1.5, jx.probe.C, dtype=np.float32)
    want = _pattern_interpret(jx, xj, jx.jnp.asarray(k.reshape(1, -1, 1)))
    got = pattern_softmax_reference(xt, torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_ULPS, atol=0)
    assert (got.argmax(2) == want.argmax(2)).mean() == 1.0
    np.testing.assert_allclose(got.sum(2), 1.0, atol=1e-6)


def test_pattern_plain_matches_pallas_kernel_bf16(jx):
    xj, xt = _x(jx, jx.jnp.bfloat16, seed=2)
    k = np.linspace(0.5, 1.5, jx.probe.C, dtype=np.float32)
    want = _pattern_interpret(jx, xj, jx.jnp.asarray(k.reshape(1, -1, 1)))
    got = pattern_softmax_reference(xt, torch.from_numpy(k))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2.0**-8
    assert (got.argmax(2) == want.argmax(2)).mean() >= 0.999


def test_pattern_adds_class_3_from_before_the_update():
    """Every class gets 0.01 x class 3's value from before the update."""
    x = torch.zeros((1, 2, 5, 3))
    x[0, 0, 3, 1] = 8.0
    x[0, 0, 0, 1] = 4.0
    got = pattern_softmax_reference(x, torch.ones(5))
    s = torch.tensor([4.0, 0.0, 0.0, 8.0, 0.0]) + 0.08  # s3 = 8 before the update
    torch.testing.assert_close(got[0, 0, :, 1], torch.softmax(s, 0), rtol=1e-6, atol=0)


@pytest.mark.parametrize(
    "times, want",
    [({2: 1.0, 4: 1.05, 8: 1.2, 26: 2.0}, (4, 8)), ({2: 1.0, 26: 1.5}, (2, 26)),
     ({2: 1.0, 8: 1.08, 26: 1.05}, (26, None))],
)
def test_crossover_is_the_first_measured_rise(times, want):
    assert tool.crossover(times) == want


def test_cpu_tensors_take_the_plain_versions_uncounted():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 6, 11, 10), generator=g)
    k = torch.linspace(0.5, 1.5, 11)
    before = (fma_chain.launches, pattern_softmax.launches)
    assert torch.equal(fma_chain(x, W8, 9), fma_chain_reference(x, W8, 9))
    torch.testing.assert_close(pattern_softmax(x, k), pattern_softmax_reference(x, k), rtol=1e-6, atol=1e-7)
    assert torch.equal(fma_chain(x, W8, 0), x)
    assert (fma_chain.launches, pattern_softmax.launches) == before


@pytest.mark.parametrize(
    "case", ["fma_float16", "fma_weights", "fma_negative", "fma_meta", "fma_empty", "pat_float64",
             "pat_rank", "pat_3_classes", "pat_17_classes", "pat_k_size", "pat_k_dtype", "pat_meta"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    x = torch.zeros((1, 2, 11, 4))
    k = torch.ones(11)
    calls = {
        "fma_float16": lambda: fma_chain(x.half(), W8, 2),
        "fma_weights": lambda: fma_chain(x, W8[:7], 2),
        "fma_negative": lambda: fma_chain(x, W8, -1),
        "fma_meta": lambda: fma_chain(x.to("meta"), W8, 2),
        "fma_empty": lambda: fma_chain(x[:0], W8, 2),
        "pat_float64": lambda: pattern_softmax(x.double(), k),
        "pat_rank": lambda: pattern_softmax(x[0], k),
        "pat_3_classes": lambda: pattern_softmax(x[:, :, :3], k[:3]),
        "pat_17_classes": lambda: pattern_softmax(torch.zeros((1, 2, 17, 4)), torch.ones(17)),
        "pat_k_size": lambda: pattern_softmax(x, k[:10]),
        "pat_k_dtype": lambda: pattern_softmax(x, k.double()),
        "pat_meta": lambda: pattern_softmax(x.to("meta"), k.to("meta")),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()


def test_tool_sweep_matches_the_tpu_tool(jx):
    """The port's tool keeps the JAX tool's constants and sweep."""
    p = jx.probe
    assert (tool.R, tool.C, tool.W, tool.NH, tool.B, tool.LOOP) == (p.R, p.C, p.W, p.NH, p.B, p.LOOP)
    assert tool.N_FMA == (2, 26, 50, 100)
    assert tool.launches_per_sweep() == {"fma_chain": 4 * 20 * (4 + 5) * 2, "pattern_softmax": 4 * 20 * 2}
    assert tool.main() == 1 or torch.cuda.is_available()  # no card: refuses, prints no result


def test_profile_summary_and_refusals():
    """The general-engine profiler's arithmetic, and its refusals without a
    card or without traced device time."""
    from iterative_inference_segm_tpu_torch.tools import profile_general as prof

    got = prof.summarize([("conv", 600.0), ("relu", 200.0), ("conv", 200.0)], iters=2, event_ms=0.8)
    assert got["device_ms"] == pytest.approx(0.5) and got["idle"] == pytest.approx(0.375)
    assert got["ops"] == 1.5
    assert got["top"] == [("conv", pytest.approx(0.4), pytest.approx(0.8)),
                          ("relu", pytest.approx(0.1), pytest.approx(0.2))]
    assert got["tail"] == []
    tail = prof.summarize([("conv", 600.0), (prof.TAIL + "<f>", 200.0)], iters=2, event_ms=0.8)["tail"]
    assert tail == [(prof.TAIL + "<f>", pytest.approx(0.1), pytest.approx(0.25))]
    other = prof.summarize([("conv", 600.0), ("septail_step_kernel<f>", 200.0)], iters=2, event_ms=0.8,
                           tail="septail_step_kernel")["tail"]
    assert other == [("septail_step_kernel<f>", pytest.approx(0.1), pytest.approx(0.25))]
    with pytest.raises(RuntimeError, match="no device time"):
        prof.summarize([], iters=1, event_ms=1.0)
    assert prof.main() == 1 or torch.cuda.is_available()  # no card: refuses, prints no result


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_fma", [0, 2, 13, 100])
def test_fma_kernel_matches_plain_version_on_card(cuda_device, dtype, n_fma):
    x = torch.randn((3, 36, 11, 240), generator=torch.Generator().manual_seed(4)).to(dtype)
    before = fma_chain.launches
    got = fma_chain(x.to(cuda_device), W8, n_fma)
    torch.cuda.synchronize()
    assert fma_chain.launches == before + 1 and got.dtype == dtype
    want = fma_chain_reference(x, W8, n_fma)
    if dtype == torch.float32:
        assert torch.equal(got.cpu(), want)  # one rounding a step, as addcmul
    else:
        err = (got.cpu().float() - want.float()).abs()
        assert (err <= 2.0**-7 * want.float().abs()).all()  # one bf16 ulp of the value


# K4's vector path: lengths around one 16-byte vector (4 f32, 8 bf16), and
# views that start 1, 3 and 5 elements into a 16-byte-aligned buffer, so that
# a scalar head, the vectors and a scalar tail all run; n_fma = 45 runs the
# loop unrolled by 32, the one by 8 and the remainder.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length,offset", [(1, 0), (7, 0), (8, 0), (9, 0), (1000, 1), (1003, 3), (37, 5), (3, 1)])
def test_fma_kernel_vector_ends_on_card(cuda_device, dtype, length, offset):
    base = torch.randn(length + offset, generator=torch.Generator().manual_seed(6)).to(dtype)
    x = base.to(cuda_device)[offset:]
    assert x.data_ptr() % 16 == (offset * x.element_size()) % 16
    before = fma_chain.launches
    got = fma_chain(x, W8, 45)
    torch.cuda.synchronize()
    assert fma_chain.launches == before + 1 and got.shape == x.shape and got.is_contiguous()
    want = fma_chain_reference(base[offset:], W8, 45)
    if dtype == torch.float32:
        assert torch.equal(got.cpu(), want)
    else:
        err = (got.cpu().float() - want.float()).abs()
        assert (err <= 2.0**-7 * want.float().abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pattern_kernel_takes_a_view_off_the_vector_boundary(cuda_device, dtype):
    """W = 8 fits the instance that takes 4 w a thread, but a view one
    element into its buffer does not start on that boundary: its tiles are
    staged with their head carried and computed one w a thread."""
    base = torch.randn(1 + 2 * 3 * 11 * 8, generator=torch.Generator().manual_seed(8)).to(dtype)
    x = base.to(cuda_device)[1:].view(2, 3, 11, 8)
    assert x.is_contiguous() and x.data_ptr() % 8 == x.element_size()
    k = torch.linspace(0.5, 1.5, 11)
    got = pattern_softmax(x, k.to(cuda_device))
    torch.cuda.synchronize()
    want = pattern_softmax_reference(base[1:].view(2, 3, 11, 8), k).float()
    assert (got.cpu().float() - want).abs().max() <= (1e-6 if dtype == torch.float32 else 2.0**-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_take_views_as_their_contiguous_copies(dtype):
    """A view with strides (every other column; a transposed pair of axes;
    an odd element offset) gives what its contiguous copy gives."""
    g = torch.Generator().manual_seed(7)
    big = torch.randn((2, 5, 11, 21), generator=g).to(dtype)
    k = torch.linspace(0.5, 1.5, 11)
    for view in (big[..., ::2], big[:, 1:4], big.transpose(0, 1), big.reshape(-1)[1:-1]):
        assert not view.is_contiguous() or view.storage_offset() % 2 == 1
        assert torch.equal(fma_chain(view, W8, 9), fma_chain_reference(view.contiguous(), W8, 9))
        if view.dim() == 4:
            assert torch.equal(pattern_softmax(view, k), pattern_softmax_reference(view.contiguous(), k))


# K5's instances: W = 240, 700, 8 and 4 are multiples of the 4 w a thread
# takes, so rows start on that boundary (C = 11 exactly unrolled, C = 4 and
# 16 against a run-time C); W = 7, 33 and 1 are computed one w a thread from
# tiles whose spans start off a 16-byte boundary; R = 1 has no row below,
# R = 4, 5 and 36 end in tiles of 1, 2 and 3 rows; three rows of 16 x 1000
# f32 do not fit a block's shared memory, so that tile holds one row.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 36, 11, 240), (3, 5, 4, 7), (1, 1, 16, 33), (2, 1, 4, 7), (2, 1, 11, 33),
                                   (1, 1, 16, 240), (2, 3, 11, 7), (1, 5, 16, 33), (2, 3, 4, 240),
                                   (1, 2, 11, 700), (3, 4, 11, 1), (2, 3, 16, 8), (1, 2, 5, 4), (1, 4, 16, 1000)])
def test_pattern_kernel_matches_plain_version_on_card(cuda_device, dtype, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5)).to(dtype)
    k = torch.linspace(0.5, 1.5, shape[2])
    before = pattern_softmax.launches
    got = pattern_softmax(x.to(cuda_device), k.to(cuda_device))
    torch.cuda.synchronize()
    assert pattern_softmax.launches == before + 1
    want = pattern_softmax_reference(x, k).float()
    tol = 1e-6 if dtype == torch.float32 else 2.0**-8
    assert got.shape == x.shape and got.dtype == dtype
    assert (got.cpu().float() - want).abs().max() <= tol


@pytest.mark.cuda
def test_pattern_kernel_refuses_a_row_that_does_not_fit_shared_memory(cuda_device):
    """A tile holds a C x W row, the row below and the results: 3 x 16 x
    1300 f32 are over a block's 227 KB; the wrapper names the limit."""
    x = torch.zeros((1, 2, 16, 1300), device=cuda_device)
    before = pattern_softmax.launches
    with pytest.raises(ValueError, match="shared memory"):
        pattern_softmax(x, torch.ones(16, device=cuda_device))
    assert pattern_softmax.launches == before
    pattern_softmax(x[..., :1000], torch.ones(16, device=cuda_device))
    assert pattern_softmax.launches == before + 1
