"""``ops.refine_tail``: its plain version against the TPU kernel it ports
(``tools/tail_kernel_proto.py::kernel_unroll`` / ``kernel_dot``, run in
Pallas interpret mode), against ``xla_tail`` and against the JAX package's
own composition (crop_to + add + softmax + blend); the wrapper's routing and
checks; and, on a card only, the CUDA kernel against the plain version.

JAX is imported inside a fixture, not at the top, so that the card test of
this file also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_refine_tail.py

Tolerances: f32 within 1e-6 (the same f32 arithmetic; the blend forms
``(1-eps)y + eps r`` and ``y - eps(y - r)`` differ by a few ulps). bf16: the
plain version rounds once, the JAX composition after every op (and holds eps
in bf16), so they differ by up to 2 bf16 ulps (2^-7) with argmax agreement
>= 99%. Kernel against plain version on the card: f32 within 1e-5, bf16
within one ulp (2^-8).
"""

import functools
import importlib.util
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from iterative_inference_segm_tpu_torch.ops.refine_tail import (  # noqa: E402
    refine_tail,
    refine_tail_reference,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
C = 11
EPS = 0.1


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from iterative_inference_segm_tpu.ops import conv as jconv

    spec = importlib.util.spec_from_file_location("tail_kernel_proto", ROOT / "tools" / "tail_kernel_proto.py")
    proto = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proto)
    return types.SimpleNamespace(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, jconv=jconv, proto=proto)


def _inputs(seed, n=2048, c=C):
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(n, c)) * 3).astype(np.float32)
    z = rng.normal(size=(n, c)) * 2
    y = np.exp(z - z.max(-1, keepdims=True))
    y = (y / y.sum(-1, keepdims=True)).astype(np.float32)
    w = (rng.normal(size=(c, c)) * 0.5).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    return u, y, w, b


def _nhwc(a):
    """(N, C) rows -> (2, 16, N/32, C) maps, the layout the port takes."""
    return torch.from_numpy(a).reshape(2, 16, -1, a.shape[-1])


def _k3_interpret(jx, kernel, u, y, w, b, eps):
    """K3 exactly as ``make_pallas`` calls it (same BlockSpecs and tile),
    run by the Pallas interpreter on the CPU."""
    jnp, pl, pltpu = jx.jnp, jx.pl, jx.pltpu
    n, c = u.shape
    tile = jx.proto.TILE
    call = pl.pallas_call(
        functools.partial(kernel, n_classes=c),
        out_shape=jx.jax.ShapeDtypeStruct((n, c), jnp.float32),
        grid=(n // tile,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((c, c), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, c), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((tile, c), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((tile, c), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tile, c), lambda i: (i, 0), memory_space=pltpu.VMEM),
        interpret=pltpu.InterpretParams(),
    )
    return np.asarray(call(jnp.asarray([eps], jnp.float32), w, b[None, :], u, y))


@pytest.mark.parametrize("kernel", ["kernel_unroll", "kernel_dot"])
def test_reference_matches_k3_pallas_kernel(jx, kernel):
    u, y, w, b = _inputs(0)
    want = _k3_interpret(jx, getattr(jx.proto, kernel), u, y, w, b, EPS)
    got = refine_tail_reference(_nhwc(u), _nhwc(y), EPS, w=torch.from_numpy(w), b=torch.from_numpy(b))
    np.testing.assert_allclose(got.reshape(-1, C).numpy(), want, rtol=1e-6, atol=1e-6)


def test_reference_matches_xla_tail(jx):
    u, y, w, b = _inputs(1)
    want = np.asarray(jx.proto.xla_tail(u, y, w, b, EPS))
    got = refine_tail_reference(_nhwc(u), _nhwc(y), EPS, w=torch.from_numpy(w), b=torch.from_numpy(b))
    np.testing.assert_allclose(got.reshape(-1, C).numpy(), want, rtol=1e-6, atol=1e-6)


def _jax_composition(jx, u, v, y, eps, dtype):
    """The JAX package's own per-step tail: crop_to + add, softmax, blend."""
    jnp = jx.jnp
    yj = jnp.asarray(y).astype(dtype)
    logits = jx.jconv.crop_to(jnp.asarray(u).astype(dtype), y.shape[1], y.shape[2]) + jnp.asarray(v).astype(dtype)
    r = jx.jax.nn.softmax(logits, -1)
    eps_s = jnp.asarray(eps, dtype)
    return np.asarray((yj - eps_s * (yj - r)).astype(jnp.float32))


@pytest.mark.parametrize("u_hw", [(24, 32), (27, 37)])  # the second is cropped at offsets (1, 2)
def test_reference_matches_jax_composition_f32(jx, u_hw):
    rng = np.random.default_rng(2)
    u = (rng.normal(size=(2, *u_hw, C)) * 3).astype(np.float32)
    v = (rng.normal(size=(2, 24, 32, C)) * 3).astype(np.float32)
    y = np.array(jx.jax.nn.softmax(rng.normal(size=(2, 24, 32, C)).astype(np.float32) * 2, -1))
    want = _jax_composition(jx, u, v, y, EPS, jx.jnp.float32)
    got, labels = refine_tail_reference(
        torch.from_numpy(u), torch.from_numpy(y), EPS, v=torch.from_numpy(v), with_labels=True
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), want.argmax(-1))


def test_reference_matches_jax_composition_bf16(jx):
    rng = np.random.default_rng(3)
    u = (rng.normal(size=(4, 30, 40, C)) * 3).astype(np.float32)
    v = (rng.normal(size=(4, 30, 40, C)) * 3).astype(np.float32)
    y = np.array(jx.jax.nn.softmax(rng.normal(size=(4, 30, 40, C)).astype(np.float32) * 2, -1))
    bf = jx.jnp.bfloat16
    # the same bf16 inputs on both sides
    u, v, y = (np.array(jx.jnp.asarray(a).astype(bf).astype(jx.jnp.float32)) for a in (u, v, y))
    want = _jax_composition(jx, u, v, y, EPS, bf)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = refine_tail_reference(t(u), t(y), EPS, v=t(v))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2.0**-7
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_cpu_tensors_take_the_plain_version_uncounted():
    u, y, w, b = _inputs(4)
    before = refine_tail.launches
    got, labels = refine_tail(_nhwc(u), _nhwc(y), EPS, w=torch.from_numpy(w), b=torch.from_numpy(b),
                              with_labels=True)
    want, want_labels = refine_tail_reference(_nhwc(u), _nhwc(y), EPS, w=torch.from_numpy(w),
                                              b=torch.from_numpy(b), with_labels=True)
    assert refine_tail.launches == before
    assert torch.equal(got, want) and torch.equal(labels, want_labels)
    assert torch.equal(labels, got.argmax(-1).to(torch.int32))


def _maps(dtype=torch.float32, hw=(4, 6), u_hw=None, c=C):
    g = torch.Generator().manual_seed(5)
    y = torch.softmax(torch.randn((2, *hw, c), generator=g), -1).to(dtype)
    u = torch.randn((2, *(u_hw or hw), c), generator=g).to(dtype)
    return u, y


@pytest.mark.parametrize(
    "case",
    ["float16", "float64", "mixed", "v_shape", "u_small", "u_batch", "too_many_classes",
     "rank", "w_dtype", "w_shape", "b_shape", "empty", "meta_device"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    u, y = _maps()
    kw = {}
    if case == "float16":
        u, y = u.half(), y.half()
    elif case == "float64":
        u, y = u.double(), y.double()
    elif case == "mixed":
        u = u.to(torch.bfloat16)
    elif case == "v_shape":
        kw["v"] = torch.zeros((2, 4, 5, C))
    elif case == "u_small":
        u = u[:, :3]
    elif case == "u_batch":
        u = u[:1]
    elif case == "too_many_classes":
        u, y = _maps(c=33)
    elif case == "rank":
        u, y = u[0], y[0]
    elif case == "w_dtype":
        kw["w"] = torch.zeros((C, C), dtype=torch.float64)
    elif case == "w_shape":
        kw["w"] = torch.zeros((C, C + 1))
    elif case == "b_shape":
        kw["b"] = torch.zeros((1, C))
    elif case == "empty":
        u, y = u[:, :0], y[:, :0]
    elif case == "meta_device":
        u, y = u.to("meta"), y.to("meta")
    with pytest.raises((TypeError, ValueError)):
        refine_tail(u, y, EPS, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["v", "crop", "w", "labels"])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, variant):
    u, y = _maps(dtype, hw=(45, 61), u_hw=(48, 66) if variant == "crop" else None)
    kw = {"v": torch.randn(y.shape, generator=torch.Generator().manual_seed(6)).to(dtype)}
    if variant == "w":
        kw = {"w": torch.randn((C, C)) * 0.5, "b": torch.randn((C,))}
    if variant == "labels":
        kw["with_labels"] = True
    dev = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
    before = refine_tail.launches
    got = refine_tail(u.to(cuda_device), y.to(cuda_device), EPS, **dev)
    torch.cuda.synchronize()
    assert refine_tail.launches == before + 1
    want = refine_tail_reference(u, y, EPS, **kw)
    if variant == "labels":
        (got, labels), (want, want_labels) = got, want
        assert labels.dtype == torch.int32
        assert torch.equal(labels.cpu(), got.cpu().float().argmax(-1).to(torch.int32))
        assert (labels.cpu() == want_labels).float().mean() >= 0.999
    tol = 1e-5 if dtype == torch.float32 else 2.0**-8
    assert (got.cpu().float() - want.float()).abs().max() <= tol
