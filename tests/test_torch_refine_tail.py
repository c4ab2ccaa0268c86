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
    MAX_CLASSES,
    check_kernel_classes,
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


@pytest.mark.parametrize("with_labels", [False, True])
def test_kernel_under_autograd_carries_the_plain_versions_gradient(monkeypatch, with_labels):
    """On a CUDA tensor that takes part in autograd the wrapper launches the
    kernel and differentiates the plain version in the backward. Here the
    launch is stood in for by the plain version (a CPU cannot launch it):
    the gradient in u, y, v and W equals autograd's through the plain
    version, also taken twice (create_graph), and the labels carry none."""
    import iterative_inference_segm_tpu_torch.ops.refine_tail as rt

    launched = []
    monkeypatch.setattr(rt, "_launch", lambda u, y, eps, v, w, b, labels: launched.append(1) or
                        refine_tail_reference(u, y, eps, v=v, w=w, b=b, with_labels=labels))
    g = torch.Generator().manual_seed(3)
    u = torch.randn((2, 7, 9, C), generator=g, requires_grad=True)
    y = torch.softmax(torch.randn((2, 5, 7, C), generator=g), -1).requires_grad_(True)
    v = torch.randn((2, 5, 7, C), generator=g, requires_grad=True)
    w = torch.randn((C, C), generator=g, requires_grad=True)
    ct = torch.randn((2, 5, 7, C), generator=g)
    out = rt._KernelWithPlainBackward.apply(u, y, v, w, None, EPS, with_labels)
    if with_labels:
        out, labels = out
        assert not labels.requires_grad
    got = torch.autograd.grad(torch.sum(out * ct), [u, y, v, w], create_graph=True)
    want = torch.autograd.grad(torch.sum(refine_tail_reference(u, y, EPS, v=v, w=w) * ct), [u, y, v, w],
                               create_graph=True)
    assert launched == [1] and all(torch.equal(a, b) for a, b in zip(got, want))
    second = torch.autograd.grad(torch.sum(got[0] ** 2), [w])[0]
    assert torch.equal(second, torch.autograd.grad(torch.sum(want[0] ** 2), [w])[0])


@pytest.mark.parametrize("u_hw", [(24, 32), (27, 37)])
def test_reference_takes_bf16_u_beside_f32_y(jx, u_hw):
    """bf16 logits beside an f32 map (the general engine's step): bit-equal
    to the same call with ``u.float()``, and the JAX composition on the
    widened logits at the f32 tolerance."""
    rng = np.random.default_rng(7)
    u = torch.from_numpy((rng.normal(size=(2, *u_hw, C)) * 3).astype(np.float32)).to(torch.bfloat16)
    y = np.array(jx.jax.nn.softmax(rng.normal(size=(2, 24, 32, C)).astype(np.float32) * 2, -1))
    got, labels = refine_tail_reference(u, torch.from_numpy(y), EPS, with_labels=True)
    want, want_labels = refine_tail_reference(u.float(), torch.from_numpy(y), EPS, with_labels=True)
    assert got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(labels, want_labels)
    routed = refine_tail(u, torch.from_numpy(y), EPS)  # the wrapper takes the pair on the CPU
    assert torch.equal(routed, got)
    jax_want = _jax_composition(jx, u.float().numpy(), np.zeros_like(y), y, EPS, jx.jnp.float32)
    np.testing.assert_allclose(got.numpy(), jax_want, rtol=1e-6, atol=1e-6)


def testrow_packed_reads_the_layouts_the_engines_hand_over():
    """NHWC views of channels_last tensors, cropped or not, are row-packed;
    a map whose classes or pixels are strided is not."""
    from iterative_inference_segm_tpu_torch.ops.refine_tail import row_packed

    nchw = torch.zeros((2, C, 10, 14)).to(memory_format=torch.channels_last)
    nhwc = nchw.permute(0, 2, 3, 1)
    assert row_packed(nhwc) and row_packed(nhwc[:, 1:9, 2:12])
    assert row_packed(torch.zeros((2, 10, 14, C))[:, :, 3:])
    assert not row_packed(torch.zeros((2, C, 10, 14)).permute(0, 2, 3, 1))  # NCHW memory
    assert not row_packed(torch.zeros((2, 10, 14, 2 * C))[..., ::2])
    assert not row_packed(torch.zeros((2, 10, 28, C))[:, :, ::2])
    assert row_packed(torch.zeros((2, 10, 1, C)).as_strided((2, 10, 1, C), (10 * C, C, 999, 1)))


def _maps(dtype=torch.float32, hw=(4, 6), u_hw=None, c=C):
    g = torch.Generator().manual_seed(5)
    y = torch.softmax(torch.randn((2, *hw, c), generator=g), -1).to(dtype)
    u = torch.randn((2, *(u_hw or hw), c), generator=g).to(dtype)
    return u, y


@pytest.mark.parametrize(
    "case",
    ["float16", "float64", "mixed", "u_float16", "v_bfloat16", "v_shape", "u_small", "u_batch",
     "too_many_classes", "rank", "w_dtype", "w_shape", "b_shape", "empty", "meta_device"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    u, y = _maps()
    kw = {}
    if case == "float16":
        u, y = u.half(), y.half()
    elif case == "float64":
        u, y = u.double(), y.double()
    elif case == "mixed":  # f32 u beside a bf16 y (bf16 u beside an f32 y is taken)
        y = y.to(torch.bfloat16)
    elif case == "u_float16":
        u = u.half()
    elif case == "v_bfloat16":  # v keeps y's dtype even where u may be bf16
        u, kw["v"] = u.to(torch.bfloat16), torch.zeros(y.shape, dtype=torch.bfloat16)
    elif case == "v_shape":
        kw["v"] = torch.zeros((2, 4, 5, C))
    elif case == "u_small":
        u = u[:, :3]
    elif case == "u_batch":
        u = u[:1]
    elif case == "too_many_classes":  # no cap on the CPU; the kernel's own is named for a CUDA tensor
        for c in (33, 128, 200):
            u, y = _maps(c=c)
            got, labels = refine_tail(u, y, EPS, with_labels=True)
            assert torch.equal(got, refine_tail_reference(u, y, EPS)) and int(labels.max()) < c
        assert MAX_CLASSES == 128
        check_kernel_classes("refine_tail", MAX_CLASSES)
        with pytest.raises(ValueError, match="129 classes on a CUDA tensor; the kernel takes 1..128"):
            check_kernel_classes("refine_tail", MAX_CLASSES + 1)
        u, y = _maps(c=1)
        u, y = u[..., :0], y[..., :0]  # and no classes at all are refused anywhere
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


# (variant, y's (H, W), u's (H, W) or None, classes); u wider by 1, 3 and 5
# pixels puts its row spans at 2-byte alignment (bf16) in a 16-byte chunk;
# W=200 is no multiple of the kernel's tile, and W=1 a one-pixel row.
CARD_CASES = [
    ("v", (45, 61), None, C), ("crop", (45, 61), (48, 66), C), ("w", (45, 61), None, C),
    ("labels", (45, 61), None, C), ("u_bf16", (45, 61), (46, 64), C),
    ("crop", (7, 129), (8, 130), C), ("crop", (7, 129), (10, 132), C), ("crop", (7, 129), (12, 134), C),
    ("labels", (5, 200), (6, 203), C), ("labels", (9, 1), None, C),
    ("labels", (6, 40), (7, 43), 1), ("labels", (6, 40), (7, 43), 16),
    ("labels", (6, 40), (7, 43), 17), ("labels", (6, 40), (7, 43), 32),
    ("strided", (45, 61), (48, 66), C),
    # 33..128 classes: the wide instance, a pixel's classes in shared memory
    ("labels", (6, 40), (7, 43), 33), ("labels", (5, 200), (6, 203), 64), ("labels", (6, 40), (7, 43), 128),
    ("w", (6, 40), None, 40), ("u_bf16", (6, 140), (7, 143), 128), ("strided", (6, 40), (7, 43), 33),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant,hw,u_hw,c", CARD_CASES)
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, variant, hw, u_hw, c):
    u, y = _maps(dtype, hw=hw, u_hw=u_hw, c=c)
    kw = {"v": torch.randn(y.shape, generator=torch.Generator().manual_seed(6)).to(dtype)}
    if variant == "w":
        kw = {"w": torch.randn((c, c)) * 0.5, "b": torch.randn((c,))}
    if variant == "labels":
        kw["with_labels"] = True
    if variant == "u_bf16":  # the general engine's bf16 logits beside an f32 map
        u, y, kw = u.to(torch.bfloat16), y.float(), {}
    if variant == "strided":  # u and v as NCHW memory seen through NHWC strides
        u = u.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        kw["v"] = kw["v"].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    dev = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
    before, strided = refine_tail.launches, refine_tail.strided_launches
    got = refine_tail(u.to(cuda_device), y.to(cuda_device), EPS, **dev)
    torch.cuda.synchronize()
    assert refine_tail.launches == before + 1
    assert refine_tail.strided_launches == strided + (variant == "strided")
    want = refine_tail_reference(u, y, EPS, **kw)
    if variant == "labels":
        (got, labels), (want, want_labels) = got, want
        assert labels.dtype == torch.int32
        assert torch.equal(labels.cpu(), got.cpu().float().argmax(-1).to(torch.int32))
        assert (labels.cpu() == want_labels).float().mean() >= 0.999
    tol = 1e-5 if y.dtype == torch.float32 else 2.0**-8
    assert (got.cpu().float() - want.float()).abs().max() <= tol


@pytest.mark.cuda
def test_more_than_128_classes_raise_on_card(cuda_device):
    """The JAX engines have no cap; the kernel keeps a pixel's classes on
    chip and takes 128. A CUDA tensor is never handed to the plain version."""
    u, y = _maps(c=MAX_CLASSES + 1)
    before = refine_tail.launches
    with pytest.raises(ValueError, match="takes 1..128"):
        refine_tail(u.to(cuda_device), y.to(cuda_device), EPS)
    assert refine_tail.launches == before
