"""``ops.septail_step``, the phase-major engine's full-resolution step: the
wrapper's checks and routing on the CPU, and, on a card only, the CUDA
kernel against its plain version (``septail_step_reference``; the plain
version against the JAX package is ``tests/test_torch_fused_engine.py``).

No JAX here, so that the card tests also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_septail_step.py

Tolerances, kernel against plain version on the same inputs: f32 within
1e-5 (the same function in f32, summed in another order and with CUDA's
expf); a bf16 carry within one bf16 ulp on [0.5, 1), 2^-8 (the kernel
computes in f32 and rounds once, the plain version rounds after every op,
as the JAX step does). The kernel's class argmax is the plain version's
but at near-ties (where its class's plain value is within the tolerance of
the plain maximum): a few hundred pixels hold one flip over 0.1%.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from iterative_inference_segm_tpu_torch.ops.refine_tail import MAX_CLASSES  # noqa: E402
from iterative_inference_segm_tpu_torch.ops.septail_step import (  # noqa: E402
    _kernel_layouts,
    kernel_plan,
    septail_step,
    septail_step_reference,
)

EPS = 0.1


def _inputs(b=2, c=5, hh=4, wh=6, dtype=torch.float32, s_layout="nhwc", seed=0):
    g = torch.Generator().manual_seed(seed)
    y_ph = torch.softmax(torch.randn((b, 2, 2, c, hh, wh), generator=g) * 2, dim=3).to(dtype)
    s = torch.randn((b, hh, wh, c), generator=g)
    if s_layout == "channel_leading":  # (B, C, Hh, Wh) memory seen through NHWC strides
        s = s.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    s = s.to(dtype)
    weights = [torch.randn(shape, generator=g) * 0.5 for shape in ((4, 4, c), (3, 3, c), (c, c), (c,))]
    return y_ph, s, [w.to(dtype) for w in weights]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_blends_two_distributions_in_the_carrys_dtype(dtype):
    y_ph, s, w = _inputs(dtype=dtype)
    got = septail_step(y_ph, s, *w, EPS)
    assert got.dtype == dtype and got.shape == y_ph.shape
    tol = 1e-5 if dtype == torch.float32 else 2.0**-5  # C bf16 roundings of values <= 1
    assert torch.allclose(got.float().sum(dim=3), torch.ones(()), atol=tol)


def test_s_layout_does_not_change_the_plain_result():
    y_ph, s, w = _inputs()
    _, s_cl, _ = _inputs(s_layout="channel_leading")
    assert not s_cl.is_contiguous() and torch.equal(s, s_cl)
    assert torch.equal(septail_step(y_ph, s, *w, EPS), septail_step(y_ph, s_cl, *w, EPS))


def test_plain_version_differentiates_on_the_cpu():
    y_ph, s, w = _inputs()
    leaves = [y_ph, s, *w]
    for t in leaves:
        t.requires_grad_(True)
    m = torch.randn(y_ph.shape, generator=torch.Generator().manual_seed(3))
    (m * septail_step(*leaves, EPS)).sum().backward()
    assert all(t.grad is not None and t.grad.abs().max() > 0 for t in leaves)


@pytest.mark.parametrize("case", ["y_rank", "y_phases", "s_shape", "s_dtype", "w_up_shape", "mix_shape",
                                  "bias_shape", "f16", "int_weight", "empty", "meta_device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    y_ph, s, w = _inputs()
    if case == "y_rank":
        y_ph = y_ph[:, 0]
    elif case == "y_phases":
        y_ph = torch.cat([y_ph, y_ph], dim=1)
    elif case == "s_shape":
        s = s[:, :-1]
    elif case == "s_dtype":  # s takes the carry's dtype: a bf16 map beside an f32 carry is refused
        s = s.to(torch.bfloat16)
    elif case == "w_up_shape":
        w[0] = w[0][:3]
    elif case == "mix_shape":
        w[2] = w[2][:, :-1]
    elif case == "bias_shape":
        w[3] = w[3][:-1]
    elif case == "f16":
        y_ph, s = y_ph.half(), s.half()
    elif case == "int_weight":
        w[1] = w[1].to(torch.int32)
    elif case == "empty":
        y_ph, s = y_ph[:, :, :, :, :0], s[:, :0]
    elif case == "meta_device":
        y_ph, s = y_ph.to("meta"), s.to("meta")
    with pytest.raises((TypeError, ValueError)):
        septail_step(y_ph, s, *w, EPS)


@pytest.mark.parametrize("layout", ["nhwc", "channel_leading", "strided", "size_one"])
def test_kernel_layouts_are_dense_with_canonical_strides(layout):
    # what the wrapper hands the kernel: y_ph contiguous, s dense NHWC or
    # dense channel-leading (kept as it is), anything else copied to NHWC; the
    # strides those layouts have, also along a dimension of size 1
    hh, wh = (1, 1) if layout == "size_one" else (4, 6)
    y_ph, s, _ = _inputs(b=2, c=5, hh=hh, wh=wh, s_layout="nhwc" if layout != "channel_leading" else layout)
    if layout == "strided":
        s = torch.empty((2, 4, 12, 5)).copy_(torch.cat([s, s], dim=2))[:, :, ::2]
    y_ph = y_ph.transpose(4, 5).contiguous().transpose(4, 5)
    y_k, y_strides, s_k, s_strides = _kernel_layouts(y_ph, s)
    assert y_k.is_contiguous() and torch.equal(y_k, y_ph)
    assert y_strides == (4 * 5 * hh * wh, 2 * 5 * hh * wh, 5 * hh * wh, hh * wh, wh, 1)
    assert torch.equal(s_k, s)
    if layout == "channel_leading":
        assert s_k.data_ptr() == s.data_ptr() and s_strides == (5 * hh * wh, wh, 1, hh * wh) == s_k.stride()
    else:
        assert s_k.is_contiguous() and s_strides == (hh * wh * 5, wh * 5, 5, 1)


def test_variant_edits_apply_once_to_the_kernel_source():
    # tools/septail_variants.py times the kernel beside variants of its source, one edit each
    from iterative_inference_segm_tpu_torch.ops import _build
    from iterative_inference_segm_tpu_torch.tools import septail_variants as sv

    srcs = sv.variant_sources()
    assert list(srcs) == list(sv.EDITS)
    assert srcs["ring"] == (_build.CSRC_DIR / "septail_step.cu").read_text()
    for name, (old, new) in ((n, e) for n, e in sv.EDITS.items() if e is not None):
        assert srcs[name] != srcs["ring"] and srcs[name].count(new) == 1, name
    if not torch.cuda.is_available():
        assert sv.main() == 1  # no card: no timing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


# (batch, classes, Hh, Wh, s's layout, dtype): C = 11 takes the exact
# tiled instance, 1, 2, 5 and 16 the 1..16 one, 17, 32, 33 and 128 the first
# form; a 1x1 half map (a 2x2 frame) puts every tap on an edge; Wh = 37 is no
# multiple of a warp. A tile is 12 x 16 half-resolution positions: Hh and Wh
# one below and one above a multiple of it, maps smaller than one tile, and
# y_ph staged by 16-byte copies (rows of whole 16-byte units: Wh a multiple
# of 8 in bf16, of 4 in f32) and a value at a time (bf16 rows of 30, 34, 74
# bytes), each with both layouts of s at batch > 1.
CARD_CASES = [
    (2, 11, 9, 12, "nhwc", "float32"), (2, 11, 9, 12, "nhwc", "bfloat16"),
    (2, 11, 9, 12, "channel_leading", "bfloat16"), (2, 11, 9, 12, "channel_leading", "float32"),
    (1, 2, 5, 37, "nhwc", "float32"), (1, 16, 5, 37, "channel_leading", "bfloat16"),
    (1, 17, 3, 8, "nhwc", "float32"), (1, 32, 3, 8, "nhwc", "bfloat16"),
    (1, 33, 3, 8, "nhwc", "float32"), (1, 33, 3, 8, "channel_leading", "bfloat16"),
    (1, 128, 2, 5, "nhwc", "float32"), (3, 11, 1, 1, "nhwc", "float32"),
    (3, 5, 1, 1, "channel_leading", "bfloat16"),
    (2, 11, 11, 15, "nhwc", "bfloat16"), (2, 11, 13, 17, "channel_leading", "bfloat16"),
    (2, 11, 23, 31, "channel_leading", "float32"), (3, 11, 25, 33, "nhwc", "float32"),
    (2, 11, 13, 24, "nhwc", "bfloat16"), (2, 11, 11, 40, "channel_leading", "bfloat16"),
    (2, 11, 25, 20, "channel_leading", "float32"), (2, 11, 23, 36, "nhwc", "float32"),
    (2, 11, 3, 8, "nhwc", "bfloat16"), (2, 11, 5, 7, "channel_leading", "float32"),
    (2, 11, 4, 37, "nhwc", "bfloat16"), (2, 2, 13, 24, "channel_leading", "bfloat16"),
    (2, 16, 11, 12, "nhwc", "float32"), (2, 1, 7, 9, "nhwc", "float32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,hh,wh,layout,dtype", CARD_CASES)
def test_kernel_matches_plain_version_on_card(cuda_device, b, c, hh, wh, layout, dtype):
    y_ph, s, w = _inputs(b, c, hh, wh, getattr(torch, dtype), layout, seed=c)
    before = septail_step.launches
    got = septail_step(y_ph.to(cuda_device), s.to(cuda_device), *(t.to(cuda_device) for t in w), EPS)
    torch.cuda.synchronize()
    assert septail_step.launches == before + 1
    assert got.is_contiguous() and got.dtype == y_ph.dtype
    want = septail_step_reference(y_ph, s, *w, EPS)
    tol = 1e-5 if dtype == "float32" else 2.0**-8
    got, want = got.cpu().float(), want.float()
    assert (got - want).abs().max() <= tol
    # the kernel's argmax is the plain version's, but at near-ties: its class is within tol of the plain max
    assert (want.gather(3, got.argmax(3, keepdim=True)) >= want.amax(3, keepdim=True) - tol).all()


@pytest.mark.cuda
def test_kernel_plan_on_card(cuda_device):
    # the bench step's instance: tiled, y_ph by 16-byte copies at Wh = 240, two
    # blocks an SM in bf16 (two stages of ~46 KB each), one in f32 (~70 KB
    # each); an unaligned bf16 row a value at a time; 33 classes the first form
    for dtype, blocks in ((torch.bfloat16, 2), (torch.float32, 1)):
        plan = kernel_plan(dtype, 11, 240)
        assert plan["form"] == "tiled" and plan["cp_async"] and plan["blocks_per_sm"] >= blocks
        assert 0 < plan["smem_bytes"] <= 227 * 1024 and plan["registers"] > 0
    assert not kernel_plan(torch.bfloat16, 11, 37)["cp_async"]
    assert kernel_plan(torch.float32, 2, 240)["form"] == "tiled"
    assert kernel_plan(torch.float32, 33, 240)["form"] == "first"


@pytest.mark.cuda
def test_more_than_128_classes_raise_on_card(cuda_device):
    y_ph, s, w = _inputs(c=MAX_CLASSES + 1)
    before = septail_step.launches
    with pytest.raises(ValueError, match="takes 1..128"):
        septail_step(y_ph.to(cuda_device), s.to(cuda_device), *(t.to(cuda_device) for t in w), EPS)
    assert septail_step.launches == before


@pytest.mark.cuda
def test_kernel_under_autograd_carries_the_plain_versions_gradient(cuda_device):
    y_ph, s, w = _inputs(c=11)
    m = torch.randn(y_ph.shape, generator=torch.Generator().manual_seed(4))
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in (y_ph, s, *w)]
        before = septail_step.launches
        (m.to(dev) * septail_step(*leaves, EPS)).sum().backward()
        assert septail_step.launches == before + (dev != "cpu")
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for g_card, g_cpu in zip(grads[str(cuda_device)], grads["cpu"]):
        assert (g_card - g_cpu).abs().max() <= 1e-4 * max(g_cpu.abs().max().item(), 1e-30)
