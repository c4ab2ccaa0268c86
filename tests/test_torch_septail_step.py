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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


# (batch, classes, Hh, Wh, s's layout, dtype): C = 11 takes the exact
# instance, 2 and 16 the 16-class one, 17, 32, 33 and 128 the wide one; a
# 1x1 half map (a 2x2 frame) puts every tap on an edge; Wh = 37 is no
# multiple of a warp.
CARD_CASES = [
    (2, 11, 9, 12, "nhwc", "float32"), (2, 11, 9, 12, "nhwc", "bfloat16"),
    (2, 11, 9, 12, "channel_leading", "bfloat16"), (2, 11, 9, 12, "channel_leading", "float32"),
    (1, 2, 5, 37, "nhwc", "float32"), (1, 16, 5, 37, "channel_leading", "bfloat16"),
    (1, 17, 3, 8, "nhwc", "float32"), (1, 32, 3, 8, "nhwc", "bfloat16"),
    (1, 33, 3, 8, "nhwc", "float32"), (1, 33, 3, 8, "channel_leading", "bfloat16"),
    (1, 128, 2, 5, "nhwc", "float32"), (3, 11, 1, 1, "nhwc", "float32"),
    (3, 5, 1, 1, "channel_leading", "bfloat16"),
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
