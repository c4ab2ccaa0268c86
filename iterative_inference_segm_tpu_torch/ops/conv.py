"""Convolution / pooling / upsampling primitives, NHWC at the interface.

Port of ``iterative_inference_segm_tpu.ops.conv``. Every public function
takes and returns NHWC tensors like the JAX package; inside, an NHWC tensor
is viewed as a ``channels_last`` NCHW tensor (a permute, no copy), which is
the layout cuDNN runs fastest. Weights are in PyTorch's layouts:

* ``conv2d``: OIHW (the JAX package stores HWIO);
* ``conv_transpose2d``: (I, O, kh, kw), spatially FLIPPED relative to the JAX
  kernel — the JAX op is an input-dilated convolution that correlates with
  the unflipped kernel, ``F.conv_transpose2d`` correlates with the flipped
  one. ``utils/jax_bridge.py`` does the conversion.

Only the semantics of the JAX ops are ported. Their TPU speed forms (the
phase-major transposed conv, the identity-kernel avg-pool) are not: cuDNN
runs the plain ops.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last memory when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _exact_f32(dtype: torch.dtype) -> None:
    """f32 convolutions must run in full f32: cuDNN defaults to TF32 for f32
    convs (about three decimal digits), the same trap the JAX package's
    ``_precision_for`` guards against on the TPU. bf16 is unaffected."""
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # cast at use like the JAX wrappers (one rounding); channels_last so
    # cuDNN need not re-lay the filter out for a channels_last input
    return w.to(dtype=dtype, memory_format=torch.channels_last)


def _same_pads(size: int, k: int, s: int, d: int) -> tuple[int, int]:
    """XLA's 'SAME' split: the odd pixel goes to the high side, so a stride-2
    3x3 conv on an even input pads (0, 1), not (1, 1)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int | tuple[int, int] = 1,
    padding: str | Sequence[tuple[int, int]] = "SAME",
    dilation: int | tuple[int, int] = 1,
) -> torch.Tensor:
    """2-D cross-correlation, NHWC x OIHW -> NHWC at ``x.dtype``."""
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    kh, kw = int(w.shape[2]), int(w.shape[3])
    if padding == "SAME":
        pads = (_same_pads(x.shape[1], kh, sh, dh), _same_pads(x.shape[2], kw, sw, dw))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    else:
        pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = pads
    xc = _nchw(x)
    if ph_lo == ph_hi and pw_lo == pw_hi:
        pad = (ph_lo, pw_lo)
    else:
        xc = F.pad(xc, (pw_lo, pw_hi, ph_lo, ph_hi))
        pad = (0, 0)
    _exact_f32(x.dtype)
    bias = None if b is None else b.to(x.dtype)
    out = F.conv2d(xc, _weight(w, x.dtype), bias, (sh, sw), pad, (dh, dw))
    return _nhwc(out)


def conv_transpose2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 2,
) -> torch.Tensor:
    """Transposed convolution with output exactly ``stride * input``.

    Semantics of the JAX package's input-dilated form: total padding
    ``k + s - 2`` split with the odd pixel low, i.e. ``pad_lo = ceil``. In
    ``F.conv_transpose2d`` terms the dilated input is padded by ``k - 1 - p``
    on both sides, so ``p = k - 1 - pad_lo`` (1 for k4/s2, 4 for k16/s8);
    when the JAX split is uneven the one extra row/column is at the end and
    is cropped. ``w`` is (I, O, kh, kw), already flipped (see module doc).
    """
    kh, kw = int(w.shape[2]), int(w.shape[3])
    pads = []
    for k in (kh, kw):
        lo = -(-(k + stride - 2) // 2)
        if k - 1 - lo < 0:
            raise ValueError(f"conv_transpose2d: kernel {k} smaller than stride {stride}")
        pads.append(k - 1 - lo)
    _exact_f32(x.dtype)
    bias = None if b is None else b.to(x.dtype)
    out = F.conv_transpose2d(_nchw(x), _weight(w, x.dtype), bias, stride, tuple(pads))
    h, wd = int(x.shape[1]) * stride, int(x.shape[2]) * stride
    return _nhwc(out[:, :, :h, :wd])


def _depthwise_weight(w: torch.Tensor, c: int) -> None:
    if w.dim() != 4 or tuple(w.shape[:2]) != (c, 1):
        raise ValueError(f"depthwise weight (C, 1, kh, kw) expected, got {tuple(w.shape)} for C={c}")


def conv2d_depthwise(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    padding: str | Sequence[tuple[int, int]] = "SAME",
) -> torch.Tensor:
    """Depthwise 2-D cross-correlation, NHWC x (C, 1, kh, kw) -> NHWC at
    ``x.dtype`` (``groups=C``; the JAX kernel is (kh, kw, C))."""
    c = int(x.shape[-1])
    _depthwise_weight(w, c)
    kh, kw = int(w.shape[2]), int(w.shape[3])
    if padding == "SAME":
        pads = (_same_pads(x.shape[1], kh, 1, 1), _same_pads(x.shape[2], kw, 1, 1))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    else:
        pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = pads
    _exact_f32(x.dtype)
    xc = F.pad(_nchw(x), (pw_lo, pw_hi, ph_lo, ph_hi))
    bias = None if b is None else b.to(x.dtype)
    return _nhwc(F.conv2d(xc, _weight(w, x.dtype), bias, groups=c))


def conv_transpose2d_depthwise(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 2,
) -> torch.Tensor:
    """Depthwise transposed conv, output ``stride * input``: the padding
    convention of ``conv_transpose2d`` (``k + s - 2`` split with the odd
    pixel low) with one filter per channel. ``w`` is (C, 1, kh, kw), already
    spatially flipped like every transposed-conv weight of the port."""
    c = int(x.shape[-1])
    _depthwise_weight(w, c)
    kh, kw = int(w.shape[2]), int(w.shape[3])
    pads = []
    for k in (kh, kw):
        lo = -(-(k + stride - 2) // 2)
        if k - 1 - lo < 0:
            raise ValueError(f"conv_transpose2d_depthwise: kernel {k} smaller than stride {stride}")
        pads.append(k - 1 - lo)
    _exact_f32(x.dtype)
    bias = None if b is None else b.to(x.dtype)
    out = F.conv_transpose2d(_nchw(x), _weight(w, x.dtype), bias, stride, tuple(pads), groups=c)
    h, wd = int(x.shape[1]) * stride, int(x.shape[2]) * stride
    return _nhwc(out[:, :, :h, :wd])


def max_pool(
    x: torch.Tensor, *, window: int = 2, stride: int = 2, ceil_mode: bool = True
) -> torch.Tensor:
    """Max pooling over H, W; ``ceil_mode=True`` counts partial windows
    (360 -> 180 -> 90 -> 45 -> 23 -> 12), as the JAX package's -inf pad."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride, ceil_mode=ceil_mode))


def avg_pool(x: torch.Tensor, *, window: int = 2, stride: int = 2) -> torch.Tensor:
    """Average pooling (VALID)."""
    return _nhwc(F.avg_pool2d(_nchw(x), window, stride))


def crop_to(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Center-crop NHWC ``x`` to (target_h, target_w); offsets
    ``(size - target) // 2`` (Caffe-style crop). Returns a view."""
    _, h, w, _ = x.shape
    if h < target_h or w < target_w:
        raise ValueError(f"crop_to: input {(h, w)} smaller than target {(target_h, target_w)}")
    oh = (h - target_h) // 2
    ow = (w - target_w) // 2
    return x[:, oh : oh + target_h, ow : ow + target_w, :]


# ---------------------------------------------------------------------------
# Initializers (random ones draw from a CPU ``torch.Generator``, so a seed
# gives the same weights whatever the device)
# ---------------------------------------------------------------------------


def bilinear_kernel(k: int, cin: int, cout: int, dtype=torch.float32) -> torch.Tensor:
    """Bilinear interpolation kernel in transposed-conv layout (cin, cout, k, k):
    channel i feeds only channel i with a separable triangle filter. The
    filter is symmetric, so the layout flip leaves it unchanged."""
    factor = (k + 1) // 2
    center = factor - 1.0 if k % 2 == 1 else factor - 0.5
    og = torch.arange(k, dtype=torch.float64)
    tri = 1.0 - (og - center).abs() / factor
    filt = (tri[:, None] * tri[None, :]).to(torch.float32)
    w = torch.zeros((cin, cout, k, k), dtype=torch.float32)
    for i in range(min(cin, cout)):
        w[i, i] = filt
    return w.to(dtype)


def init_conv(
    generator: torch.Generator,
    kh: int,
    kw: int,
    cin: int,
    cout: int,
    *,
    dtype=torch.float32,
    scale: str = "glorot",
    device: torch.device | str = "cpu",
) -> dict:
    """He/Glorot-initialized conv params {'w': (cout, cin, kh, kw), 'b': (cout,)}."""
    fan_in = kh * kw * cin
    fan_out = kh * kw * cout
    if scale == "glorot":
        std = math.sqrt(2.0 / (fan_in + fan_out))
    elif scale == "he":
        std = math.sqrt(2.0 / fan_in)
    else:
        raise ValueError(scale)
    w = torch.randn((cout, cin, kh, kw), generator=generator, dtype=torch.float32) * std
    return {
        "w": w.to(device=device, dtype=dtype),
        "b": torch.zeros((cout,), dtype=dtype, device=device),
    }


def init_conv_transpose_bilinear(
    k: int, cin: int, cout: int, *, dtype=torch.float32, device: torch.device | str = "cpu"
) -> dict:
    """Transposed-conv params initialized to bilinear upsampling (no bias)."""
    return {"w": bilinear_kernel(k, cin, cout, dtype=dtype).to(device)}


def bilinear_kernel_depthwise(k: int, c: int, dtype=torch.float32) -> torch.Tensor:
    """Per-channel bilinear triangle filter, (C, 1, k, k) (symmetric, so the
    transposed-conv flip leaves it unchanged)."""
    return bilinear_kernel(k, 1, 1, dtype=dtype).expand(c, 1, k, k).clone()


def delta_kernel_depthwise(k: int, c: int, dtype=torch.float32) -> torch.Tensor:
    """Per-channel identity (centre delta) filter, (C, 1, k, k); odd k."""
    w = torch.zeros((c, 1, k, k), dtype=dtype)
    w[:, :, k // 2, k // 2] = 1.0
    return w
