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


def _axis_pads(padding, axis: int, size: int, k: int, s: int, d: int) -> tuple[int, int]:
    """The (low, high) padding of spatial axis ``axis`` (0: H, 1: W)."""
    if padding == "SAME":
        return _same_pads(size, k, s, d)
    if padding == "VALID":
        return 0, 0
    return int(padding[axis][0]), int(padding[axis][1])


def _conv_rows(x, w, b, stride, padding, dilation, groups, space):
    """``F.conv2d`` of NHWC ``x`` with XLA's padding; under ``space`` (the
    layout of an H-sharded ``x``, ``parallel.spatial``) on this rank's band
    of output rows, its input rows fetched, the H padding read as the zero
    rows past the map's edges (it follows the global height, not the
    band's)."""
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    kh, kw = int(w.shape[2]), int(w.shape[3])
    height = int(x.shape[1]) if space is None else space.height
    ph_lo, ph_hi = _axis_pads(padding, 0, height, kh, sh, dh)
    pw_lo, pw_hi = _axis_pads(padding, 1, int(x.shape[2]), kw, sw, dw)
    _exact_f32(x.dtype)
    bias = None if b is None else b.to(x.dtype)
    wt = _weight(w, x.dtype)

    def conv(xh, h_pads):
        xc = _nchw(xh)
        if h_pads[0] == h_pads[1] and pw_lo == pw_hi:
            pad = (h_pads[0], pw_lo)
        else:
            xc = F.pad(xc, (pw_lo, pw_hi, *h_pads))
            pad = (0, 0)
        return _nhwc(F.conv2d(xc, wt, bias, (sh, sw), pad, (dh, dw), groups))

    if space is None:
        return conv(x, (ph_lo, ph_hi))
    from iterative_inference_segm_tpu_torch.parallel.spatial import rowwise

    reach = (kh - 1) * dh + 1
    out_h = (height + ph_lo + ph_hi - reach) // sh + 1
    return rowwise(
        x, space, out_h,
        lambda lo, hi: (lo * sh - ph_lo, (hi - 1) * sh - ph_lo + reach),
        lambda block, a, lo, hi: conv(block, (0, 0)),
    )


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int | tuple[int, int] = 1,
    padding: str | Sequence[tuple[int, int]] = "SAME",
    dilation: int | tuple[int, int] = 1,
    space=None,
) -> torch.Tensor:
    """2-D cross-correlation, NHWC x OIHW -> NHWC at ``x.dtype``. ``space``:
    the layout of an H-sharded ``x`` (``parallel.spatial.Rows``); the
    result is this rank's band of the output."""
    return _conv_rows(x, w, b, stride, padding, dilation, 1, space)


def _conv_transpose_rows(x, w, b, stride, groups, space, name):
    """The transposed conv of ``conv_transpose2d`` (output ``stride x``
    the input), under ``space`` on this rank's band of output rows."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    pads = []
    for k in (kh, kw):
        lo = -(-(k + stride - 2) // 2)
        if k - 1 - lo < 0:
            raise ValueError(f"{name}: kernel {k} smaller than stride {stride}")
        pads.append(k - 1 - lo)
    _exact_f32(x.dtype)
    bias = None if b is None else b.to(x.dtype)
    wt = _weight(w, x.dtype)
    wd = int(x.shape[2]) * stride
    if space is None:
        out = F.conv_transpose2d(_nchw(x), wt, bias, stride, tuple(pads), groups=groups)
        return _nhwc(out[:, :, : int(x.shape[1]) * stride, :wd])
    from iterative_inference_segm_tpu_torch.parallel.spatial import rowwise

    p = pads[0]

    def compute(block, a, lo, hi):
        # unpadded in H: local row r is global row stride * a + r - p
        out = F.conv_transpose2d(_nchw(block), wt, bias, stride, (0, pads[1]), groups=groups)
        top = lo - stride * a + p
        return _nhwc(out[:, :, top: top + hi - lo, :wd])

    return rowwise(
        x, space, space.height * stride,
        lambda lo, hi: (-(-(lo + p - kh + 1) // stride), (hi - 1 + p) // stride + 1),
        compute,
    )


def conv_transpose2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 2,
    space=None,
) -> torch.Tensor:
    """Transposed convolution with output exactly ``stride * input``.

    Semantics of the JAX package's input-dilated form: total padding
    ``k + s - 2`` split with the odd pixel low, i.e. ``pad_lo = ceil``. In
    ``F.conv_transpose2d`` terms the dilated input is padded by ``k - 1 - p``
    on both sides, so ``p = k - 1 - pad_lo`` (1 for k4/s2, 4 for k16/s8);
    when the JAX split is uneven the one extra row/column is at the end and
    is cropped. ``w`` is (I, O, kh, kw), already flipped (see module doc).
    ``space`` as in ``conv2d``.
    """
    return _conv_transpose_rows(x, w, b, stride, 1, space, "conv_transpose2d")


def _depthwise_weight(w: torch.Tensor, c: int) -> None:
    if w.dim() != 4 or tuple(w.shape[:2]) != (c, 1):
        raise ValueError(f"depthwise weight (C, 1, kh, kw) expected, got {tuple(w.shape)} for C={c}")


def conv2d_depthwise(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    padding: str | Sequence[tuple[int, int]] = "SAME",
    space=None,
) -> torch.Tensor:
    """Depthwise 2-D cross-correlation, NHWC x (C, 1, kh, kw) -> NHWC at
    ``x.dtype`` (``groups=C``; the JAX kernel is (kh, kw, C)). ``space`` as
    in ``conv2d``."""
    c = int(x.shape[-1])
    _depthwise_weight(w, c)
    return _conv_rows(x, w, b, 1, padding, 1, c, space)


def conv_transpose2d_depthwise(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 2,
    space=None,
) -> torch.Tensor:
    """Depthwise transposed conv, output ``stride * input``: the padding
    convention of ``conv_transpose2d`` (``k + s - 2`` split with the odd
    pixel low) with one filter per channel. ``w`` is (C, 1, kh, kw), already
    spatially flipped like every transposed-conv weight of the port.
    ``space`` as in ``conv2d``."""
    c = int(x.shape[-1])
    _depthwise_weight(w, c)
    return _conv_transpose_rows(x, w, b, stride, c, space, "conv_transpose2d_depthwise")


def _pooled_height(h: int, window: int, stride: int, ceil_mode: bool) -> int:
    """``F.max_pool2d``'s output size: a ceil-mode window must start
    inside the map."""
    if not ceil_mode:
        return (h - window) // stride + 1
    out = -(-(h - window) // stride) + 1
    return out - 1 if (out - 1) * stride >= h else out


def max_pool(
    x: torch.Tensor, *, window: int = 2, stride: int = 2, ceil_mode: bool = True, space=None
) -> torch.Tensor:
    """Max pooling over H, W; ``ceil_mode=True`` counts partial windows
    (360 -> 180 -> 90 -> 45 -> 23 -> 12), as the JAX package's -inf pad.
    ``space`` as in ``conv2d``: a window cut by a band's edge takes its
    partner rows from the neighbour, one cut by the map's edge reads -inf."""
    if space is None:
        return _nhwc(F.max_pool2d(_nchw(x), window, stride, ceil_mode=ceil_mode))
    from iterative_inference_segm_tpu_torch.parallel.spatial import rowwise

    return rowwise(
        x, space, _pooled_height(space.height, window, stride, ceil_mode),
        lambda lo, hi: (lo * stride, (hi - 1) * stride + window),
        lambda block, a, lo, hi: _nhwc(F.max_pool2d(_nchw(block), window, stride, ceil_mode=ceil_mode)),
        fill=float("-inf"),
    )


def upsample_pool_indices(x: torch.Tensor, *, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour unpooling: each pixel repeated ``factor`` times
    along H and W."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def _unpool(g, pre, window, stride):
    _, idx = F.max_pool2d(_nchw(pre), window, stride, ceil_mode=True, return_indices=True)
    # indices count within each (H, W) plane whatever the memory format
    out = F.max_unpool2d(_nchw(g.to(pre.dtype)).contiguous(), idx.contiguous(), window, stride,
                         output_size=tuple(pre.shape[1:3]))
    return _nhwc(out).contiguous().to(g.dtype)


def max_unpool(g: torch.Tensor, pre: torch.Tensor, *, window: int = 2, stride: int = 2,
               space=None) -> torch.Tensor:
    """Switch-based max-unpooling: ``g`` (the pooled shape) scattered to the
    position of each window's maximum in ``pre``, zeros elsewhere; the
    adjoint of the ceil-mode ``max_pool`` at ``pre``, as the JAX package's
    (its VJP, XLA's ``select_and_scatter``).

    The switches are those of ``max_pool(pre)``: a window's first maximum in
    row-major order, as XLA keeps the first (all-zero windows after a ReLU
    and bf16 ties are common); a ceil-mode window cut by the border looks at
    its valid pixels only. ``pre`` enters as a constant (detached), and the
    output is linear in ``g``, at ``g``'s dtype. ``space``: the layout of
    an H-sharded ``pre`` (``g`` is laid out as its pooled map); the result
    is this rank's band of ``pre``'s rows (``window == stride`` only)."""
    pre = pre.detach()
    if space is None:
        return _unpool(g, pre, window, stride)
    if window != stride:
        raise ValueError(f"max_unpool on an H-sharded map takes window == stride; got {window}, {stride}")
    from iterative_inference_segm_tpu_torch.parallel.spatial import fetch_rows, rowwise

    g_space = space.at(_pooled_height(space.height, window, stride, True))
    out = space.at(space.height)
    want = [None if hi == lo else (lo // stride * stride, -(-hi // stride) * stride) for lo, hi in out.bounds]
    # the rows of whole windows, -inf past the map's edge (never a maximum)
    pre_block = fetch_rows(pre, space, want, float("-inf"))

    def compute(block, a, lo, hi):
        p = pre_block if pre_block.shape[1] else torch.full(
            (block.shape[0], block.shape[1] * stride, *pre.shape[2:]), float("-inf"), dtype=pre.dtype,
            device=pre.device)
        return _unpool(block, p, window, stride)[:, lo - a * stride: hi - a * stride]

    return rowwise(g, g_space, space.height, lambda lo, hi: (lo // stride, -(-hi // stride)), compute)


def avg_pool(x: torch.Tensor, *, window: int = 2, stride: int = 2, space=None, edge: bool = False) -> torch.Tensor:
    """Average pooling (VALID). ``space`` as in ``conv2d``; with ``edge``
    (H-sharded only) an odd last window reads the map's last row twice,
    as an edge pad to an even height would."""
    if space is None:
        return _nhwc(F.avg_pool2d(_nchw(x), window, stride))
    from iterative_inference_segm_tpu_torch.parallel.spatial import rowwise

    height = space.height + (space.height % 2 if edge else 0)
    return rowwise(
        x, space, (height - window) // stride + 1,
        lambda lo, hi: (lo * stride, (hi - 1) * stride + window),
        lambda block, a, lo, hi: _nhwc(F.avg_pool2d(_nchw(block), window, stride)),
        fill="edge",
    )


def crop_to(x: torch.Tensor, target_h: int, target_w: int, *, space=None) -> torch.Tensor:
    """Center-crop NHWC ``x`` to (target_h, target_w); offsets
    ``(size - target) // 2`` (Caffe-style crop). Returns a view. ``space``:
    the layout of an H-sharded ``x``; the crop is the global one, and the
    result this rank's band of the cropped map (its rows fetched where
    the crop moves the bands' edges)."""
    _, h, w, _ = x.shape
    if space is not None:
        h = space.height
    if h < target_h or w < target_w:
        raise ValueError(f"crop_to: input {(h, w)} smaller than target {(target_h, target_w)}")
    oh = (h - target_h) // 2
    ow = (w - target_w) // 2
    if space is None:
        return x[:, oh : oh + target_h, ow : ow + target_w, :]
    x = x[:, :, ow : ow + target_w, :]
    if target_h == h:
        return x
    from iterative_inference_segm_tpu_torch.parallel.spatial import rowwise

    return rowwise(x, space, target_h, lambda lo, hi: (oh + lo, oh + hi), lambda block, a, lo, hi: block)


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
