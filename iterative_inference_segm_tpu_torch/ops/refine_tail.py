"""The refinement tail: crop + add + softmax + blend (+ argmax), one kernel.

``refine_tail`` computes, row-wise over the pixels of NHWC maps,

    logits = crop_to(u, H, W) + v + y @ W + b     (v, W, b optional)
    r      = softmax(logits, -1)
    y'     = (1 - eps) * y + eps * r              (rounded once to y.dtype)
    labels = argmax(y', -1)                       (optional, int32)

It is the port of the TPU prototype kernels
``tools/tail_kernel_proto.py::kernel_unroll`` / ``kernel_dot`` (which have no
``v`` and no crop). On a CUDA tensor it launches the hand-written kernel
``csrc/refine_tail.cu`` (built at first use by ``ops/_build.py``) or raises;
on a CPU tensor it runs ``refine_tail_reference``, the plain PyTorch version
of the same function. No path falls back from the kernel to the plain
version. ``refine_tail.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from iterative_inference_segm_tpu_torch.ops import _build
from iterative_inference_segm_tpu_torch.ops.conv import crop_to

MAX_CLASSES = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = (
    [_I] * 5  # dtype, B, H, W, C
    + [_P] + [_L] * 4 + [_I] * 2  # u, its strides, crop offsets
    + [_P] + [_L] * 4  # v
    + [_P] + [_L] * 4  # y
    + [_P, _P, _F, _F, _P, _P, _P]  # W, b, eps, 1-eps, out, labels, stream
)


def refine_tail_reference(
    u: torch.Tensor,
    y: torch.Tensor,
    eps: float,
    *,
    v: torch.Tensor | None = None,
    w: torch.Tensor | None = None,
    b: torch.Tensor | None = None,
    with_labels: bool = False,
):
    """Plain PyTorch version of the kernel: same function, f32 arithmetic,
    one rounding to ``y.dtype``; labels are the argmax of the rounded map."""
    h, wd = int(y.shape[1]), int(y.shape[2])
    y32 = y.float()
    logits = crop_to(u, h, wd).float()
    if v is not None:
        logits = logits + v.float()
    if w is not None:
        logits = logits + y32 @ w
    if b is not None:
        logits = logits + b
    r = torch.softmax(logits, dim=-1)
    out = ((1.0 - eps) * y32 + eps * r).to(y.dtype)
    if with_labels:
        return out, torch.argmax(out, dim=-1).to(torch.int32)
    return out


def _check(u, y, v, w, b) -> None:
    if y.dim() != 4:
        raise ValueError(f"refine_tail: y must be (B, H, W, C); got {tuple(y.shape)}")
    bsz, h, wd, c = (int(s) for s in y.shape)
    if y.dtype not in _DTYPE_CODE:
        raise TypeError(f"refine_tail: dtype {y.dtype} not supported (float32, bfloat16)")
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"refine_tail: {c} classes; the kernel takes 1..{MAX_CLASSES}")
    if min(bsz, h, wd) < 1:
        raise ValueError(f"refine_tail: empty map {tuple(y.shape)}")
    if u.dim() != 4 or int(u.shape[0]) != bsz or int(u.shape[3]) != c:
        raise ValueError(f"refine_tail: u {tuple(u.shape)} does not match y {tuple(y.shape)}")
    if int(u.shape[1]) < h or int(u.shape[2]) < wd:
        raise ValueError(f"refine_tail: u {tuple(u.shape)} smaller than y {tuple(y.shape)}")
    maps = [("u", u)] + ([("v", v)] if v is not None else [])
    for name, t in maps:
        if t.dtype != y.dtype:
            raise TypeError(f"refine_tail: {name} is {t.dtype}, y is {y.dtype}")
        if t.device != y.device:
            raise ValueError(f"refine_tail: {name} on {t.device}, y on {y.device}")
    if v is not None and v.shape != y.shape:
        raise ValueError(f"refine_tail: v {tuple(v.shape)} must match y {tuple(y.shape)}")
    for name, t, shape in (("w", w, (c, c)), ("b", b, (c,))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"refine_tail: {name} must be a contiguous float32 {shape}; "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != y.device:
            raise ValueError(f"refine_tail: {name} on {t.device}, y on {y.device}")
    if h * wd * bsz >= 2**31:
        raise ValueError("refine_tail: more than 2^31 pixels")


def _launch(u, y, eps, v, w, b, with_labels):
    lib = _build.load("refine_tail")
    fn = lib.refine_tail_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    bsz, h, wd, c = (int(s) for s in y.shape)
    out = torch.empty((bsz, h, wd, c), dtype=y.dtype, device=y.device)
    labels = (
        torch.empty((bsz, h, wd), dtype=torch.int32, device=y.device) if with_labels else None
    )
    oh, ow = (int(u.shape[1]) - h) // 2, (int(u.shape[2]) - wd) // 2
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODE[y.dtype], bsz, h, wd, c,
            u.data_ptr(), *u.stride(), oh, ow,
            None if v is None else v.data_ptr(), *(v.stride() if v is not None else (0,) * 4),
            y.data_ptr(), *y.stride(),
            None if w is None else w.data_ptr(), None if b is None else b.data_ptr(),
            float(eps), float(1.0 - eps),
            out.data_ptr(), None if labels is None else labels.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"refine_tail: kernel launch failed with CUDA error {rc}")
    refine_tail.launches += 1
    return (out, labels) if with_labels else out


def refine_tail(
    u: torch.Tensor,
    y: torch.Tensor,
    eps: float,
    *,
    v: torch.Tensor | None = None,
    w: torch.Tensor | None = None,
    b: torch.Tensor | None = None,
    with_labels: bool = False,
):
    """Fused tail (see module doc). ``u``: (B, Hu, Wu, C), any strides, centre-
    cropped to y's (H, W); ``y``, ``v``: (B, H, W, C), any strides, same dtype
    as ``u`` (float32 or bfloat16); ``w``: (C, C) and ``b``: (C,), contiguous
    float32. Returns ``y'`` (contiguous, y.dtype) or ``(y', labels)``."""
    _check(u, y, v, w, b)
    if y.device.type == "cpu":
        return refine_tail_reference(u, y, eps, v=v, w=w, b=b, with_labels=with_labels)
    if y.device.type != "cuda":
        raise ValueError(f"refine_tail: no kernel for device {y.device}")
    return _launch(u, y, eps, v, w, b, with_labels)


refine_tail.launches = 0
