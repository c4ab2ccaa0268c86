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
version. ``refine_tail.launches`` counts kernel launches;
``refine_tail.strided_launches`` counts those of them in which a map was not
row-packed (class stride 1, pixel stride C) and went through the kernel's
element-by-element staging instead of its 16-byte copies. Set
``refine_tail.layouts`` to a list and each call appends the layouts of its
maps to it (``layout``), with its labels flag and whether it was given
``w`` and ``b`` (``tools/tail_bench.py`` records what the engines hand the
kernel this way); it is None otherwise.

The plain version takes any class count. The kernel takes up to
``MAX_CLASSES`` = 128, the cap of the JAX package's Pallas kernels (up to 32
a pixel's classes live in registers, above in shared memory); a CUDA tensor
of more classes raises, naming the limit.

``u`` has ``y``'s dtype, or is bfloat16 beside a float32 ``y``: the general
engine hands the kernel the DAE's bf16 logits, which it widens in registers
exactly as ``.float()`` would, instead of a cast pass over the map.

Gradients: on a CUDA tensor that takes part in autograd (grad enabled and an
input requiring grad) the forward is still the kernel's launch, and the
backward recomputes ``refine_tail_reference`` from the saved inputs and
differentiates it in plain PyTorch (the TPU kernel had no backward either:
XLA differentiated the JAX code). The labels carry no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from iterative_inference_segm_tpu_torch.ops import _build
from iterative_inference_segm_tpu_torch.ops.conv import crop_to

MAX_CLASSES = 128  # on the card; the plain version has no cap
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = (
    [_I] * 6  # dtype (y, v, out), u's dtype, B, H, W, C
    + [_P] + [_L] * 4 + [_I] * 3  # u, its strides, row-packed, crop offsets
    + [_P] + [_L] * 4 + [_I]  # v, its strides, row-packed
    + [_P] + [_L] * 4 + [_I]  # y, its strides, row-packed
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
    """Plain PyTorch version of the kernel: same function, f32 arithmetic
    (each map widened by ``.float()``), one rounding to ``y.dtype``; labels
    are the argmax of the rounded map."""
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
    if min(bsz, h, wd, c) < 1:
        raise ValueError(f"refine_tail: empty map {tuple(y.shape)}")
    if u.dim() != 4 or int(u.shape[0]) != bsz or int(u.shape[3]) != c:
        raise ValueError(f"refine_tail: u {tuple(u.shape)} does not match y {tuple(y.shape)}")
    if int(u.shape[1]) < h or int(u.shape[2]) < wd:
        raise ValueError(f"refine_tail: u {tuple(u.shape)} smaller than y {tuple(y.shape)}")
    if not (u.dtype == y.dtype or (u.dtype, y.dtype) == (torch.bfloat16, torch.float32)):
        raise TypeError(f"refine_tail: u is {u.dtype}, y is {y.dtype} (u takes y's dtype, or bf16 beside f32)")
    if v is not None and v.dtype != y.dtype:
        raise TypeError(f"refine_tail: v is {v.dtype}, y is {y.dtype}")
    maps = [("u", u)] + ([("v", v)] if v is not None else [])
    for name, t in maps:
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


def check_kernel_classes(name: str, c: int) -> None:
    """The class count a CUDA tensor may have: the kernels keep a pixel's
    classes on chip and take 1..MAX_CLASSES. No wrapper hands a CUDA tensor
    to the plain version instead."""
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"{name}: {c} classes on a CUDA tensor; the kernel takes 1..{MAX_CLASSES}")


def row_packed(t: torch.Tensor) -> bool:
    """Class stride 1 and pixel stride C (strides of size-1 axes aside): a
    run of pixels of one row is one contiguous span of memory."""
    _, _, wd, c = t.shape
    return (c == 1 or t.stride(3) == 1) and (wd == 1 or t.stride(2) == c)


def layout(t: torch.Tensor | None) -> dict | None:
    """A map's shape, strides, dtype and row-packing (None for an absent
    map)."""
    if t is None:
        return None
    return {"shape": tuple(t.shape), "stride": tuple(t.stride()), "dtype": str(t.dtype).removeprefix("torch."),
            "row_packed": row_packed(t)}


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
    pu, py = row_packed(u), row_packed(y)
    pv = v is None or row_packed(v)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODE[y.dtype], _DTYPE_CODE[u.dtype], bsz, h, wd, c,
            u.data_ptr(), *u.stride(), pu, oh, ow,
            None if v is None else v.data_ptr(), *(v.stride() if v is not None else (0,) * 4), pv,
            y.data_ptr(), *y.stride(), py,
            None if w is None else w.data_ptr(), None if b is None else b.data_ptr(),
            float(eps), float(1.0 - eps),
            out.data_ptr(), None if labels is None else labels.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"refine_tail: kernel launch failed with CUDA error {rc}")
    refine_tail.launches += 1
    if not (pu and pv and py):
        refine_tail.strided_launches += 1
    return (out, labels) if with_labels else out


def plain_version_grads(ctx, plain, grad_out) -> list:
    """The backward of a kernel whose forward has no backward kernel: the
    gradient of ``plain(*ctx.saved_tensors)`` (the kernel's plain version)
    for the saved inputs that need one (None for the others and for absent
    inputs). A recorded backward (``create_graph``) differentiates through
    the saved inputs' own graphs."""
    saved = ctx.saved_tensors
    wanted = [i for i, t in enumerate(saved) if t is not None and ctx.needs_input_grad[i]]
    grads = [None] * len(saved)
    if not wanted or grad_out is None:
        return grads
    higher = torch.is_grad_enabled()  # the backward itself is being recorded
    with torch.enable_grad():
        inputs = list(saved) if higher else [
            t.detach().requires_grad_(i in wanted) if t is not None else None for i, t in enumerate(saved)]
        got = torch.autograd.grad(plain(*inputs), [inputs[i] for i in wanted], grad_out, allow_unused=True,
                                  create_graph=higher)
    for i, g in zip(wanted, got):
        grads[i] = g
    return grads


class _KernelWithPlainBackward(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain version's gradient at the
    saved inputs (``plain_version_grads``)."""

    @staticmethod
    def forward(ctx, u, y, v, w, b, eps, with_labels):
        ctx.eps = eps
        ctx.save_for_backward(u, y, v, w, b)
        out = _launch(u, y, eps, v, w, b, with_labels)
        if with_labels:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, grad_out, *_labels_grad):
        grads = plain_version_grads(
            ctx, lambda u, y, v, w, b: refine_tail_reference(u, y, ctx.eps, v=v, w=w, b=b), grad_out)
        return (*grads, None, None)


def _tracks_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


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
    cropped to y's (H, W); ``y``, ``v``: (B, H, W, C), any strides, float32
    or bfloat16, ``v`` in y's dtype, ``u`` in y's dtype or bfloat16 beside a
    float32 ``y``; ``w``: (C, C) and ``b``: (C,), contiguous float32.
    Returns ``y'`` (contiguous, y.dtype) or ``(y', labels)``."""
    _check(u, y, v, w, b)
    if refine_tail.layouts is not None:
        refine_tail.layouts.append({"u": layout(u), "v": layout(v), "y": layout(y), "labels": with_labels,
                                    "w": w is not None, "b": b is not None})
    if y.device.type == "cpu":
        return refine_tail_reference(u, y, eps, v=v, w=w, b=b, with_labels=with_labels)
    if y.device.type != "cuda":
        raise ValueError(f"refine_tail: no kernel for device {y.device}")
    check_kernel_classes("refine_tail", int(y.shape[3]))
    if _tracks_grad(u, y, v, w, b):
        return _KernelWithPlainBackward.apply(u, y, v, w, b, eps, with_labels)
    return _launch(u, y, eps, v, w, b, with_labels)


refine_tail.launches = 0
refine_tail.strided_launches = 0
refine_tail.layouts = None
