"""One full-resolution step of the phase-major 'fused' engine, one kernel.

``septail_step`` computes, for the phase-major carry ``y_ph`` (B, 2, 2, C,
Hh, Wh), ``y_ph[b, ph, pw, c, j, u] = y[b, 2j + ph, 2u + pw, c]``, and the
DAE core's half-resolution score map ``s`` (B, Hh, Wh, C),

    logits = mix(deconv_k4s2(s) + dw3x3(y)) + bias    (the 'sep' tail, per phase)
    r      = softmax(logits) over the classes
    y_ph'  = y_ph - eps * (y_ph - r)

the step of ``iterative_inference_segm_tpu.inference.fused.
fused_refinement_scan`` after its stem mean and core (``inference/fused.py
:98-149`` and ``:179-181`` there). The TPU ran it as one XLA fusion; no
``pl.pallas_call`` computes it. On a CUDA tensor ``septail_step`` launches the
hand-written kernel ``csrc/septail_step.cu`` (built at first use by
``ops/_build.py``) or raises; on a CPU tensor it runs
``septail_step_reference``, the plain PyTorch version, which follows the JAX
step literally: the tail in the carry's dtype with the weights and ``s``
cast to it, the logits widened to f32 for the softmax, the blend in the
carry's dtype with ``eps`` cast to it. The kernel computes in f32 and rounds
once on the store (bf16: within one bf16 ulp of the plain version). No path
falls back from the kernel to the plain version. ``septail_step.launches``
counts kernel launches.

Weights are the JAX package's layouts: ``w_up`` (4, 4, C) the UNFLIPPED
transposed-conv kernel of ``up_stem_dw``, ``w_si`` (3, 3, C) of
``score_input_dw``, ``mix`` (C, C) indexed ``[c_in, c_out]``, ``bias`` (C,)
(``inference.fused.septail_weights`` takes them from the port's params).

The plain version takes any class count; the kernel 1..128
(``refine_tail.MAX_CLASSES``), a CUDA tensor of more raises naming the
limit. ``s`` has ``y_ph``'s dtype (``fused_refinement_scan`` casts the
core's output to the carry's dtype, as the JAX step does).

The kernel's design (``csrc/septail_step.cu``'s header). Its bytes bound it
at ~0.33 ms at the bench step (bf16), and the instructions it issues come
close behind. For 1..16 classes it is tiled: a persistent block walks tiles
of 12 x 16 half-resolution positions, staging each tile's one-position halo
of ``y_ph`` (all four phase planes and classes) and of ``s`` in shared
memory with 16-byte ``cp.async`` copies (a value at a time where the rows
are not whole 16-byte units, or ``s`` is channel-leading), the next tile's
copies landing while it computes the current one; a thread computes the
four phases of one position from a 4x4 window of ``y`` and a 3x3 window of
``s``, so that every staged value and weight serves several pixels. 17..128
classes keep the first form (one thread a pixel, every tap loaded from
device memory): no dataset of the repo has more than 11 classes. The
wrapper hands the kernel a contiguous ``y_ph`` and ``s`` dense in NHWC or
channel-leading memory (any other strides through ``.contiguous()``);
``kernel_plan`` reports what a launch takes (threads, shared memory,
resident blocks, registers, copies).

Gradients: on a CUDA tensor that takes part in autograd the forward is the
kernel's launch and the backward differentiates ``septail_step_reference``
at the saved inputs in plain PyTorch, as ``refine_tail`` does.
"""

from __future__ import annotations

import ctypes

import torch

from iterative_inference_segm_tpu_torch.ops import _build
from iterative_inference_segm_tpu_torch.ops.refine_tail import check_kernel_classes, plain_version_grads

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = (
    [_I] * 5  # dtype (y_ph, s, out), B, C, Hh, Wh
    + [_P] + [_L] * 6  # y_ph, its strides
    + [_P] + [_L] * 4  # s, its strides as (B, Hh, Wh, C)
    + [_P] * 4 + [ctypes.c_float]  # w_up, w_si, mix, bias, eps
    + [_P, _P]  # out, stream
)

# k=4 s=2 transposed-conv taps per output phase, matching conv_transpose2d's
# symmetric padding (pad_lo = 2): out[2j+0] = w[0]*s[j-1] + w[2]*s[j];
# out[2j+1] = w[1]*s[j] + w[3]*s[j+1]. Entries: (kernel index, source shift).
_DECONV_TAPS = {0: ((0, -1), (2, 0)), 1: ((1, 0), (3, 1))}


def _shift2(x: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """out[..., j, u] = x[..., j+dh, u+dw], zero-filled outside (|d| <= 1)."""
    if dh:
        x = torch.nn.functional.pad(x, (0, 0, max(-dh, 0), max(dh, 0)))
        x = x[..., max(dh, 0): x.shape[-2] - max(-dh, 0), :]
    if dw:
        x = torch.nn.functional.pad(x, (max(-dw, 0), max(dw, 0)))
        x = x[..., max(dw, 0): x.shape[-1] - max(-dw, 0)]
    return x


def phase_logits(s_cl, y_ph, w_up, w_si, mix, bias) -> torch.Tensor:
    """The separable tail on phase planes, logits_ph (B, 2, 2, C, Hh, Wh),
    at ``y_ph``'s dtype (weights and ``s_cl`` cast to it, as the JAX
    package's ``septail_phase_logits``). ``s_cl``: the channel-leading
    half-resolution score map (B, C, Hh, Wh). The JAX package's C^2 slab
    multiply-adds of the 1x1 mix are one ``einsum`` over the class axis
    here (the slabs avoided TPU relayouts)."""
    dt = y_ph.dtype
    s_cl = s_cl.to(dt)
    w_up, w_si, mix, bias = (t.to(dt) for t in (w_up, w_si, mix, bias))

    def chan(w):  # (C,) -> broadcast over (B, C, Hh, Wh)
        return w[None, :, None, None]

    phases = []
    for ph in range(2):
        row = []
        for pw in range(2):
            # depthwise 4x4 deconv of s: 2x2 taps for this phase
            acc = None
            for kh, dh in _DECONV_TAPS[ph]:
                for kw, dw in _DECONV_TAPS[pw]:
                    t = _shift2(s_cl, dh, dw) * chan(w_up[kh, kw])
                    acc = t if acc is None else acc + t
            # depthwise 3x3 on the full-res iterate: 9 phase-mapped taps
            for dr in (-1, 0, 1):
                src_ph, dh = (ph + dr) % 2, (ph + dr) // 2
                for dc in (-1, 0, 1):
                    src_pw, dw = (pw + dc) % 2, (pw + dc) // 2
                    acc = acc + _shift2(y_ph[:, src_ph, src_pw], dh, dw) * chan(w_si[1 + dr, 1 + dc])
            row.append(torch.einsum("bihw,io->bohw", acc, mix) + chan(bias))
        phases.append(torch.stack(row, dim=1))
    return torch.stack(phases, dim=1)


def septail_step_reference(y_ph, s, w_up, w_si, mix, bias, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the JAX step's lines
    (``inference/fused.py:178-181`` there): ``s`` (B, Hh, Wh, C) made
    channel-leading at the carry's dtype, the tail in that dtype, the
    softmax in f32, ``y - eps * (y - r)`` in the carry's dtype."""
    dt = y_ph.dtype
    s_cl = s.permute(0, 3, 1, 2).to(dt)
    logits = phase_logits(s_cl, y_ph, w_up, w_si, mix, bias).float()
    r = torch.softmax(logits, dim=3).to(dt)
    return y_ph - torch.tensor(eps, dtype=dt) * (y_ph - r)


def _check(y_ph, s, w_up, w_si, mix, bias) -> None:
    if y_ph.dim() != 6 or tuple(y_ph.shape[1:3]) != (2, 2):
        raise ValueError(f"septail_step: y_ph must be (B, 2, 2, C, Hh, Wh); got {tuple(y_ph.shape)}")
    bsz, _, _, c, hh, wh = (int(d) for d in y_ph.shape)
    if y_ph.dtype not in _DTYPE_CODE:
        raise TypeError(f"septail_step: dtype {y_ph.dtype} not supported (float32, bfloat16)")
    if min(bsz, c, hh, wh) < 1:
        raise ValueError(f"septail_step: empty map {tuple(y_ph.shape)}")
    if tuple(s.shape) != (bsz, hh, wh, c):
        raise ValueError(f"septail_step: s {tuple(s.shape)} must be (B, Hh, Wh, C) = {(bsz, hh, wh, c)}")
    if s.dtype != y_ph.dtype:
        raise TypeError(f"septail_step: s is {s.dtype}, y_ph is {y_ph.dtype} (s takes y_ph's dtype)")
    for name, t, shape in (("w_up", w_up, (4, 4, c)), ("w_si", w_si, (3, 3, c)), ("mix", mix, (c, c)),
                           ("bias", bias, (c,))):
        if tuple(t.shape) != shape or not t.is_floating_point():
            raise ValueError(f"septail_step: {name} must be a floating {shape}; got {t.dtype} {tuple(t.shape)}")
    for name, t in (("s", s), ("w_up", w_up), ("w_si", w_si), ("mix", mix), ("bias", bias)):
        if t.device != y_ph.device:
            raise ValueError(f"septail_step: {name} on {t.device}, y_ph on {y_ph.device}")
    if 4 * bsz * hh * wh >= 2**31:
        raise ValueError("septail_step: more than 2^31 pixels")


def _dense_strides(shape) -> tuple[int, ...]:
    out, step = [], 1
    for d in reversed(shape):
        out.append(step)
        step *= int(d)
    return tuple(reversed(out))


def _kernel_layouts(y_ph, s):
    """``y_ph`` contiguous and ``s`` dense NHWC or dense channel-leading
    (anything else copied to NHWC), with the strides of those layouts
    (PyTorch's strides of a size-1 dimension are arbitrary; the kernel
    checks the canonical ones)."""
    y_ph = y_ph.contiguous()
    bsz, hh, wh, c = (int(d) for d in s.shape)
    if s.permute(0, 3, 1, 2).is_contiguous() and not s.is_contiguous():
        return y_ph, _dense_strides(y_ph.shape), s, (c * hh * wh, wh, 1, hh * wh)
    s = s.contiguous()
    return y_ph, _dense_strides(y_ph.shape), s, _dense_strides(s.shape)


def _lib():
    lib = _build.load("septail_step")
    if lib.septail_step_launch.argtypes is None:
        lib.septail_step_launch.argtypes = _ARGTYPES
        lib.septail_step_launch.restype = ctypes.c_int
        lib.septail_step_plan.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.septail_step_plan.restype = ctypes.c_int
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"septail_step: {what} failed with CUDA error {rc}")


def _launch(y_ph, s, w_up, w_si, mix, bias, eps):
    fn = _lib().septail_step_launch
    y_ph, y_strides, s, s_strides = _kernel_layouts(y_ph, s)
    bsz, _, _, c, hh, wh = (int(d) for d in y_ph.shape)
    out = torch.empty(tuple(y_ph.shape), dtype=y_ph.dtype, device=y_ph.device)
    weights = [t.detach().to(torch.float32).contiguous() for t in (w_up, w_si, mix, bias)]
    with torch.cuda.device(y_ph.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            _DTYPE_CODE[y_ph.dtype], bsz, c, hh, wh,
            y_ph.data_ptr(), *y_strides, s.data_ptr(), *s_strides,
            *(t.data_ptr() for t in weights), float(eps), out.data_ptr(), stream,
        )
    _raise_on(rc, "kernel launch")
    septail_step.launches += 1
    return out


def kernel_plan(dtype: torch.dtype, classes: int, wh: int, device=None) -> dict:
    """What a launch of the kernel takes for ``classes`` classes of
    ``dtype`` on a map ``wh`` half-resolution columns wide, launching
    nothing: its form ('tiled' for 1..16 classes, else 'first'), threads and
    dynamic shared bytes a block, resident blocks an SM, registers a thread,
    and whether ``y_ph`` (16-byte aligned) is staged by 16-byte ``cp.async``
    copies (else a value at a time)."""
    check_kernel_classes("septail_step", classes)
    plan = (_I * 6)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        _raise_on(_lib().septail_step_plan(_DTYPE_CODE[dtype], classes, wh, plan), "plan")
    return {"form": "tiled" if plan[0] else "first", "threads": plan[1], "smem_bytes": plan[2],
            "blocks_per_sm": plan[3], "registers": plan[4], "cp_async": bool(plan[5])}


class _KernelWithPlainBackward(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain version's gradient at the
    saved inputs (``refine_tail.plain_version_grads``)."""

    @staticmethod
    def forward(ctx, y_ph, s, w_up, w_si, mix, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(y_ph, s, w_up, w_si, mix, bias)
        return _launch(y_ph, s, w_up, w_si, mix, bias, eps)

    @staticmethod
    def backward(ctx, grad_out):
        return (*plain_version_grads(ctx, lambda *t: septail_step_reference(*t, ctx.eps), grad_out), None)


def septail_step(y_ph, s, w_up, w_si, mix, bias, eps: float) -> torch.Tensor:
    """One step (see module doc). ``y_ph``: (B, 2, 2, C, Hh, Wh), any
    strides, float32 or bfloat16; ``s``: (B, Hh, Wh, C), any strides, in
    y_ph's dtype; weights in the JAX layouts.
    Returns ``y_ph'`` (contiguous, y_ph's dtype)."""
    _check(y_ph, s, w_up, w_si, mix, bias)
    if y_ph.device.type == "cpu":
        return septail_step_reference(y_ph, s, w_up, w_si, mix, bias, eps)
    if y_ph.device.type != "cuda":
        raise ValueError(f"septail_step: no kernel for device {y_ph.device}")
    check_kernel_classes("septail_step", int(y_ph.shape[3]))
    args = (y_ph, s, w_up, w_si, mix, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _KernelWithPlainBackward.apply(*args, eps)
    return _launch(*args, eps)


septail_step.launches = 0
