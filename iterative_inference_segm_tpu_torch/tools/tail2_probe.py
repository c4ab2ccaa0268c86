"""The full-resolution tail in two memory formats, the softmax in three
dtype orders and the avg-pool four ways: the twin of the repo's
``tools/tail2_probe.py`` on the card.

Batch 128, C = 11, 360x480 (the half-res maps 180x240), bf16, seeded maps
and weights. The JAX probe asks whether a channel-major (NCHW) layout
avoids a lane-padding pass on the TPU; here the question is cuDNN's
channel padding (``nhwcAddPaddingKernel``) and its generic kernel at
C = 11. In PyTorch the layout is the memory format, not the shape: the
port's (B, H, W, C) map that ``ops.conv`` hands ``F.conv2d`` is a
``channels_last`` NCHW tensor, and this twin's NCHW rows run on
``.contiguous()`` channel-major memory (``y_cm``; their weights in
contiguous OIHW memory too, since cuDNN runs a conv channels-last when
either operand is). The JAX probe's rows, with its labels:

  - the two baselines (a reduction of each map);
  - softmax + blend + argmax in each layout;
  - the FCN's probability softmax: f32 then a bf16 cast (the current
    order), a bf16 cast then the softmax, and the first in NCHW;
  - the 3x3 C x C conv NHWC -> NHWC (``ops.conv.conv2d``, the current
    form), NHWC -> NCHW (cuDNN keeps a channels-last input's format, so the
    conv's output is copied to channel-major memory after it) and NCHW ->
    NCHW; each line records its conv's input and output memory format
    (``conv_in``, ``conv_out``, read from a call);
  - the NHWC -> NCHW transpose alone;
  - avg-pool by ``ops.conv.avg_pool``, by reshape and phase adds, by
    strided slices and by a 2x2 stride-2 conv with a dense eye kernel
    (OIHW);
  - the rectification's whole tail (deconv, 3x3 conv, softmax, blend,
    argmax) in NHWC, and with the convs emitting NCHW and the pointwise
    tail in NCHW (the deconv in the phase form, ``tail_ops_probe``'s copy
    of the JAX speed form).

The blend takes the JAX probe's ``jnp.bfloat16(0.1)`` (``timing.bf16``).
Each row's scalar is the JAX row's: the f32 sum of its output, or the sum
of the argmax. Timing and lines as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.tail2_probe [--iters 10]
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, bf16, probe_parser

B, C, HH, WH = 128, 11, 180, 240
EPS = 0.1
CONV_LABELS = ("conv3x3 CxC full-res NHWC->NHWC (current)", "conv3x3 CxC full-res NHWC->NCHW",
               "conv3x3 CxC full-res NCHW->NCHW")


def memory_format(t: torch.Tensor) -> str:
    """The memory format of an NCHW-shaped tensor."""
    if t.is_contiguous():
        return "contiguous"
    return "channels_last" if t.is_contiguous(memory_format=torch.channels_last) else "strided"


def _argmax_sum(t: torch.Tensor, dim: int) -> tuple:
    return (torch.argmax(t, dim),)


def conv_nhwc_to_nchw(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 3x3 SAME conv of NHWC ``y`` as a channel-major (B, C, H, W) map:
    ``F.conv2d`` of the channels-last view, then a copy to channel-major
    memory."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d

    return conv2d(y, w, b, padding="SAME").permute(0, 3, 1, 2).contiguous()


def conv_nchw(y_cm: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 3x3 SAME conv of a channel-major (B, C, H, W) map, channel-major
    out (weight in contiguous OIHW memory)."""
    return F.conv2d(y_cm, w.to(y_cm.dtype).contiguous(), b.to(y_cm.dtype), padding=1)


def conv_cases(y: torch.Tensor, y_cm: torch.Tensor, w_si: torch.Tensor, b_si: torch.Tensor):
    """``[(label, fn)]`` of the three conv rows."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d

    return list(zip(CONV_LABELS, (
        lambda: (conv2d(y, w_si, b_si, padding="SAME"),),
        lambda: (conv_nhwc_to_nchw(y, w_si, b_si),),
        lambda: (conv_nchw(y_cm, w_si, b_si),),
    )))


def conv_layouts(y: torch.Tensor, y_cm: torch.Tensor, w_si: torch.Tensor, b_si: torch.Tensor) -> dict:
    """{label: {'conv_in', 'conv_out'}} of the three conv rows: the memory
    format of the tensor ``F.conv2d`` takes and of the one it returns."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d

    x_cl = y.permute(0, 3, 1, 2)
    out_cl = conv2d(y, w_si, b_si, padding="SAME").permute(0, 3, 1, 2)
    out_cm = conv_nchw(y_cm, w_si, b_si)
    fmt = {"conv_in": memory_format(x_cl), "conv_out": memory_format(out_cl)}
    return {CONV_LABELS[0]: fmt, CONV_LABELS[1]: fmt,
            CONV_LABELS[2]: {"conv_in": memory_format(y_cm), "conv_out": memory_format(out_cm)}}


def pool_eye_kernel(c: int, dtype, device) -> torch.Tensor:
    """The JAX probe's 2x2 kernel ``0.25 * eye(C)`` (HWIO (2, 2, C, C)) in
    OIHW: (C, C, 2, 2)."""
    return (0.25 * torch.eye(c, dtype=dtype, device=device))[:, :, None, None].expand(c, c, 2, 2).contiguous()


def cases(y, y_cm, logits, logits_cm, u, u_cm, s, w_up, w_si, b_si, *, low=torch.bfloat16):
    """``[(label, fn)]``; ``y``/``y_cm`` the probability map NHWC and its
    channel-major copy, ``logits`` f32 and ``logits_cm`` its channel-major
    copy, ``u``/``u_cm`` the tail's logits in each layout, ``s`` the
    half-res map; ``low`` the dtype the probability rows cast to (bf16 as
    the JAX probe; f32 in the CPU tests)."""
    from iterative_inference_segm_tpu_torch.ops.conv import avg_pool, conv2d, conv_transpose2d
    from iterative_inference_segm_tpu_torch.tools.tail_ops_probe import deconv_phase

    eps = bf16(EPS)

    def tail_nhwc():
        yk = y - eps * (y - torch.softmax(u, -1))
        return _argmax_sum(yk, -1)

    def tail_nchw():
        yk = y_cm - eps * (y_cm - torch.softmax(u_cm, 1))
        return _argmax_sum(yk, 1)

    def pool_reshape():
        b, h, w, c = y.shape
        g = y.reshape(b, h // 2, 2, w // 2, 2, c)
        return ((g[:, :, 0, :, 0] + g[:, :, 1, :, 0] + g[:, :, 0, :, 1] + g[:, :, 1, :, 1]) * 0.25,)

    def pool_slice():
        return ((y[:, 0::2, 0::2] + y[:, 1::2, 0::2] + y[:, 0::2, 1::2] + y[:, 1::2, 1::2]) * 0.25,)

    def rect_nhwc():
        t = conv_transpose2d(s, w_up, stride=2) + conv2d(y, w_si, b_si, padding="SAME")
        yk = y - eps * (y - torch.softmax(t, -1))
        return _argmax_sum(yk, -1)

    def rect_nchw():
        # the convs take NHWC and emit channel-major maps; the pointwise tail runs channel-major
        u_ph = deconv_phase(s, w_up)
        t = conv_nhwc_to_nchw(y, w_si, b_si) + u_ph.permute(0, 3, 1, 2)
        yk = y_cm - eps * (y_cm - torch.softmax(t, 1))
        return _argmax_sum(yk, 1)

    w_eye = pool_eye_kernel(int(y.shape[-1]), y.dtype, y.device)
    return [
        ("baseline NHWC full-res", lambda: (y,)),
        ("baseline NCHW full-res", lambda: (y_cm,)),
        ("softmax+blend+argmax NHWC", tail_nhwc),
        ("softmax+blend+argmax NCHW", tail_nchw),
        ("probs: softmax f32->bf16 NHWC (current)", lambda: (torch.softmax(logits, -1).to(low),)),
        ("probs: cast bf16 then softmax NHWC", lambda: (torch.softmax(logits.to(low), -1),)),
        ("probs: softmax f32->bf16 NCHW", lambda: (torch.softmax(logits_cm, 1).to(low),)),
        *conv_cases(y, y_cm, w_si, b_si),
        ("transpose NHWC->NCHW full-res", lambda: (y.permute(0, 3, 1, 2).contiguous(),)),
        ("avg_pool reduce_window bf16 (current)", lambda: (avg_pool(y, window=2, stride=2),)),
        ("avg_pool via reshape+phase-add", pool_reshape),
        ("avg_pool via strided slices", pool_slice),
        ("avg_pool via 2x2 stride-2 conv (dense eye)", lambda: (conv2d(y, w_eye, stride=2, padding="VALID"),)),
        ("RECT: full tail NHWC (current)", rect_nhwc),
        ("RECT: convs->NCHW + pointwise NCHW", rect_nchw),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.ops.conv import bilinear_kernel, init_conv

    args = probe_parser(__doc__, iters=10, repeats=3).parse_args(argv)
    run = ProbeRun("tail2_probe", args)
    dev, dt = run.device, torch.bfloat16
    y = torch.softmax(run.normal((B, 2 * HH, 2 * WH, C), 0), -1).to(dt)
    logits = run.normal((B, 2 * HH, 2 * WH, C), 1)
    s = run.normal((B, HH, WH, C), 2, dt)
    u = run.normal((B, 2 * HH, 2 * WH, C), 4, dt)
    w_up = bilinear_kernel(4, C, C).to(dev, dt)
    w_si = init_conv(torch.Generator().manual_seed(3), 3, 3, C, C, device=dev)["w"].to(dt)
    b_si = torch.zeros((C,), dtype=dt, device=dev)
    y_cm, u_cm, logits_cm = (t.permute(0, 3, 1, 2).contiguous() for t in (y, u, logits))
    with torch.inference_mode():
        layouts = conv_layouts(y, y_cm, w_si, b_si)
        for label, fn in cases(y, y_cm, logits, logits_cm, u, u_cm, s, w_up, w_si, b_si):
            run.time(label, fn, B, rates=(lambda ms, label=label: layouts[label]) if label in layouts else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
