"""Each op of the NHWC refinement tail alone, at full resolution: the twin of
the repo's ``tools/tail_ops_probe.py`` on the card.

Batch 128, C = 11, 360x480 (the half-res maps 180x240), bf16, seeded maps
and weights. The JAX probe's rows with its labels: the two baselines (here
the reduction alone: the twin perturbs nothing, so a row less its baseline
is its op's cost), the k4/s2 transposed conv in the JAX package's two
formulations, the phase-major one's 3x3 conv alone, the 3x3 score conv, the
softmaxes, the update, the avg-pool, the depthwise 3x3, and the phase-channel
layout's candidates (a 44 -> 44 3x3 conv at half resolution, the grouped
softmax, the phase pool, the NHWC -> phase-channel copy).

The two transposed-conv formulations are the JAX package's TPU speed forms
(``iterative_inference_segm_tpu/ops/conv.py`` ``conv_transpose2d_phase``
and ``_conv_transpose2d_dilated``), whose semantics alone the port's
``ops.conv.conv_transpose2d`` carries: this tool keeps its own copy of both
(``deconv_phase``, ``deconv_dilated``), so that each row has its twin; the
package gains nothing. Each row's scalar is the JAX row's f32 sum of its
output. Timing and lines as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.tail_ops_probe [--iters 10]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, bf16, probe_parser

B, C, HH, WH = 128, 11, 180, 240


def _jax_kernel(w: torch.Tensor) -> torch.Tensor:
    """A transposed-conv weight of the port ((I, O, k, k), flipped) as the
    JAX package holds it: (k, k, I, O), unflipped (``utils/jax_bridge``)."""
    return w.permute(2, 3, 0, 1).flip(0, 1)


def deconv_dilated(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2) -> torch.Tensor:
    """``_conv_transpose2d_dilated``: the input dilated by ``stride`` (zeros
    between pixels), padded by ``k + s - 2`` split with the odd pixel low,
    and correlated with the unflipped kernel. ``w`` in the port's layout."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d

    wj = _jax_kernel(w)
    k = int(wj.shape[0])
    b, h, wd, c = x.shape
    xd = x.new_zeros((b, (h - 1) * stride + 1, (wd - 1) * stride + 1, c))
    xd[:, ::stride, ::stride] = x
    pad = k + stride - 2
    lo, hi = pad - pad // 2, pad // 2
    return conv2d(xd, wj.permute(3, 2, 0, 1), padding=((lo, hi), (lo, hi)))


def phase_kernel(w: torch.Tensor, *, stride: int = 2) -> torch.Tensor:
    """``conv_transpose2d_phase``'s 3x3 kernel, OIHW (s*s*O, I, 3, 3): each
    output phase (a, b) of the transposed conv, a fixed 2x2 window of the
    input, as ``s*s`` groups of output channels. ``w`` in the port's layout,
    k = 2 * stride."""
    wj = _jax_kernel(w)
    k, cin, cout = int(wj.shape[0]), int(wj.shape[2]), int(wj.shape[3])
    s = stride
    pad_lo = (k + s - 2) - (k + s - 2) // 2
    w3 = torch.zeros((3, 3, cin, s * s * cout), dtype=w.dtype, device=w.device)
    for a in range(s):
        for t in range(2):
            kh = (pad_lo - a) % s + t * s
            if not 0 <= kh < k:
                continue
            slot_h = (a + kh - pad_lo) // s + 1
            for b in range(s):
                for u in range(2):
                    kw = (pad_lo - b) % s + u * s
                    if not 0 <= kw < k:
                        continue
                    slot_w = (b + kw - pad_lo) // s + 1
                    phase = a * s + b
                    w3[slot_h, slot_w, :, phase * cout:(phase + 1) * cout] += wj[kh, kw]
    return w3.permute(3, 2, 0, 1)


def deconv_phase(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2) -> torch.Tensor:
    """``conv_transpose2d_phase``: one 3x3 conv at the input's resolution
    into ``s*s*O`` channels, then the phases interleaved into the output."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d

    b, h, wd, _ = x.shape
    cout = int(w.shape[1])
    out = conv2d(x, phase_kernel(w, stride=stride), padding="SAME")
    out = out.reshape(b, h, wd, stride, stride, cout).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, h * stride, wd * stride, cout)


def cases(y: torch.Tensor, s: torch.Tensor, y_pc: torch.Tensor, w_up, w_si, b_si, w44):
    """``[(label, fn)]``; ``y`` the full-res map, ``s`` the half-res one,
    ``y_pc`` a 4C-channel half-res map; ``fn()`` returns the row's output."""
    from iterative_inference_segm_tpu_torch.ops.conv import avg_pool, conv2d, conv2d_depthwise, delta_kernel_depthwise

    b, hh, wh, c = s.shape
    eps, k99 = bf16(0.1), bf16(0.99)
    w3_zero = torch.zeros((4 * c, c, 3, 3), dtype=s.dtype, device=s.device)  # the JAX row's zero kernel
    w_dw = delta_kernel_depthwise(3, c).to(y.device, y.dtype)
    return [
        ("baseline full-res (perturb+reduce)", lambda: (y,)),
        ("baseline half-res", lambda: (s,)),
        ("deconv k4s2 phase-major (conv44 + interleave)", lambda: (deconv_phase(s, w_up),)),
        ("deconv k4s2 input-dilated", lambda: (deconv_dilated(s, w_up),)),
        ("phase conv 11->44 only (no interleave)", lambda: (conv2d(s, w3_zero, padding="SAME"),)),
        ("conv3x3 11->11 full-res", lambda: (conv2d(y, w_si, b_si),)),
        ("softmax f32 full-res", lambda: (torch.softmax(y.float(), -1),)),
        ("softmax bf16 full-res", lambda: (torch.softmax(y, -1),)),
        ("update elementwise full-res", lambda: (y - eps * (y - y * k99),)),
        ("avg_pool 2x2 full-res", lambda: (avg_pool(y, window=2, stride=2),)),
        ("conv3x3 depthwise full-res", lambda: (conv2d_depthwise(y, w_dw),)),
        ("conv3x3 44->44 half-res (phase-channel)", lambda: (conv2d(y_pc, w44),)),
        ("grouped softmax (4x11) half-res",
         lambda: (torch.softmax(y_pc.reshape(b, hh, wh, 4, c), -1).reshape(b, hh, wh, 4 * c),)),
        ("phase-channel pool to 11ch", lambda: (torch.mean(y_pc.reshape(b, hh, wh, 4, c), 3),)),
        ("NHWC full-res -> phase-channel",
         lambda: (y.reshape(b, hh, 2, wh, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hh, wh, 4 * c),)),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.ops.conv import bilinear_kernel, init_conv

    args = probe_parser(__doc__, iters=10, repeats=3).parse_args(argv)
    run = ProbeRun("tail_ops_probe", args)
    dev, dt = run.device, torch.bfloat16

    y = torch.softmax(run.normal((B, 2 * HH, 2 * WH, C), 0), -1).to(dt)
    s = run.normal((B, HH, WH, C), 1, dt)
    y_pc = run.normal((B, HH, WH, 4 * C), 3, dt)
    w_up = bilinear_kernel(4, C, C).to(dev, dt)
    w_si = init_conv(torch.Generator().manual_seed(2), 3, 3, C, C, device=dev)["w"].to(dt)
    b_si = torch.zeros((C,), dtype=dt, device=dev)
    w44 = (run.normal((4 * C, 4 * C, 3, 3), 4) * 0.05).to(dt)
    with torch.inference_mode():
        for label, fn in cases(y, s, y_pc, w_up, w_si, b_si, w44):
            run.time(label, fn, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
