"""Each op of a DAE step alone, at batch 32: the twin of the repo's
``tools/dae_op_probe.py`` on the card.

360x480, C = 11, seeded maps and weights: an elementwise pass and the
softmax in f32, the first DAE conv (11 -> 32) and a 32 -> 32 conv at full
resolution, max-pool and avg-pool, a 32 -> 64 conv at half resolution, the
k4/s2 class-width transposed conv in f32 and bf16, a 1x1 score conv, and
stage 1 as the DAE runs it (cast, conv, ReLU, pool), with the JAX probe's
labels. Each row's scalar is the JAX row's f32 sum of its output. Timing and
lines as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.dae_op_probe [--iters 20]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, probe_parser

B, H, W, C = 32, 360, 480, 11


def cases(y: torch.Tensor, x32: torch.Tensor, x180: torch.Tensor, s_half: torch.Tensor, w32, b32, up_w, sc_w, *,
          low=torch.bfloat16):
    """``[(label, fn)]``; ``y`` f32 probabilities at full resolution, ``x32``
    and ``x180`` 32-channel maps at /1 and /2 at ``low`` (the JAX rows'
    bf16), ``s_half`` an f32 class-width map at /2; ``fn()`` returns the
    row's output."""
    from iterative_inference_segm_tpu_torch.ops.conv import avg_pool, conv2d, conv_transpose2d, max_pool

    bf = low
    y16 = y.to(bf)
    z32 = torch.zeros((32, 32, 3, 3), dtype=bf, device=y.device)
    z64 = torch.zeros((64, 32, 3, 3), dtype=bf, device=y.device)
    return [
        ("elementwise pass f32 (B,H,W,11)", lambda: (y * 1.0001,)),
        ("softmax f32 (B,H,W,11)", lambda: (torch.softmax(y, -1),)),
        ("conv3x3 11->32 bf16 @/1", lambda: (conv2d(y16, w32, b32),)),
        ("conv3x3 32->32 bf16 @/1", lambda: (conv2d(x32, z32),)),
        ("max_pool 2x2 bf16 @/1 (32ch)", lambda: (max_pool(x32),)),
        ("max_pool 2x2 f32 @/1 (11ch)", lambda: (max_pool(y),)),
        ("avg_pool 2x2 f32 @/1 (11ch)", lambda: (avg_pool(y),)),
        ("conv3x3 32->64 bf16 @/2", lambda: (conv2d(x180, z64),)),
        ("deconv k4s2 11->11 f32 /2->/1", lambda: (conv_transpose2d(s_half, up_w, stride=2),)),
        ("deconv k4s2 11->11 bf16 /2->/1", lambda: (conv_transpose2d(s_half.to(bf), up_w.to(bf), stride=2),)),
        ("score 1x1 32->11 bf16 @/1", lambda: (conv2d(x32, sc_w.to(bf)),)),
        ("stage1: cast+conv+relu+pool @/1", lambda: (max_pool(torch.relu(conv2d(y.to(bf), w32, b32))),)),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.ops.conv import bilinear_kernel, init_conv

    args = probe_parser(__doc__, iters=20, repeats=1).parse_args(argv)
    run = ProbeRun("dae_op_probe", args)
    dev, bf = run.device, torch.bfloat16
    y = torch.softmax(run.normal((B, H, W, C), 0), -1)
    enc1 = init_conv(torch.Generator().manual_seed(0), 3, 3, C, 32, device=dev)
    w32, b32 = enc1["w"].to(bf), enc1["b"].to(bf)
    x32 = run.normal((B, H, W, 32), 1, bf)
    x180 = run.normal((B, H // 2, W // 2, 32), 2, bf)
    up_w = bilinear_kernel(4, C, C).to(dev)
    s_half = run.normal((B, H // 2, W // 2, C), 3)
    sc_w = init_conv(torch.Generator().manual_seed(0), 1, 1, 32, C, device=dev)["w"]
    with torch.inference_mode():
        for label, fn in cases(y, x32, x180, s_half, w32, b32, up_w, sc_w):
            run.time(label, fn, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
