"""Per-block FCN-8 timing at batch 32: the twin of the repo's
``tools/fcn_block_probe.py`` on the card.

The VGG16 stack (fc 4096, 360x480, bf16, seeded weights) cut after each of
its five blocks, each prefix timed with its delta over the one before, then
the stack through fc6 and fc7 and the fc6+fc7 delta. Each row's scalar is
the JAX row's, the f32 sum of the map's channel 0. Timing and lines as
``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.fcn_block_probe [--iters 10]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, first_class, probe_parser

B, H, W, C = 32, 360, 480, 11
FC_CHANNELS = 4096
MARKS = {3: "block1", 6: "block2", 10: "block3", 14: "block4", 18: "block5"}  # items of _VGG through each block


def vgg_prefix(params: dict, x: torch.Tensor, n_items: int, *, fc: bool = False, compute_dtype=torch.bfloat16):
    """The first ``n_items`` of the VGG16 list (convs with ReLU, 'P' a
    ceil-mode 2x2 max-pool) on ``x`` at ``compute_dtype``; with ``fc``, fc6
    and fc7 (with ReLU) after them."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import _VGG
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, max_pool

    h = x.to(compute_dtype)
    for item in _VGG[:n_items]:
        if item == "P":
            h = max_pool(h)
        else:
            p = params[item[0]]
            h = torch.relu(conv2d(h, p["w"], p["b"], padding="SAME"))
    for name in ("fc6", "fc7") if fc else ():
        h = torch.relu(conv2d(h, params[name]["w"], params[name]["b"], padding="SAME"))
    return h


def cases(params: dict, x: torch.Tensor, *, compute_dtype=torch.bfloat16):
    """``[(label, fn)]``: through each block, then through fc7."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import _VGG

    out = [(f"through {name}", lambda n=n: (vgg_prefix(params, x, n, compute_dtype=compute_dtype),))
           for n, name in MARKS.items()]
    out.append(("through fc7", lambda: (vgg_prefix(params, x, len(_VGG), fc=True, compute_dtype=compute_dtype),)))
    return out


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8

    args = probe_parser(__doc__, iters=10, repeats=1).parse_args(argv)
    run = ProbeRun("fcn_block_probe", args)
    params = init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=FC_CHANNELS, device=run.device)
    x = run.normal((B, H, W, 3), 1)
    prev = 0.0
    with torch.inference_mode():
        for label, fn in cases(params, x):
            t = run.time(label, fn, B, first_class)
            run.derived("delta fc6+fc7" if label == "through fc7" else f"delta {label.split()[-1]}", t - prev, B)
            prev = t
    return 0


if __name__ == "__main__":
    sys.exit(main())
