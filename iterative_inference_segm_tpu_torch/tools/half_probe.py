"""Decompose the half engine's cost and its levers: the twin of the repo's
``tools/half_probe.py`` on the card.

At batch 128, bf16, 360x480 (FCN-8 / VGG16 fc 4096, C = 11, seeded
weights), for each of the JAX probe's four configurations (the flagship d3
(32, 64, 128), two lean widths, the 'sep' tail; stem_pool 1, the pool4 tap
folded into the bottleneck by ``precompute_bottleneck_h``), it times:

  - one half-resolution step (``dae_core`` + ``half_logits`` + softmax +
    update, op by op);
  - the full-resolution rectification with its argmax;
  - the full pipeline at K = 5 (``halfres_refinement_scan``, unfolded: each
    step and the rectification one launch of the tail kernel K3).

The updates are the JAX probe's ``x - bf16(0.1) * (x - r)`` in bf16. Each
row's scalar is the JAX row's: the f32 sum of the new iterate, or the sum of
the argmax labels. Timing and lines as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.half_probe [--batch 128] [--iters 8]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, bf16, probe_parser

H, W, C = 360, 480, 11
FC_CHANNELS = 4096
CONFIGS = (  # (label, depth, widths, tail): the JAX probe's
    ("flagship d3 (32,64,128)", 3, (32, 64, 128), "full"),
    ("lean d3 (24,48,96)", 3, (24, 48, 96), "full"),
    ("lean d3 (16,32,64)", 3, (16, 32, 64), "full"),
    ("flagship sep tail", 3, (32, 64, 128), "sep"),
)


def parse_args(argv=None):
    p = probe_parser(__doc__, iters=8, repeats=2)
    p.add_argument("--batch", type=int, default=128)
    return p.parse_args(argv)


def cases(label: str, fcn: dict, dae: dict, x: torch.Tensor, xh: torch.Tensor, y0: torch.Tensor, h: dict, *,
          depth: int, compute_dtype=torch.bfloat16):
    """``[(label, fn)]`` of one configuration: its half-res step, its
    rectification and its pipeline; ``xh``, ``y0`` probability maps at /2
    and /1, ``h`` the FCN's pool4 tap of ``x``. The step returns the new
    half-res iterate, the other two their argmax labels."""
    from iterative_inference_segm_tpu_torch.inference.fused import full_logits, half_logits, halfres_refinement_scan
    from iterative_inference_segm_tpu_torch.models.dae import dae_core, precompute_bottleneck_h
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply

    cd = compute_dtype
    eps = bf16(0.1)
    in_hw = (int(xh.shape[1]), int(xh.shape[2]))

    def core(yp, taps):
        bh = precompute_bottleneck_h(dae, taps, depth=depth, stem_pool=1, in_hw=in_hw)
        return dae_core(dae, yp.to(cd), bh[2], depth=depth, stem_pool=1, bottleneck_h=bh)

    def one_step():
        r = torch.softmax(half_logits(dae, xh, core(xh, h).to(cd)), -1)
        return (xh - eps * (xh - r),)

    def rect():
        r = torch.softmax(full_logits(dae, core(xh, h).to(cd), y0), -1)
        return (torch.argmax(y0 - eps * (y0 - r), -1),)

    def pipe():
        y0p, hp = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd, probs_dtype=cd)
        bh = precompute_bottleneck_h(dae, hp, depth=depth, stem_pool=1, in_hw=in_hw)
        yk = halfres_refinement_scan(
            dae, lambda yp: dae_core(dae, yp.to(cd), bh[2], depth=depth, stem_pool=1, bottleneck_h=bh), y0p,
            eps=0.1, num_steps=5, state_dtype=cd)
        return (torch.argmax(yk, -1),)

    return [
        (f"{label}: one half-res step", one_step),
        (f"{label}: rectification (core+tail+argmax)", rect),
        (f"{label}: FULL pipeline K=5", pipe),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8

    args = parse_args(argv)
    run = ProbeRun("half_probe", args)
    dev, b, cd = run.device, args.batch, torch.bfloat16
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=FC_CHANNELS, device=dev)
    x = run.normal((b, H, W, 3), 0)
    y0 = torch.softmax(run.normal((b, H, W, C), 1), -1).to(cd)
    xh = torch.softmax(run.normal((b, H // 2, W // 2, C), 2), -1).to(cd)
    with torch.inference_mode():
        _, h = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd)
        for label, depth, widths, tail in CONFIGS:
            dae = init_dae(torch.Generator().manual_seed(1), n_classes=C, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                           depth=depth, stem_pool=1, widths=widths, tail=tail, device=dev)
            for row, fn in cases(label, fcn, dae, x, xh, y0, h, depth=depth, compute_dtype=cd):
                run.time(row, fn, b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
