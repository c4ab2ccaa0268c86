"""Where does the general pipeline's time go? The twin of the repo's
``tools/perf_probe.py`` on the card.

Per batch in ``--batches``, at the JAX probe's configuration (FCN-8 / VGG16
fc 4096, C = 11, 360x480, the JAX ``init_dae`` defaults: depth 4, stem_pool
0, widths 32..256, the pool4 tap; weights from seeded generators), it times:

  - the FCN-8 forward alone;
  - one DAE forward on a precomputed (y0, h);
  - the K-step refinement scan alone on (y0, h): the general engine, each
    score step one launch of the tail kernel K3 (``ops.refine_tail``);
  - the full pipeline;

and derives the sum check (FCN + scan against the full pipeline). Each
row's scalar is the JAX row's, the f32 sum of the map's class 0. Timing:
``tools/timing.chained_ms`` (CUDA events, the best of ``--repeats`` blocks
of ``--iters`` calls after a warm-up call), under ``torch.inference_mode``.
One JSON line a row (``timing.ProbeRun``).

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.perf_probe [--batches 4 8 16] [--steps 5] [--iters 10]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, first_class, probe_parser

C = 11
FC_CHANNELS = 4096


def parse_args(argv=None):
    p = probe_parser(__doc__, iters=10, repeats=1)
    p.add_argument("--batches", nargs="*", type=int, default=[4, 8, 16])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    return p.parse_args(argv)


def cases(fcn: dict, dae: dict, x: torch.Tensor, y0: torch.Tensor, h: dict, *, steps: int, compute_dtype):
    """``[(label, fn)]`` of one batch; ``fn()`` returns the row's map(s).
    ``y0``, ``h``: the FCN's f32 probabilities and pool4 tap of ``x``."""
    from iterative_inference_segm_tpu_torch.inference.iterative import logits_refinement_scan
    from iterative_inference_segm_tpu_torch.models.dae import dae_apply, dae_logits
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply

    cd = compute_dtype

    def scan(y0_, h_):
        return logits_refinement_scan(lambda y: dae_logits(dae, y, h_, compute_dtype=cd), y0_, eps=0.1,
                                      num_steps=steps, mode="score")

    def full():
        y0_, h_ = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd)
        return (scan(y0_, h_),)

    return [
        ("FCN-8 forward", lambda: (fcn8_apply(fcn, x, compute_dtype=cd)[0],)),
        ("DAE forward (1 step)", lambda: (dae_apply(dae, y0, h, compute_dtype=cd),)),
        (f"refinement scan ({steps} steps)", lambda: (scan(y0, h),)),
        (f"full pipeline (FCN + {steps} steps)", full),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8

    args = parse_args(argv)
    run = ProbeRun("perf_probe", args)
    dev, cd = run.device, torch.bfloat16 if args.dtype == "bf16" else torch.float32
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=FC_CHANNELS, device=dev)
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=C, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                   device=dev)
    with torch.inference_mode():
        for b in args.batches:
            x = run.normal((b, args.height, args.width, 3), 2)
            y0, h = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd)
            t = [run.time(label, fn, b, first_class)
                 for label, fn in cases(fcn, dae, x, y0, h, steps=args.steps, compute_dtype=cd)]
            run.derived("sum check: fcn + scan", t[0] + t[2], b, full_ms=t[3])
            del x, y0, h
    return 0


if __name__ == "__main__":
    sys.exit(main())
