"""Benchmark: FCN-8 + K-step DAE refinement throughput on the card (the port
of the repo's ``bench.py``).

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "images/sec/chip", "vs_baseline": N,
     "device": "<card name>, <power limit>"}

The measured configuration is the JAX tool's: CamVid 360x480 images through
the flagship pipeline (``inference.fused.flagship_forward_fn``: FCN-8
forward, K=5 pooled DAE steps, one full-resolution rectification; bf16,
batch 128), one synthetic batch resident on the card, the on-card scalar
``sum(argmax(y_K))`` out. The flags, their defaults, ``--preset fast`` and
the refusals are ``bench.py``'s, plus ``--device`` (``cuda`` unless the
caller asks for ``cpu``); the ``metric`` string is ``bench.py``'s letter for
letter. ``vs_baseline`` is the ratio to the north-star target of 1000
images/s per card, a target, not a measurement.

``--engine fused --dae-tail sep`` runs the phase-major engine
(``inference.fused.fused_refinement_scan``, its full-resolution step one
``septail_step`` kernel launch) with the conditioning hoisted out of the
steps, as ``bench.py``'s fused pipeline.

By design (ROADMAP.md, Queue 3): no ``frontier`` key (``frontier.py`` is a
table of TPU readings); ``--check``'s floors are this card's own (below);
the JSON lines go to ``chiprun_out/bench_history_torch.jsonl``, never
``BENCH_HISTORY.jsonl``.

Timing: a chained block of ``--iters`` forwards between two CUDA events,
the best of 3, after ``--warmup`` forwards that end in a synchronize
(``tools/timing.chained_ms``).

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.bench [--batch N] [--steps K]
        [--iters I] [--dtype bf16|f32] [--engine half|general|fused] [--preset fast] [--check]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import HISTORY_DIR, append_history, chained_ms, device_stamp

HISTORY = HISTORY_DIR / "bench_history_torch.jsonl"
TARGET = 1000.0  # images/s per card: the north star, not a measurement

# --check floors, as vs_baseline: this card's own readings, never the TPU's
# (bench.py's 0.715 and 1.00). Each sits below the lowest of its three runs
# by those runs' spread (largest less smallest), rounded down. Runs:
# chip_smoke.py's bench phase in three calls on NVIDIA H100 80GB HBM3,
# 700.00 W (PERF.md, section 6).
PERF_FLOOR = 0.886  # the default configuration, batch 128: 890.78, 890.67, 894.44 images/s
FAST_PERF_FLOOR = 1.487  # --preset fast, batch 128: 1496.55, 1492.52, 1497.06 images/s


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--fc-channels", type=int, default=4096)
    p.add_argument("--dae-stem-pool", type=int, default=1,
                   help="DAE stem pooling levels (0 = classic full-res encoder)")
    p.add_argument("--dae-depth", type=int, default=None,
                   help="score-network depth (default 3 for --arch dae, 4 for --arch mirror)")
    p.add_argument("--dae-widths", nargs="*", type=int, default=None,
                   help="encoder channel widths (default from models.dae)")
    p.add_argument("--dae-encoder", choices=["pool", "stride"], default="pool")
    p.add_argument("--dae-tail", choices=["full", "sep"], default="full")
    p.add_argument("--arch", choices=["dae", "mirror"], default="dae",
                   help="score network; 'mirror' requires --engine general")
    p.add_argument("--mode", choices=["score", "energy"], default="score")
    p.add_argument("--engine", choices=["general", "half", "fused"], default="half",
                   help="'half' = the pooled engine (the flagship); 'general' = every step at full "
                        "resolution; 'fused' = the phase-major engine (needs --dae-tail sep "
                        "--dae-stem-pool 1)")
    p.add_argument("--state-dtype", choices=["bf16", "f32", "compute"], default="compute",
                   help="refinement carry dtype ('compute' follows --dtype)")
    p.add_argument("--no-fold-tail", action="store_true",
                   help="half engine: disable the folded per-step tail for A/B runs")
    p.add_argument("--preset", choices=["fast"], default=None,
                   help="'fast' = fc512 + stride encoder + quarter engine; overrides the config flags "
                        "and gives --check its own floor")
    p.add_argument("--check", action="store_true",
                   help="exit 1 if vs_baseline falls below the configuration's floor on this card")
    p.add_argument("--no-history", action="store_true", help=f"skip appending to {HISTORY.name}")
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda' needs a card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)
    if args.preset == "fast":
        args.fc_channels = 512
        args.dae_encoder = "stride"
        args.dae_stem_pool = 2
        args.dae_depth = 3
        args.engine = "half"
        args.dae_tail = "full"
        args.arch = "dae"
        args.mode = "score"
    if args.arch == "mirror" and args.engine != "general":
        raise SystemExit("--arch mirror requires --engine general (the mirror "
                         "architecture is full-res only — no pooled stem)")
    if args.mode == "energy" and args.engine == "fused":
        raise SystemExit("--mode energy is not supported by the fused "
                         "phase-major experiment (score only)")
    if args.engine == "fused" and (args.dae_tail != "sep" or args.dae_stem_pool != 1):
        raise SystemExit("--engine fused requires --dae-tail sep --dae-stem-pool 1")
    if args.engine == "half" and args.dae_stem_pool < 1:
        raise SystemExit("--engine half requires --dae-stem-pool >= 1 "
                         "(1 = half engine, 2 = quarter engine)")
    args.arch_default_depth = 4 if args.arch == "mirror" else 3
    if args.dae_depth is None:
        args.dae_depth = args.arch_default_depth
    return args


def dtypes(args):
    """(compute dtype, refinement carry dtype)."""
    compute = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    state = {"bf16": torch.bfloat16, "f32": torch.float32, "compute": compute}[args.state_dtype]
    return compute, state


def init_params(args, device):
    """Seeded full-width params of the configuration (FCN-8 seed 0, the
    score network seed 1), f32 on ``device``."""
    from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
    from iterative_inference_segm_tpu_torch.models.dae_mirror import init_mirror_dae
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8

    c = CAMVID.n_classes
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=c, fc_channels=args.fc_channels, device=device)
    kw = dict(n_classes=c, h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=args.dae_depth, device=device,
              **({"widths": tuple(args.dae_widths)} if args.dae_widths else {}))
    if args.arch == "mirror":
        dae = init_mirror_dae(torch.Generator().manual_seed(1), **kw)
    else:
        dae = init_dae(torch.Generator().manual_seed(1), stem_pool=args.dae_stem_pool, tail=args.dae_tail, **kw)
    return fcn, dae


def build_pipeline(args):
    """``pipeline(fcn_params, dae_params, x) -> sum(argmax(y_K))`` on the
    params' device, for the configuration ``args`` (``parse_args``): the
    half engine's ``flagship_forward_fn`` (its rectification's labels are the
    argmax) or the general engine's ``logits_refinement_scan`` over the score
    network's logits, each in its no-autograd context; or the phase-major
    engine's ``fused_refinement_scan``, its conditioning hoisted by
    ``precompute_bottleneck_h``."""
    from iterative_inference_segm_tpu_torch.inference.fused import flagship_forward_fn, no_autograd

    compute, state = dtypes(args)
    if args.engine == "fused":
        return _fused_pipeline(args, compute, state)
    if args.engine == "half":
        # the folded per-step tail is a score-mode algebra, so energy runs unfolded
        fold = args.dae_tail == "full" and not args.no_fold_tail and args.mode == "score"
        forward = flagship_forward_fn(num_steps=args.steps, depth=args.dae_depth, compute_dtype=compute,
                                      state_dtype=state, encoder=args.dae_encoder, mode=args.mode, fold_tail=fold,
                                      with_labels=True)

        def pipeline(fcn_params, dae_params, x):
            with no_autograd(args.mode):
                _, _, labels = forward(fcn_params, dae_params, x)
                return torch.sum(labels, dtype=torch.int64)

        return pipeline

    from iterative_inference_segm_tpu_torch.inference.iterative import logits_refinement_scan
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply
    from iterative_inference_segm_tpu_torch.models.registry import score_kwargs, score_logits_fn

    logits_fn = score_logits_fn(args.arch)
    kw = dict(score_kwargs(args.arch, depth=args.dae_depth, encoder=args.dae_encoder), compute_dtype=compute)

    def score_logits(dae_params, y, h):
        u = logits_fn(dae_params, y, h, **kw)
        # the tail kernel takes logits in y's dtype, or bf16 beside f32
        return u if u.dtype in (y.dtype, torch.bfloat16) else u.to(y.dtype)

    def pipeline(fcn_params, dae_params, x):
        with no_autograd(args.mode):
            y0, h = fcn8_apply(fcn_params, x, return_features=("pool4",), compute_dtype=compute,
                               probs_dtype=state)
            y_k = logits_refinement_scan(lambda y: score_logits(dae_params, y, h), y0.to(state), eps=0.1,
                                  num_steps=args.steps, mode=args.mode)
            return torch.sum(torch.argmax(y_k, dim=-1))

    return pipeline


def _fused_pipeline(args, compute, state):
    """``bench.py``'s fused pipeline: FCN-8, the bottleneck-scale taps
    folded into a bias once, K phase-major steps, ``sum(argmax(y_K))``."""
    from iterative_inference_segm_tpu_torch.inference.fused import fused_refinement_scan
    from iterative_inference_segm_tpu_torch.models.dae import dae_core, precompute_bottleneck_h
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply

    sp = args.dae_stem_pool

    def pipeline(fcn_params, dae_params, x):
        with torch.inference_mode():
            y0, h = fcn8_apply(fcn_params, x, return_features=("pool4",), compute_dtype=compute,
                               probs_dtype=state)
            bh = precompute_bottleneck_h(dae_params, h, depth=args.dae_depth, stem_pool=sp,
                                         in_hw=(x.shape[1] >> sp, x.shape[2] >> sp))

            def core_fn(yp):
                return dae_core(dae_params, yp.to(compute), bh[2], depth=args.dae_depth, stem_pool=sp,
                                bottleneck_h=bh, encoder=args.dae_encoder)

            y_k = fused_refinement_scan(dae_params, core_fn, y0, eps=0.1, num_steps=args.steps, state_dtype=state)
            return torch.sum(torch.argmax(y_k, dim=-1))

    return pipeline


def cfg_bits(args) -> str:
    """``bench.py``'s markers of a configuration other than the default."""
    bits = ""
    if args.fc_channels != 4096:
        bits += f", fc={args.fc_channels}"
    if args.dae_encoder != "pool":
        bits += f", enc={args.dae_encoder}"
    if args.dae_stem_pool != 1:
        bits += f", sp={args.dae_stem_pool}"
    if args.dae_depth != args.arch_default_depth:
        bits += f", depth={args.dae_depth}"
    if args.arch != "dae":
        bits += f", arch={args.arch}"
    if args.mode != "score":
        bits += f", mode={args.mode}"
    if args.no_fold_tail and args.engine == "half" and args.dae_tail == "full":
        bits += ", nofold"
    if args.state_dtype != "compute":
        bits += f", carry={args.state_dtype}"
    if args.preset:
        bits += f", preset={args.preset}"
    return bits


def metric(args) -> str:
    return (f"images/sec/chip (FCN-8 + {args.steps}-step DAE refine, {args.height}x{args.width}, {args.dtype}, "
            f"batch={args.batch}, engine={args.engine}, tail={args.dae_tail}{cfg_bits(args)})")


def floor_of(args) -> float:
    return FAST_PERF_FLOOR if args.preset == "fast" else PERF_FLOOR


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
    from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches
    from iterative_inference_segm_tpu_torch.scripts._parallel import check_device

    args = parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    fcn_params, dae_params = init_params(args, device)
    pipeline = build_pipeline(args)
    ((images, _),) = synthetic_batches(cfg=CAMVID, batch_size=args.batch, num_batches=1, height=args.height,
                                       width=args.width, seed=0)
    x = torch.from_numpy(images).to(device)
    ms, _ = chained_ms(lambda: pipeline(fcn_params, dae_params, x), args.iters, device=device, warmup=args.warmup)
    imgs_per_sec = args.batch * 1e3 / ms
    result = {
        "metric": metric(args),
        "value": round(imgs_per_sec, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(imgs_per_sec / TARGET, 4),
        "device": device_stamp(device),
    }
    print(json.dumps(result), flush=True)
    if not args.no_history:
        append_history(HISTORY, result)
    floor = floor_of(args)
    if args.check and result["vs_baseline"] < floor:
        print(f"PERF GATE FAILED: vs_baseline {result['vs_baseline']} < floor {floor}"
              + (f" (preset={args.preset})" if args.preset else ""), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
