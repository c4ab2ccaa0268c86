"""Compare the refinement engines on the card at the bench configuration (the
port of the repo's ``tools/fused_bench.py``).

Variants, as the JAX tool's: the 'full'-tail general engine, the 'sep'-tail
general engine, and the 'sep'-tail phase-major ``fused`` engine with a bf16
and with an f32 carry. FCN-8 (fc 4096, C = 11) and a DAE of stem_pool 1,
depth 3 from seeded random weights, bf16 compute, K = 5, eps = 0.1, 360x480
(fixed, as in the JAX tool), batch 128 by default; the FCN's probabilities
in f32, and the fused variants recompute the conditioning inside the core at
each step, as the JAX tool does. Each variant is timed by ``tools/timing.chained_ms``: the best
of 3 chained blocks of ``--iters`` forwards between CUDA events, after a
warm-up forward.

Prints the card (``nvidia-smi``'s name and power limit), then one line a
variant in the JAX tool's form: ms a batch, ms an image, images/s.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.fused_bench [--batch N] [--steps K] [--iters I]
"""

from __future__ import annotations

import argparse
import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import chained_ms, device_stamp

H, W, C = 360, 480, 11  # the JAX tool's bench configuration
FC_CHANNELS = 4096


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda' needs a card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def variants(args, device):
    """``[(label, fn)]``, ``fn()`` a forward's on-device ``sum(argmax(y_K))``,
    over the tool's seeded params and input on ``device``."""
    from iterative_inference_segm_tpu_torch.inference.fused import fused_refinement_scan
    from iterative_inference_segm_tpu_torch.inference.iterative import refinement_scan
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, dae_core, dae_logits, init_dae
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8

    cd, k = torch.bfloat16, args.steps
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=FC_CHANNELS, device=device)
    kw = dict(n_classes=C, h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=args.depth, stem_pool=1, device=device)
    dae = {tail: init_dae(torch.Generator().manual_seed(1), tail=tail, **kw) for tail in ("full", "sep")}
    x = torch.randn((args.batch, H, W, 3), generator=torch.Generator().manual_seed(2)).to(device)

    def general(tail):
        def fn():
            with torch.inference_mode():
                y0, h = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd)
                yk = refinement_scan(lambda y: dae_logits(dae[tail], y, h, depth=args.depth, compute_dtype=cd),
                                     y0, eps=0.1, num_steps=k, mode="score")
                return torch.sum(torch.argmax(yk, dim=-1))
        return fn

    def fused(state_dtype):
        def fn():
            with torch.inference_mode():
                y0, h = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd)
                core_fn = lambda yp: dae_core(dae["sep"], yp.to(cd), h, depth=args.depth, stem_pool=1)  # noqa: E731
                yk = fused_refinement_scan(dae["sep"], core_fn, y0, eps=0.1, num_steps=k, state_dtype=state_dtype)
                return torch.sum(torch.argmax(yk, dim=-1))
        return fn

    return [
        (f"full tail, general engine (K={k})", general("full")),
        (f"sep tail, general engine (K={k})", general("sep")),
        (f"sep tail, FUSED bf16 state (K={k})", fused(torch.bfloat16)),
        (f"sep tail, FUSED f32 state (K={k})", fused(torch.float32)),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.scripts._parallel import check_device

    args = parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    print(f"device: {device_stamp(device)}", flush=True)
    for label, fn in variants(args, device):
        ms, _ = chained_ms(fn, args.iters, device=device, warmup=1)
        print(f"{label:<44s} {ms:8.2f} ms/iter {ms / args.batch:7.4f} ms/img -> "
              f"{args.batch * 1e3 / ms:7.1f} img/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
