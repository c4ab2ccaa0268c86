"""The port of ``__graft_entry__.entry()``: the flagship forward and its
example arguments, on the card.

``entry()`` returns ``(forward, (fcn_params, dae_params, x))``: FCN-8 at
full width (fc 4096, CamVid's 11 classes, seed 0) + the DAE (pool4, depth
3, stem 1, seed 1), five half-engine score steps, bf16 with the folded
per-step tail (``inference.fused.flagship_forward_fn``), and one zero image
``x`` of (1, 360, 480, 3) f32. ``forward(fcn_params, dae_params, x)`` gives
``y_K`` (1, 360, 480, 11) bf16.

    python -m iterative_inference_segm_tpu_torch.entry
    # entry() OK (1, 360, 480, 11) torch.bfloat16

``multichip`` (the JAX file's multi-device dry run) exits: it needs spatial
sharding and ``restore_checkpoint_sharded`` (ROADMAP.md, Queue 1 step I,
the next slice).
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.inference.fused import flagship_forward_fn, no_autograd
from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8

MULTICHIP = ("multichip (the multi-device training-step dry run) is not ported yet: it shards H over a "
             "'space' axis and restores a checkpoint onto tensor-parallel shardings; spatial sharding and "
             "restore_checkpoint_sharded come in the next slice (ROADMAP.md, Queue 1 step I)")


def flagship_params(device: torch.device | str = "cuda") -> tuple[dict, dict]:
    """The flagship's seeded full-width params, f32 on ``device``: FCN-8 fc
    4096 for CamVid's 11 classes (seed 0) and the DAE on pool4, depth 3,
    stem 1 (seed 1). The serving and training benches run them too."""
    n_classes = 11
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=n_classes, device=device)
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=n_classes, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                   depth=3, stem_pool=1, device=device)
    return fcn, dae


def entry(device: torch.device | str = "cuda"):
    """``(forward, (fcn_params, dae_params, x))`` on ``device``: the
    flagship forward (FCN-8 + K=5 half-engine refinement, bf16) and its
    example arguments."""
    fcn_params, dae_params = flagship_params(device)
    flagship = flagship_forward_fn(num_steps=5, depth=3)

    def forward(fcn_params, dae_params, x):
        with no_autograd("score"):
            _, y_k = flagship(fcn_params, dae_params, x)
        return y_k

    x = torch.zeros((1, 360, 480, 3), dtype=torch.float32, device=device)
    return forward, (fcn_params, dae_params, x)


def main(argv=None) -> int:
    import argparse

    from iterative_inference_segm_tpu_torch.scripts._parallel import check_device

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", nargs="*", help="'multichip [N]' exits naming ROADMAP step I")
    p.add_argument("--device", default="cuda", help="torch device ('cuda' needs a card)")
    args = p.parse_args(argv)
    if args.command[:1] == ["multichip"]:
        raise SystemExit(MULTICHIP)
    device = torch.device(args.device)
    check_device(device)
    fn, example = entry(device)
    out = fn(*example)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("entry() OK", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
