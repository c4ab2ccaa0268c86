"""Is a slow FCN-8 forward the shape or the batch? The twin of the repo's
``tools/fwd_shape_probe.py`` on the card.

The inference forward (``fcn8_apply``, bf16, probabilities in bf16, no
dropout) over the JAX probe's shape grid: 360x480 at batch 128 (the bench's
shape), 224x224 at batch 64 and 128, 128x128 and 256x256 at batch 128; and
the training entry (``fcn8_logits``, no loss) at the training shapes. FCN-8
/ VGG16 fc 4096, C = 11, seeded weights, inputs uniform in [0, 1) from
``numpy.random.default_rng(0)``. ``--device cpu`` runs the JAX probe's
``--cpu`` grid (32x32, batch 2).

Each line adds the forward's FLOPs an image, counted by
``torch.utils.flop_counter.FlopCounterMode`` on the case's shapes (as
``tools/train_bench.py`` counts; the JAX probe assumed 150 GF an image at
360x480, scaled by pixels), the rate they give and its share of the H100's
dense bf16 peak, 989 TFLOP/s. Each row's scalar is the JAX row's, the f32
sum of the map's class 0. Timing and lines as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.fwd_shape_probe [--iters 10]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, first_class, probe_parser

C = 11
FC_CHANNELS = 4096
GRID = (  # (label, entry, batch, height, width): the JAX probe's grid, its labels letter for letter
    ("apply 360x480 b128 (bench shape)", "apply", 128, 360, 480),
    ("apply 224x224 b64  (train shape)", "apply", 64, 224, 224),
    ("apply 224x224 b128", "apply", 128, 224, 224),
    ("apply 128x128 b128 (train shape)", "apply", 128, 128, 128),
    ("apply 256x256 b128", "apply", 128, 256, 256),
    ("logits 224x224 b64 (train entry)", "logits", 64, 224, 224),
    ("logits 128x128 b128", "logits", 128, 128, 128),
)
CPU_GRID = (
    ("apply 32x32 b2 cpu-smoke", "apply", 2, 32, 32),
    ("logits 32x32 b2 cpu-smoke", "logits", 2, 32, 32),
)


def forward(entry: str, params: dict, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The JAX probe's ``apply_fwd`` / ``logits_fwd`` map: the probabilities
    of ``fcn8_apply`` at the compute dtype, or the f32 logits of
    ``fcn8_logits``."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, fcn8_logits

    if entry == "apply":
        return fcn8_apply(params, x, compute_dtype=compute_dtype, probs_dtype=compute_dtype)[0]
    return fcn8_logits(params, x, compute_dtype=compute_dtype)


def flops_per_image(entry: str, params: dict, batch: int, h: int, w: int) -> float:
    """The forward's FLOPs an image at this shape, counted on the meta
    device (shapes alone)."""
    from iterative_inference_segm_tpu_torch.tools.train_bench import count_flops

    meta = {k: {kk: t.to("meta") for kk, t in v.items()} for k, v in params.items()}
    x = torch.empty((batch, h, w, 3), device="meta")
    return count_flops(lambda: forward(entry, meta, x)) / batch


def cases(params: dict, grid, rng: np.random.Generator, compute_dtype=torch.bfloat16):
    """``[(label, fn, batch, h, w, entry)]`` over ``grid``, each input drawn
    from ``rng`` in the grid's order; ``fn()`` returns the row's map."""
    out = []
    for label, entry, b, h, w in grid:
        x = torch.from_numpy(rng.random((b, h, w, 3), np.float32)).to(params["conv1_1"]["w"].device)
        out.append((label, lambda entry=entry, x=x: (forward(entry, params, x, compute_dtype),), b, h, w, entry))
    return out


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    from iterative_inference_segm_tpu_torch.tools.train_bench import PEAK_FLOPS

    args = probe_parser(__doc__, iters=10, repeats=3).parse_args(argv)
    run = ProbeRun("fwd_shape_probe", args)
    params = init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=FC_CHANNELS, device=run.device)
    grid = CPU_GRID if run.device.type == "cpu" else GRID
    with torch.inference_mode():
        for label, fn, b, h, w, entry in cases(params, grid, np.random.default_rng(0)):
            flops = flops_per_image(entry, params, b, h, w)

            def rates(ms, flops=flops, b=b):
                tflops = flops * b / ms / 1e9
                return {"gflops_per_img": flops / 1e9, "tflops": tflops,
                        "peak_share": tflops * 1e12 / PEAK_FLOPS["bf16"]}

            run.time(label, fn, b, first_class, rates)
    return 0


if __name__ == "__main__":
    sys.exit(main())
