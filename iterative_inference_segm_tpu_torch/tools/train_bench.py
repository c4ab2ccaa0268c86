"""Training throughput on the card: the FCN-8 and DAE train steps over batch
x crop x augment x remat, with FLOPs and the share of the card's peak (the
port of the repo's ``tools/train_bench.py``).

Cells, as the JAX tool's: ``FCN-8`` (full width, fc 4096, Adam 1e-3 with
coupled L2, dropout) and ``DAE(stem1,d3)`` (the frozen FCN-8 inside the
step, run through pool4 alone: sigma 1.0 from the ground truth reads no
probabilities, so K1 ``corrupt_onehot`` runs once a step on the card),
CamVid shapes. ``--augment on`` hands the step full
360x480 frames that it crops and flips on the card; ``off`` hands it
pre-cropped frames. Each step draws its randomness (crop offsets, flips,
dropout masks or K1's noise seed) from one generator, one draw a step, as
JAX folds the step's index into its key.

Timing: a chained block of ``--iters`` steps (each updates the params and
Adam's state in place) between two CUDA events, the best of 3, after one
warm-up step ended by a synchronize (``tools/timing.chained_ms``).

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one step's
forward and backward at ``FLOPS_PROBE_BATCH`` images on the meta device
(the count is a function of the shapes alone, so it equals the CPU's),
scaled linearly per image, as JAX scales XLA's count of the same step. It
counts convolutions and matmuls (forward, and both gradients of each in
the backward, with ``remat``'s recomputation); XLA's count also holds the
elementwise work and the optimizer. ``mfu_pct`` = FLOPs / (seconds x the
card's dense peak: 989 TFLOP/s bf16, 67 TFLOP/s f32 with TF32 off; the H100
SXM's published figures at 700 W), printed beside the card's power limit
(``device``). JAX's ``mxu_pct`` is a TPU v5e share and does not carry over.

``--donate`` runs the FCN-8 cell alone and keeps ``, donate`` in its metric
string, as the JAX tool does; the port's steps already update params and
Adam's state in place, so there is nothing to donate. ``--isolate`` runs
each (batch, crop, augment) cell in a subprocess of its own. A
``torch.cuda.OutOfMemoryError`` in a cell is recorded as the JAX tool's OOM
line and the sweep goes on. JSON lines go to
``chiprun_out/train_history_torch.jsonl``, never ``TRAIN_HISTORY.jsonl``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.train_bench --batches 32,64 --crops 224
    python -m iterative_inference_segm_tpu_torch.tools.train_bench --remat --augment on
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
from iterative_inference_segm_tpu_torch.entry import flagship_params
from iterative_inference_segm_tpu_torch.models.fcn8 import fc_shape
from iterative_inference_segm_tpu_torch.tools.timing import HISTORY_DIR, append_history, chained_ms, device_stamp
from iterative_inference_segm_tpu_torch.train.train_dae import draw_step_randomness as draw_dae_randomness
from iterative_inference_segm_tpu_torch.train.train_dae import make_dae_train_step
from iterative_inference_segm_tpu_torch.train.train_fcn8 import draw_step_randomness as draw_fcn_randomness
from iterative_inference_segm_tpu_torch.train.train_fcn8 import make_fcn8_train_step
from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer

HISTORY = HISTORY_DIR / "train_history_torch.jsonl"
FLOPS_PROBE_BATCH = 4
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}  # H100 SXM dense, at 700 W (f32: TF32 off)
FLOPS_ENV = "TRAIN_BENCH_FLOPS_JSON"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batches", type=str, default="32")
    p.add_argument("--crops", type=str, default="224")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--donate", action="store_true",
                   help="the FCN-8 cell alone, as the JAX tool's donation A/B (nothing to donate here)")
    p.add_argument("--no-flops", action="store_true", help="skip the FLOPs count (no mfu_pct)")
    p.add_argument("--augment", choices=["both", "on", "off"], default="both",
                   help="which augmentation settings to sweep (donate forces 'on')")
    p.add_argument("--isolate", action="store_true", help="run each (batch, crop, augment) cell in its own process")
    p.add_argument("--no-history", action="store_true", help=f"skip appending to {HISTORY.name}")
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda' needs a card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)
    args.batches = [int(b) for b in args.batches.split(",")]
    args.crops = [int(c) for c in args.crops.split(",")]
    return args


def augment_settings(args) -> list[bool]:
    if args.donate or args.augment == "on":
        return [True]
    if args.augment == "off":
        return [False]
    return [True, False]


def _clone(tree):
    return {k: {kk: t.detach().clone() for kk, t in v.items()} for k, v in tree.items()}


@dataclasses.dataclass
class Cell:
    """One workload at one (batch, crop, augment): ``step()`` runs a train
    step with the next draw of its randomness and returns the loss;
    ``flops_step`` the same step's forward and backward for the count."""

    label: str
    step: callable
    flops_step: callable


def make_cells(args, batch: int, crop: int, augment: bool, device, params=None) -> list[Cell]:
    """The cells at (batch, crop, augment) on ``device``. With ``augment``
    the step gets full frames and crops them; without, pre-cropped frames.
    ``params``: ``(fcn, dae)`` in place of the flagship's
    (``entry.flagship_params``; each cell trains its own copy)."""
    cfg = dataclasses.replace(CAMVID, train_crop=(crop, crop))
    tcfg = TrainConfig(learning_rate=1e-3, compute_dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
                       remat=args.remat)
    h, w = (args.height, args.width) if augment else (crop, crop)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((batch, h, w, 3), np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes, (batch, h, w)).astype(np.int32)).to(device)
    fcn0, dae0 = params if params is not None else flagship_params(device)
    gen = torch.Generator().manual_seed(1)  # one draw a step
    crop_hw = (crop, crop) if augment else None
    cells = []

    fcn = _clone(fcn0)
    fcn_opt = make_optimizer(tcfg, fcn)
    fcn_step, _ = make_fcn8_train_step(cfg, tcfg, fcn_opt, augment=augment,
                                            fc_channels=int(fcn["fc6"]["w"].shape[0]))

    def fcn_train():
        rand = draw_fcn_randomness(gen, batch=batch, hw=(h, w), crop=crop_hw, device=device)
        return fcn_step(fcn, images, labels, rand)

    def fcn_flops():
        rand = draw_fcn_randomness(gen, batch=batch, hw=(h, w), crop=crop_hw, device="cpu")
        x, y = fcn_step.stages.prepare(images, labels, rand)
        shape = fc_shape(x.shape, int(fcn["fc6"]["w"].shape[0]))
        masks = tuple(torch.ones(shape, dtype=torch.bool, device=x.device) for _ in range(2))
        fcn_step.stages.loss(fcn, x, y, masks).backward()

    cells.append(Cell("FCN-8", fcn_train, fcn_flops))
    if args.donate:
        return cells

    dae = _clone(dae0)
    dae_opt = make_optimizer(tcfg, dae)
    dae_step, _ = make_dae_train_step(cfg, tcfg, dae_opt, h_taps=("pool4",), sigma=1.0, from_gt=True,
                                           dae_depth=3, augment=augment, corruption_impl="kernel")
    frozen = _clone(fcn0)

    def dae_train():
        rand = draw_dae_randomness(gen, batch=batch, hw=(h, w), crop=crop_hw, p_gt=1.0)
        return dae_step(dae, frozen, images, labels, rand)

    def dae_flops():
        rand = draw_dae_randomness(gen, batch=batch, hw=(h, w), crop=crop_hw, p_gt=1.0)
        x, y = dae_step.stages.prepare(images, labels, rand)
        _, taps = dae_step.stages.features(frozen, x)  # the FCN through pool4: the gt regime reads no probs
        y_tilde = torch.empty((*y.shape, cfg.n_classes), device=x.device)  # K1's: no matmul or convolution
        dae_step.stages.loss(dae, y_tilde, taps, y)[0].backward()

    cells.append(Cell("DAE(stem1,d3)", dae_train, dae_flops))
    return cells


def count_flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def flops_per_image(args, *, device="meta", params=None) -> dict[str, float]:
    """``{"<label>|<crop>|aug=<0|1>": FLOPs an image}`` for every cell of the
    sweep: one step's count at ``FLOPS_PROBE_BATCH`` images, divided by
    it. ``device`` 'meta' counts from the shapes alone (``params``, when
    given, are taken there)."""
    if params is None:
        params = flagship_params(device)
    elif device == "meta":
        params = tuple({k: {kk: t.to("meta") for kk, t in v.items()} for k, v in tree.items()} for tree in params)
    out = {}
    for crop in args.crops:
        for augment in augment_settings(args):
            for cell in make_cells(args, FLOPS_PROBE_BATCH, crop, augment, device, params=params):
                out[f"{cell.label}|{crop}|aug={int(augment)}"] = count_flops(cell.flops_step) / FLOPS_PROBE_BATCH
    return out


def metric(args, label: str, crop: int, batch: int, augment: bool) -> str:
    return (f"train images/sec/chip ({label}, crop {crop}, {args.dtype}, batch={batch}, augment={augment}"
            + (", donate" if args.donate else "") + (", remat" if args.remat else "") + ")")


def oom_line(args, crop: int, batch: int, augment: bool) -> dict:
    return {"metric": f"train OOM (crop {crop}, {args.dtype}, batch={batch}, augment={augment}, remat={args.remat})",
            "value": None, "unit": "images/sec/chip", "oom": True}


def record(args, rec: dict, device) -> None:
    rec["device"] = device_stamp(device)
    print(json.dumps(rec), flush=True)
    if not args.no_history:
        append_history(HISTORY, rec)


def timed(args, cell: Cell, batch: int, crop: int, augment: bool, flops: dict, device) -> dict:
    ms, _ = chained_ms(cell.step, args.iters, device=device, warmup=1)
    rec = {"metric": metric(args, cell.label, crop, batch, augment), "value": round(batch * 1e3 / ms, 2),
           "unit": "images/sec/chip", "ms_per_img": round(ms / batch, 4)}
    key = f"{cell.label}|{crop}|aug={int(augment)}"
    if key in flops:
        rec["gflops_per_img"] = round(flops[key] / 1e9, 2)
        rec["mfu_pct"] = round(100.0 * flops[key] * batch / (ms * 1e-3 * PEAK_FLOPS[args.dtype]), 1)
    return rec


def _isolated(args, argv: list[str]) -> int:
    """Each (batch, crop, augment) cell in a process of its own, the FLOPs
    counted once here and handed down."""
    env = dict(os.environ)
    if not args.no_flops:
        env[FLOPS_ENV] = json.dumps(flops_per_image(args))
    keep = [a for a in argv if a != "--isolate"]
    for crop in args.crops:
        for augment in augment_settings(args):
            for batch in args.batches:
                cmd = [sys.executable, "-m", __spec__.name, *keep, "--batches", str(batch), "--crops", str(crop),
                       "--augment", "on" if augment else "off"]
                r = subprocess.run(cmd, env=env, timeout=3600)
                if r.returncode:
                    print(json.dumps({"metric": f"cell FAILED (crop {crop}, batch={batch}, augment={augment}, "
                                                f"remat={args.remat})", "value": None, "rc": r.returncode}),
                          flush=True)
    return 0


def main(argv=None, *, params=None) -> int:
    """``params``: ``(fcn, dae)`` to train in place of the seeded full-width
    ones (the tests hand small ones in)."""
    from iterative_inference_segm_tpu_torch.scripts._parallel import check_device

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    if args.isolate:
        return _isolated(args, argv)
    flops = json.loads(os.environ.get(FLOPS_ENV, "{}"))
    if not flops and not args.no_flops:
        flops = flops_per_image(args, params=params)
    for crop in args.crops:
        for augment in augment_settings(args):
            for batch in args.batches:
                try:
                    # an OOM can fire while a cell's inputs and params are placed, not only in its step
                    for cell in make_cells(args, batch, crop, augment, device, params=params):
                        record(args, timed(args, cell, batch, crop, augment, flops, device), device)
                except torch.cuda.OutOfMemoryError:
                    # the memory boundary is itself a measurement: record it and keep sweeping
                    torch.cuda.empty_cache()
                    record(args, oom_line(args, crop, batch, augment), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
