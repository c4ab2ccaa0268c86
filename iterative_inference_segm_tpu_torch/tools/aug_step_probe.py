"""The FCN-8 train step as shipped, with the augmentation in another form,
and on pre-cropped inputs: the twin of the repo's ``tools/aug_step_probe.py``
on the card.

FCN-8 / VGG16 fc 4096, C = 11, bf16 compute, Adam 1e-3, at ``--batch``
(64) and ``--crop`` (128) out of 360x480 frames (f32 images uniform in
[0, 1), labels uniform over the classes, from ``numpy.random.
default_rng(0)``). Each call is one step of ``train.train_fcn8.
make_fcn8_train_step``, its randomness drawn by ``draw_step_randomness``
from one seeded generator, as the trainer draws it. The JAX probe's cells,
with its labels:

  (a) the step as shipped (``augment=True``: the port's crop is the 2-D
      gather of ``data.pipeline.crop_and_flip``);
  (b) the step with the crop replaced by the JAX probe's clone: the JAX
      package's crop now has no barrier, and the clone is the vmapped
      ``dynamic_slice`` form, here one slice a sample
      (``aug_order_probe.crop_dynslice``; the trainer draws the offsets on
      the host);
  (c) no augmentation, pre-cropped inputs: the floor.

(b) replaces ``train.train_fcn8``'s module-level ``crop_and_flip``, which
the step looks up at each call (PyTorch resolves the name when the step
runs, not when it is built): the replacement stays in place for the
cell's warm-up and timed calls and comes off in a ``finally``. A ``check``
line asserts that every call of (b) went through it. Each row's scalar is
the JAX row's: the loss; each line also carries ``images_per_sec``.
Timing and lines as ``tools/perf_probe.py``, with autograd on.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.aug_step_probe [--batch 64] [--crop 128]
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, probe_parser

FC_CHANNELS = 4096
HEIGHT, WIDTH = 360, 480


def parse_args(argv=None):
    p = probe_parser(__doc__, iters=10, repeats=3)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--crop", type=int, default=128)
    return p.parse_args(argv)


def no_barrier_crop_and_flip(images, labels, oy, ox, flip, *, crop):
    """The JAX probe's clone with ``crop_and_flip``'s signature: per-sample
    slices, then the flip where a sample's bit is set."""
    from iterative_inference_segm_tpu_torch.tools.aug_order_probe import crop_dynslice

    return crop_dynslice(images, labels, oy, ox, flip, *crop)


@contextlib.contextmanager
def patched_crop(fn):
    """``train.train_fcn8.crop_and_flip`` replaced by ``fn`` (counting its
    calls in the yielded list) until the block ends."""
    mod = importlib.import_module("iterative_inference_segm_tpu_torch.train.train_fcn8")
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    saved = mod.crop_and_flip
    mod.crop_and_flip = counted
    try:
        yield calls
    finally:
        mod.crop_and_flip = saved


def cases(cfg, tcfg, params, opt, full, cropped, gen: torch.Generator):
    """``[(label, fn, patch)]``: each cell's step (``fn()`` returns the
    loss) and the crop it must run under (None: as shipped)."""
    from iterative_inference_segm_tpu_torch.train.train_fcn8 import draw_step_randomness, make_fcn8_train_step

    dev = full[0].device

    def cell(augment):
        step, _ = make_fcn8_train_step(cfg, tcfg, opt, augment=augment, fc_channels=FC_CHANNELS)
        images, labels = full if augment else cropped
        hw = tuple(int(s) for s in images.shape[1:3])

        def fn():
            rand = draw_step_randomness(gen, batch=int(images.shape[0]), hw=hw,
                                        crop=cfg.train_crop if augment else None, device=dev)
            return (step(params, images, labels, rand),)
        return fn

    return [
        ("(a) augment, as shipped", cell(True), None),
        ("(b) augment, barrier stripped", cell(True), no_barrier_crop_and_flip),
        ("(c) no augment (pre-cropped floor)", cell(False), None),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    from iterative_inference_segm_tpu_torch.tools.train_itemize_probe import first_entry
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer

    args = parse_args(argv)
    run = ProbeRun("aug_step_probe", args)
    dev, b, crop = run.device, args.batch, args.crop
    cfg = dataclasses.replace(CAMVID, train_crop=(crop, crop))
    tcfg = TrainConfig(learning_rate=1e-3, compute_dtype=torch.bfloat16)
    params = init_fcn8(torch.Generator().manual_seed(0), n_classes=cfg.n_classes, fc_channels=FC_CHANNELS, device=dev)
    opt = make_optimizer(tcfg, params)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((b, HEIGHT, WIDTH, 3), np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes, (b, HEIGHT, WIDTH)).astype(np.int32)).to(dev)
    full, cropped = (images, labels), (images[:, :crop, :crop].contiguous(), labels[:, :crop, :crop].contiguous())
    gen = torch.Generator().manual_seed(1)
    for label, fn, patch in cases(cfg, tcfg, params, opt, full, cropped, gen):
        rates = {"rates": lambda ms: {"images_per_sec": b * 1e3 / ms}}
        if patch is None:
            run.time(label, fn, b, first_entry, **rates)
            continue
        with patched_crop(patch) as calls:
            run.time(label, fn, b, first_entry, **rates)
        missed = abs(1 + args.iters * args.repeats - len(calls))  # the warm-up call and the timed ones
        run.check(f"{label[:3]} calls not through the replaced crop", float(missed), 0.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
