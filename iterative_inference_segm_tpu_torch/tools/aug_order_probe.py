"""What the augmentation's order and form cost the whole FCN-8 train step
at large batch: the twin of the repo's ``tools/aug_order_probe.py`` on the
card.

FCN-8 / VGG16 fc 4096, C = 11, bf16 compute, Adam 1e-3 with the coupled L2
of ``train.loop.make_optimizer``, at ``--batch`` (128) and ``--crop``
(128) out of 360x480 frames (f32 images uniform in [0, 1), labels uniform
over the classes, from ``numpy.random.default_rng(0)``). One call is one
step: the augmentation, the forward (``models.fcn8.fcn8_logits``, dropout
keep-masks drawn on the device from a generator), ``ops.losses.
masked_crossentropy``, the backward and Adam; the params move in place.
Each augmenting step draws its offsets and flips on the device from one
generator, the same draws for every cell. The JAX probe's cells, with its
labels:

  (a) normalize the full frame, then the per-sample crop and flip;
  (b) the per-sample crop and flip, then normalize the crop;
  (c) the crop first, as one 2-D gather with the flip folded into the
      column indices (the port's ``data.pipeline.crop_and_flip``, which
      its trainer ships);
  (d) the crop first, as two gathers, rows then columns, the flip folded;
  (e) pre-cropped inputs, normalized in the step: the floor.

The vmapped ``dynamic_slice`` of (a) and (b) has no batched PyTorch form:
it is one slice a sample, its offsets copied to the host once a step
(``crop_dynslice``), and those rows include that copy and the B slices'
launches. Before timing, the cropped and normalized batches of (a)-(d) are
asserted bit-equal on the same draws (``check`` lines; the JAX probe
claims it). Each row's scalar is the JAX row's: the loss; each line also
carries ``images_per_sec``. Timing and lines as ``tools/perf_probe.py``,
with autograd on.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.aug_order_probe [--batch 128] [--crop 128]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, probe_parser

FC_CHANNELS = 4096


def parse_args(argv=None):
    p = probe_parser(__doc__, iters=10, repeats=3)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--crop", type=int, default=128)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=480)
    return p.parse_args(argv)


def crop_dynslice(image, labels, oy, ox, flip, ch, cw):
    """Per-sample slices (the vmapped ``dynamic_slice``; offsets copied to
    the host), then the flip where a sample's bit is set."""
    from iterative_inference_segm_tpu_torch.tools.aug_probe import slice_crop

    img, lab = slice_crop(image, labels, oy, ox, (ch, cw))
    fl = flip.to(img.device)
    return (torch.where(fl[:, None, None, None], img.flip(2), img),
            torch.where(fl[:, None, None], lab.flip(2), lab))


def crop_gather2d(image, labels, oy, ox, flip, ch, cw):
    """One 2-D advanced-index gather, the flip folded into the columns (the
    port's shipped crop)."""
    from iterative_inference_segm_tpu_torch.data.pipeline import crop_and_flip

    return crop_and_flip(image, labels, oy, ox, flip, crop=(ch, cw))


def crop_separable(image, labels, oy, ox, flip, ch, cw):
    """Rows, then columns, each a ``take_along_dim``, the flip folded into
    the columns."""
    from iterative_inference_segm_tpu_torch.tools.aug_probe import aug_gather2

    return aug_gather2(image, labels, oy, ox, flip, (ch, cw))


def prepare(cfg, images, labels, offsets, *, order: str, crop_impl, crop: tuple[int, int]):
    """The step's input: ``order`` 'norm_first' | 'crop_first' | 'none'
    (pre-cropped)."""
    from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image

    if order == "none":
        return normalize_image(images, cfg), labels
    if order == "norm_first":
        return crop_impl(normalize_image(images, cfg), labels, *offsets, *crop)
    images, labels = crop_impl(images, labels, *offsets, *crop)
    return normalize_image(images, cfg), labels


def make_step(cfg, params: dict, opt, *, order: str, crop_impl, compute_dtype=torch.bfloat16):
    """``step(images, labels, offsets, dropout) -> loss``: one FCN-8 train
    step, as ``train.train_fcn8``'s (``offsets`` (oy, ox, flip), None for
    'none'; ``dropout`` a generator or the two keep-masks)."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_logits
    from iterative_inference_segm_tpu_torch.ops.losses import masked_crossentropy

    def step(images, labels, offsets, dropout):
        x, y = prepare(cfg, images, labels, offsets, order=order, crop_impl=crop_impl, crop=cfg.train_crop)
        opt.zero_grad(set_to_none=True)
        loss = masked_crossentropy(fcn8_logits(params, x, dropout=dropout, compute_dtype=compute_dtype), y,
                                   n_classes=cfg.n_classes)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


CELLS = (
    ("(a) normalize-full -> dynslice crop (shipped)", "norm_first", crop_dynslice),
    ("(b) dynslice crop -> normalize crop", "crop_first", crop_dynslice),
    ("(c) 2-D gather crop, folded flip", "crop_first", crop_gather2d),
    ("(d) separable take_along_axis, folded flip", "crop_first", crop_separable),
    ("(e) pre-cropped floor", "none", None),
)


def cases(cfg, params, opt, full, cropped, gen: torch.Generator, *, compute_dtype=torch.bfloat16):
    """``[(label, fn)]`` of the five cells; ``full`` and ``cropped`` the
    (images, labels) frames and their pre-cropped corners; each augmenting
    call draws its offsets from ``gen``; ``fn()`` returns the loss."""
    from iterative_inference_segm_tpu_torch.tools.aug_probe import draws

    b, h, w = (int(s) for s in full[1].shape)

    def cell(order, impl):
        step = make_step(cfg, params, opt, order=order, crop_impl=impl, compute_dtype=compute_dtype)
        if order == "none":
            return lambda: (step(*cropped, None, gen),)
        return lambda: (step(*full, draws(gen, b, h, w, cfg.train_crop), gen),)

    return [(label, cell(order, impl)) for label, order, impl in CELLS]


def batch_errors(cfg, full, offsets) -> dict:
    """(b)-(d)'s prepared batch against (a)'s on the same draws: the
    largest difference of the images or the labels (0 when bit-equal)."""
    out = {}
    ref = None
    for label, order, impl in CELLS[:4]:
        x, y = prepare(cfg, *full, offsets, order=order, crop_impl=impl, crop=cfg.train_crop)
        if ref is None:
            ref = (x, y)
            continue
        out[label] = max((x - ref[0]).abs().max().item(), (y - ref[1]).abs().max().item())
    return out


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    from iterative_inference_segm_tpu_torch.tools.aug_probe import draws
    from iterative_inference_segm_tpu_torch.tools.train_itemize_probe import first_entry
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer

    args = parse_args(argv)
    run = ProbeRun("aug_order_probe", args)
    dev, b, crop = run.device, args.batch, args.crop
    cfg = dataclasses.replace(CAMVID, train_crop=(crop, crop))
    tcfg = TrainConfig(learning_rate=1e-3, compute_dtype=torch.bfloat16)
    params = init_fcn8(torch.Generator().manual_seed(0), n_classes=cfg.n_classes, fc_channels=FC_CHANNELS, device=dev)
    opt = make_optimizer(tcfg, params)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((b, args.height, args.width, 3), np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes, (b, args.height, args.width)).astype(np.int32)).to(dev)
    full, cropped = (images, labels), (images[:, :crop, :crop].contiguous(), labels[:, :crop, :crop].contiguous())
    gen = torch.Generator(dev).manual_seed(1)
    with torch.no_grad():
        for label, err in batch_errors(cfg, full, draws(gen, b, args.height, args.width, cfg.train_crop)).items():
            run.check(f"{label[:3]} batch == (a)'s", err, 0.0)
    for label, fn in cases(cfg, params, opt, full, cropped, gen, compute_dtype=tcfg.compute_dtype):
        run.time(label, fn, b, first_entry, rates=lambda ms: {"images_per_sec": b * 1e3 / ms})
    return 0


if __name__ == "__main__":
    sys.exit(main())
