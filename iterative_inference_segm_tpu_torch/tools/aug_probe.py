"""The training augmentation alone (random crop + horizontal flip) in four
forms that select the same pixels: the twin of the repo's
``tools/aug_probe.py`` on the card.

Batch 64, 360x480 frames (f32 images uniform in [0, 1), labels uniform
over 11 classes, from ``numpy.random.default_rng(0)``), cut to each of
``--crops`` (224 and 128). Each call draws its offsets and flips on the
device (``draws``: uniform offsets, fair flips), and every form takes the
same draws. The JAX probe's four rows, with its labels:

  A. the shipped form: the port's ``data.pipeline.crop_and_flip``, a 2-D
     gather with the flip folded into the column indices (the JAX label
     names the vmapped ``dynamic_slice`` the JAX package once shipped);
  B. two gathers, rows then columns (``take_along_dim``), the flip folded
     into the column indices;
  C. the crop as two batched one-hot matmuls (rows, then columns with the
     flip folded in); the labels through B's gathers. It runs in f32 with
     TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``), where a
     one-hot product selects its pixel exactly;
  D. per-sample slices for the crop (the vmapped ``dynamic_slice`` has no
     batched PyTorch form: the offsets go to the host once a call, and the
     row includes that copy and the B slices), then the flip as a column
     gather of the cropped batch.

Before timing, B and D are asserted bit-equal to A on the same draws (the
JAX probe exits otherwise), and C's equality is printed, not asserted, as
the JAX probe prints it (``check`` lines, C's with ``"asserted": false``).
Each row's scalar is the JAX row's: the f32 sum of the images and the
labels. Each line carries its ``crop``. Timing and lines as
``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.aug_probe [--batch 64] [--crops 224,128]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, probe_parser

N_CLASSES = 11


def parse_args(argv=None):
    p = probe_parser(__doc__, iters=30, repeats=3)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--crops", type=str, default="224,128")
    return p.parse_args(argv)


def draws(gen: torch.Generator, b: int, h: int, w: int, crop: tuple[int, int]):
    """(oy, ox, flip) on the generator's device: uniform offsets in [0, H -
    ch] x [0, W - cw] and fair flips, one each a sample."""
    ch, cw = crop
    dev = gen.device
    oy = torch.randint(0, h - ch + 1, (b,), generator=gen, device=dev)
    ox = torch.randint(0, w - cw + 1, (b,), generator=gen, device=dev)
    flip = torch.randint(0, 2, (b,), generator=gen, device=dev).bool()
    return oy, ox, flip


def _col_indices(ox: torch.Tensor, flip: torch.Tensor, cw: int) -> torch.Tensor:
    """The columns a sample's crop reads, the flip folded in: a flipped
    [ox, ox + cw) crop reads ox + cw - 1 - j."""
    j = torch.arange(cw, device=ox.device)
    return ox[:, None] + torch.where(flip[:, None], cw - 1 - j, j)


def aug_current(image, labels, oy, ox, flip, crop):
    from iterative_inference_segm_tpu_torch.data.pipeline import crop_and_flip

    return crop_and_flip(image, labels, oy, ox, flip, crop=crop)


def aug_gather2(image, labels, oy, ox, flip, crop):
    ch, cw = crop
    rows = oy[:, None] + torch.arange(ch, device=oy.device)
    cols = _col_indices(ox, flip, cw)
    img = torch.take_along_dim(image, rows[:, :, None, None], dim=1)
    img = torch.take_along_dim(img, cols[:, None, :, None], dim=2)
    lab = torch.take_along_dim(labels, rows[:, :, None], dim=1)
    lab = torch.take_along_dim(lab, cols[:, None, :], dim=2)
    return img, lab


def aug_onehot(image, labels, oy, ox, flip, crop):
    ch, cw = crop
    _, h, w, _ = image.shape
    rows = oy[:, None] + torch.arange(ch, device=oy.device)
    cols = _col_indices(ox, flip, cw)
    r = torch.nn.functional.one_hot(rows, h).to(image.dtype)  # (B, ch, H)
    c = torch.nn.functional.one_hot(cols, w).to(image.dtype)  # (B, cw, W)
    img = torch.einsum("bih,bhwc->biwc", r, image)
    img = torch.einsum("bjw,biwc->bijc", c, img)
    lab = torch.take_along_dim(labels, rows[:, :, None], dim=1)
    lab = torch.take_along_dim(lab, cols[:, None, :], dim=2)
    return img, lab


def slice_crop(image, labels, oy, ox, crop):
    """The per-sample slices of the vmapped ``dynamic_slice``: the offsets
    copied to the host, then one slice a sample."""
    ch, cw = crop
    offs = torch.stack([oy, ox], 1).tolist()
    img = torch.stack([image[i, y:y + ch, x:x + cw] for i, (y, x) in enumerate(offs)])
    lab = torch.stack([labels[i, y:y + ch, x:x + cw] for i, (y, x) in enumerate(offs)])
    return img, lab


def aug_slice_fold(image, labels, oy, ox, flip, crop):
    _, cw = crop
    img, lab = slice_crop(image, labels, oy, ox, crop)
    j = torch.arange(cw, device=ox.device)
    cols = torch.where(flip[:, None], cw - 1 - j, j)
    img = torch.take_along_dim(img, cols[:, None, :, None], dim=2)
    lab = torch.take_along_dim(lab, cols[:, None, :], dim=2)
    return img, lab


VARIANTS = [
    ("A current (vmap dyn_slice + where-flip)", aug_current),
    ("B gather2 (take_along_axis, folded flip)", aug_gather2),
    ("C onehot-mxu (crop as 2 batched matmuls)", aug_onehot),
    ("D slice+fold (dyn_slice crop, gather flip)", aug_slice_fold),
]


def cases(image, labels, gen: torch.Generator, crop: tuple[int, int]):
    """``[(label, fn)]``: each form on fresh draws from ``gen``; ``fn()``
    returns the cropped images and labels."""
    b, h, w, _ = image.shape

    def row(fn):
        return lambda: fn(image, labels, *draws(gen, b, h, w, crop), crop)

    return [(label, row(fn)) for label, fn in VARIANTS]


def equality_errors(image, labels, oy, ox, flip, crop) -> dict:
    """Each of B, C, D against A on the same draws: the largest difference
    of the images or the labels (0 when bit-equal)."""
    ref_i, ref_l = aug_current(image, labels, oy, ox, flip, crop)
    out = {}
    for label, fn in VARIANTS[1:]:
        got_i, got_l = fn(image, labels, oy, ox, flip, crop)
        out[label.split()[0]] = max((got_i - ref_i).abs().max().item(), (got_l - ref_l).abs().max().item())
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    run = ProbeRun("aug_probe", args)
    dev, b = run.device, args.batch
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.random((b, args.height, args.width, 3), np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, N_CLASSES, (b, args.height, args.width)).astype(np.int32)).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False  # C's one-hot products in full f32
    with torch.inference_mode():
        for crop_s in args.crops.split(","):
            crop = (int(crop_s), int(crop_s))
            gen = torch.Generator(dev).manual_seed(7)
            errs = equality_errors(image, labels, *draws(gen, b, args.height, args.width, crop), crop)
            for name, err in errs.items():
                run.check(f"equality {name} (crop {crop[0]})", err, 0.0, asserted=name != "C")
            for label, fn in cases(image, labels, gen, crop):
                run.time(label, fn, b, rates=lambda ms, crop=crop: {"crop": crop[0]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
