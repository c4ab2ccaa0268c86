"""Preprocessing on the device: normalize, random crop, horizontal flip.

Port of ``iterative_inference_segm_tpu.data.pipeline``. The crop is split
in two: ``crop_and_flip`` takes explicit per-sample offsets and flip bits
(so a test can feed both packages the same ones), and
``random_crop_and_flip`` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from iterative_inference_segm_tpu_torch.data.config_datasets import DatasetConfig


def normalize_image(
    x: torch.Tensor, cfg: DatasetConfig, *, input_scale: float = 1.0
) -> torch.Tensor:
    """(x/input_scale - mean) / std with per-dataset statistics; any float
    dtype in, f32 out. ``input_scale`` declares the input encoding: 1.0 for
    [0,1] floats, 255.0 for byte-range input (never inferred from content)."""
    x = x.to(torch.float32)
    if input_scale != 1.0:
        x = x / input_scale
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def crop_and_flip(
    images: torch.Tensor,
    labels: torch.Tensor,
    oy: torch.Tensor,
    ox: torch.Tensor,
    flip: torch.Tensor,
    *,
    crop: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample crop at (oy[i], ox[i]) of size ``crop``, then a horizontal
    flip where ``flip[i]``. images (B, H, W, C), labels (B, H, W); oy, ox
    int (B,), flip bool (B,). Selects the same elements as the JAX
    package's crop-then-flip (rows, then columns with the flip folded into
    the column indices)."""
    ch, cw = crop
    dev = images.device
    oy, ox, flip = oy.to(dev), ox.to(dev), flip.to(device=dev, dtype=torch.bool)
    rows = oy[:, None] + torch.arange(ch, device=dev)
    cols = ox[:, None] + torch.arange(cw, device=dev)
    cols = torch.where(flip[:, None], cols.flip(1), cols)
    bidx = torch.arange(images.shape[0], device=dev)[:, None, None]
    img = images[bidx, rows[:, :, None], cols[:, None, :]]
    lab = labels[bidx, rows[:, :, None], cols[:, None, :]]
    return img, lab


def draw_crop_and_flip(
    generator: torch.Generator, batch: int, hw: tuple[int, int], crop: tuple[int, int]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform offsets in [0, H - ch] x [0, W - cw] and fair flip bits, one
    per sample, drawn on the generator's device."""
    (h, w), (ch, cw) = hw, crop
    if ch > h or cw > w:
        raise ValueError(f"crop {crop} larger than the frame {hw}")
    oy = torch.randint(0, h - ch + 1, (batch,), generator=generator)
    ox = torch.randint(0, w - cw + 1, (batch,), generator=generator)
    flip = torch.randint(0, 2, (batch,), generator=generator).bool()
    return oy, ox, flip


def random_crop_and_flip(
    generator: torch.Generator,
    images: torch.Tensor,
    labels: torch.Tensor,
    *,
    crop: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Random crop + horizontal flip per sample, offsets and flips drawn
    from ``generator`` (the JAX version draws them from a key)."""
    b, h, w = (int(s) for s in labels.shape)
    oy, ox, flip = draw_crop_and_flip(generator, b, (h, w), crop)
    return crop_and_flip(images, labels, oy, ox, flip, crop=crop)


def eval_preprocess(image: torch.Tensor, cfg: DatasetConfig) -> torch.Tensor:
    """Full-resolution eval path: normalization only (no crop)."""
    return normalize_image(image, cfg)
