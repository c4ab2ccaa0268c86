"""Synthetic CamVid-like data: structured random scenes + consistent labels.

A jax-free copy of ``iterative_inference_segm_tpu.data.synthetic``: the same
numpy draws in the same order, so the same seed gives the same arrays in
both packages (``tests/test_torch_train.py`` checks it). Labels are a
function of the image content (piecewise constant colour regions), so
training on them measurably reduces loss.
"""

from __future__ import annotations

import numpy as np

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID, DatasetConfig


def synthetic_example(
    rng: np.random.Generator,
    cfg: DatasetConfig = CAMVID,
    *,
    height: int | None = None,
    width: int | None = None,
    void_fraction: float = 0.02,
) -> tuple[np.ndarray, np.ndarray]:
    """One (image f32 [0,1], labels int32) pair with blocky class regions:
    a horizon split plus a few random rectangles, each region a class with a
    class-specific base colour + noise."""
    h = height or cfg.height
    w = width or cfg.width
    c = cfg.in_channels
    n = cfg.n_classes

    # class -> base color, fixed across the dataset (seeded by class index)
    base = (np.linspace(0.05, 0.95, n)[:, None] * np.ones((n, c))).astype(np.float32)
    for ci in range(n):
        color_rng = np.random.default_rng(1000 + ci)
        base[ci] = np.clip(base[ci] + color_rng.normal(0, 0.18, size=c), 0.0, 1.0)

    labels = np.zeros((h, w), dtype=np.int32)
    horizon = int(rng.integers(h // 4, 3 * h // 4))
    labels[:horizon] = int(rng.integers(0, n))
    labels[horizon:] = int(rng.integers(0, n))
    for _ in range(int(rng.integers(3, 8))):
        cls = int(rng.integers(0, n))
        rh = int(rng.integers(h // 8, h // 2))
        rw = int(rng.integers(w // 8, w // 2))
        ry = int(rng.integers(0, h - rh))
        rx = int(rng.integers(0, w - rw))
        labels[ry : ry + rh, rx : rx + rw] = cls

    image = base[labels] + rng.normal(0, 0.05, size=(h, w, c)).astype(np.float32)
    image = np.clip(image, 0.0, 1.0).astype(np.float32)

    if void_fraction > 0:
        mask = rng.random((h, w)) < void_fraction
        labels = np.where(mask, cfg.void_label, labels)
    return image, labels.astype(np.int32)


def synthetic_batches(
    *,
    cfg: DatasetConfig = CAMVID,
    batch_size: int = 4,
    num_batches: int = 8,
    height: int | None = None,
    width: int | None = None,
    seed: int = 0,
):
    """Yield (images (B,H,W,C) f32, labels (B,H,W) i32) numpy batches."""
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        imgs, labs = zip(
            *(
                synthetic_example(rng, cfg, height=height, width=width)
                for _ in range(batch_size)
            )
        )
        yield np.stack(imgs), np.stack(labs)
