"""On-disk CamVid loading with a background prefetcher.

A jax-free copy of ``iterative_inference_segm_tpu.data.camvid``:
``load_split`` reads a whole split into memory, ``iterate_split`` slices it
into minibatches on a daemon thread through a bounded queue, shuffling with
``np.random.default_rng(seed)`` exactly as the JAX package does, so a seed
gives the same batch order in both. Augmentation runs on the device
(``data/pipeline.py``).

Expected directory layout (standard CamVid splits)::

    <root>/train/*.png            images
    <root>/trainannot/*.png       integer label maps (palette-free PNGs)
    <root>/val, valannot, test, testannot likewise.

If the dataset is absent the loaders raise FileNotFoundError; tests and
benchmarks use data.synthetic instead.
"""

from __future__ import annotations

import os
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID, DatasetConfig
from iterative_inference_segm_tpu_torch.data.loaders import pil_image


def _imread(path: Path) -> np.ndarray:
    return np.asarray(pil_image().open(path))


def load_split(
    root: str | os.PathLike,
    split: str,
    cfg: DatasetConfig = CAMVID,
) -> tuple[np.ndarray, np.ndarray]:
    """Load an entire split into memory: (images f32 [0,1] NHWC, labels i32 BHW)."""
    root = Path(root)
    img_dir = root / split
    ann_dir = root / f"{split}annot"
    if not img_dir.is_dir() or not ann_dir.is_dir():
        raise FileNotFoundError(f"dataset split not found: {img_dir} / {ann_dir}")
    names = sorted(p.name for p in img_dir.glob("*.png"))
    if not names:
        raise FileNotFoundError(f"no .png files in {img_dir}")
    imgs, labs = [], []
    for n in names:
        img = _imread(img_dir / n).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
        lab = _imread(ann_dir / n).astype(np.int32)
        if lab.ndim == 3:
            lab = lab[..., 0]
        imgs.append(img)
        labs.append(lab)
    return np.stack(imgs), np.stack(labs)


def iterate_split(
    images: np.ndarray,
    labels: np.ndarray,
    *,
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    prefetch: int = 2,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Minibatch iterator with background prefetch (daemon thread + queue):
    one producer thread slices batches into a bounded queue while the
    consumer feeds the device."""
    n = images.shape[0]
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stops = range(0, n - batch_size + 1, batch_size) if drop_last else range(0, n, batch_size)
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    _END = object()

    def producer():
        for s in stops:
            idx = order[s : s + batch_size]
            q.put((images[idx], labels[idx]))
        q.put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
