"""Colorized segmentation dumps.

A jax-free copy of ``iterative_inference_segm_tpu.utils.colorize``, with the
per-dataset palettes of ``data/config_datasets.py``. Pillow is imported only
to write a PNG: without it, ``save_label_png`` raises an ``ImportError``
naming it and ``--dump-dir``.
"""

from __future__ import annotations

import os

import numpy as np

from iterative_inference_segm_tpu_torch.data.config_datasets import DatasetConfig


def colorize_labels(labels: np.ndarray, cfg: DatasetConfig) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) uint8 using the dataset palette.
    Out-of-range labels (void) take the last palette entry."""
    labels = np.asarray(labels)
    idx = np.clip(labels, 0, len(cfg.palette) - 1)
    return cfg.palette[idx]


def save_label_png(path: str | os.PathLike, labels: np.ndarray, cfg: DatasetConfig) -> None:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("writing PNG dumps (--dump-dir) needs Pillow, which is not installed") from e

    Image.fromarray(colorize_labels(labels, cfg)).save(path)
