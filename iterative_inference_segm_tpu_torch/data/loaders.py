"""Unified on-disk dataset loading across CamVid / EM / Polyps.

A jax-free copy of ``iterative_inference_segm_tpu.data.loaders``: the same
layouts, the same decode and resize (Pillow's bilinear for images, nearest
for label maps), so the same files give the same arrays in both packages
(``tests/test_torch_data.py`` checks it). ``load_dataset_split`` is the entry
the CLIs route ``--dataset X --data-root R`` through; each dataset family
keeps its own module (``camvid``, ``em``, ``polyps``) for layout specifics.

All loaders return ``(images f32 [0,1] NHWC, labels i32 BHW)`` resized to the
dataset's canonical (cfg.height, cfg.width). Pillow is imported only when a
file is decoded: without it, a loader raises an ``ImportError`` naming it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable

import numpy as np

from iterative_inference_segm_tpu_torch.data.config_datasets import DatasetConfig

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")

# split-name aliases seen across public distributions
_SPLIT_ALIASES = {
    "train": ("train", "training"),
    "val": ("val", "valid", "validation"),
    "test": ("test", "testing"),
}


def pil_image():
    """``PIL.Image``, or an ImportError that says what needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding image files (--data-root, scripts/pack_dataset.py --from-dir) needs Pillow, "
            "which is not installed; the packed path (--packed) and --synthetic do not"
        ) from e
    return Image


def _list_images(d: Path) -> list[Path]:
    return sorted(p for p in d.iterdir() if p.suffix.lower() in _IMG_EXTS)


def _imread(path: Path, *, grayscale: bool = False) -> np.ndarray:
    img = pil_image().open(path)
    if grayscale:
        img = img.convert("L")
    return np.asarray(img)


def _resize(arr: np.ndarray, h: int, w: int, *, nearest: bool) -> np.ndarray:
    if arr.shape[0] == h and arr.shape[1] == w:
        return arr
    Image = pil_image()
    mode = Image.NEAREST if nearest else Image.BILINEAR
    if arr.ndim == 3 and arr.shape[2] in (3, 4) and arr.dtype == np.uint8:
        # Pillow resizes RGB/RGBA uint8 natively: one resize, no per-channel loop
        return np.asarray(Image.fromarray(arr).resize((w, h), mode))
    if arr.ndim == 3:
        chans = [
            np.asarray(Image.fromarray(arr[..., c]).resize((w, h), mode))
            for c in range(arr.shape[2])
        ]
        return np.stack(chans, axis=-1)
    return np.asarray(Image.fromarray(arr).resize((w, h), mode))


def _find_split_dir(root: Path, split: str) -> Path | None:
    for alias in _SPLIT_ALIASES.get(split, (split,)):
        if (root / alias).is_dir():
            return root / alias
    return None


def load_image_label_dir(
    root: str | os.PathLike,
    split: str,
    cfg: DatasetConfig,
    *,
    label_transform: Callable[[np.ndarray], np.ndarray] | None = None,
    grayscale: bool = False,
    image_subdirs: tuple[str, ...] = ("images", "image", "imgs"),
    label_subdirs: tuple[str, ...] = ("labels", "masks", "annot"),
) -> tuple[np.ndarray, np.ndarray]:
    """Generic ``<root>/<split>/{images,labels}`` loader with layout fallbacks.

    Accepted layouts (first match wins):
      1. ``<root>/<split>/<image_subdir>/*`` + ``<root>/<split>/<label_subdir>/*``
      2. CamVid-style flat split dirs: ``<root>/<split>/*`` + ``<root>/<split>annot/*``

    Images and labels pair by sorted filename order (names need not be equal
    across the two directories); counts must match.
    """
    root = Path(root)
    split_dir = _find_split_dir(root, split)

    img_dir = lab_dir = None
    if split_dir is not None:
        for sub in image_subdirs:
            if (split_dir / sub).is_dir():
                img_dir = split_dir / sub
                break
        for sub in label_subdirs:
            if (split_dir / sub).is_dir():
                lab_dir = split_dir / sub
                break
        if img_dir is None and (root / f"{split_dir.name}annot").is_dir():
            img_dir, lab_dir = split_dir, root / f"{split_dir.name}annot"
    if img_dir is None or lab_dir is None:
        raise FileNotFoundError(
            f"no {split!r} split with images+labels under {root} "
            f"(looked for <split>/{image_subdirs} + <split>/{label_subdirs} "
            f"and CamVid-style <split> + <split>annot)"
        )

    img_paths = _list_images(img_dir)
    lab_paths = _list_images(lab_dir)
    if not img_paths:
        raise FileNotFoundError(f"no images in {img_dir}")
    if len(img_paths) != len(lab_paths):
        raise ValueError(
            f"{img_dir} has {len(img_paths)} images but {lab_dir} has "
            f"{len(lab_paths)} labels"
        )

    imgs, labs = [], []
    for ip, lp in zip(img_paths, lab_paths):
        img = _imread(ip, grayscale=grayscale)
        if img.ndim == 2:
            img = img[..., None]
        img = _resize(img, cfg.height, cfg.width, nearest=False)
        if img.ndim == 2:
            img = img[..., None]
        lab = _imread(lp, grayscale=True)
        lab = _resize(lab, cfg.height, cfg.width, nearest=True).astype(np.int32)
        if label_transform is not None:
            lab = label_transform(lab)
        imgs.append(img.astype(np.float32) / 255.0)
        labs.append(lab.astype(np.int32))
    return np.stack(imgs), np.stack(labs)


def load_dataset_split(
    dataset: str,
    root: str | os.PathLike,
    split: str,
    cfg: DatasetConfig,
) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch to the dataset family's loader by name (camvid/em/polyps)."""
    if dataset == "camvid":
        from iterative_inference_segm_tpu_torch.data.camvid import load_split

        return load_split(root, split, cfg)
    if dataset == "em":
        from iterative_inference_segm_tpu_torch.data.em import load_split

        return load_split(root, split, cfg)
    if dataset == "polyps":
        from iterative_inference_segm_tpu_torch.data.polyps import load_split

        return load_split(root, split, cfg)
    raise ValueError(f"unknown dataset {dataset!r}; expected camvid/em/polyps")


def epoch_reshuffled(make_batches, base_seed: int):
    """Wrap a seeded batch-iterator factory so every call (= every epoch)
    draws a fresh shuffle order: call N passes ``seed = base_seed + N``.
    Used by the training CLIs' disk branches; deterministic given
    ``base_seed``."""
    counter = {"n": 0}

    def data():
        counter["n"] += 1
        return make_batches(seed=base_seed + counter["n"])

    return data
