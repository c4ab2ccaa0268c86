"""Per-dataset constants: class count, void label, canonical frame size,
training crop, input channels, normalization statistics, class names and
the palettes of the colorized dumps (``utils/colorize.py``).

A copy of ``iterative_inference_segm_tpu.data.config_datasets`` (the port
may not import the JAX package). The values must stay equal —
``tests/test_torch_flagship.py`` checks them, palettes included.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class DatasetConfig:
    name: str
    n_classes: int  # non-void classes
    void_label: int  # label value marking void (== n_classes by convention)
    height: int
    width: int
    in_channels: int
    train_crop: tuple[int, int]
    mean: tuple[float, ...]
    std: tuple[float, ...]
    class_names: tuple[str, ...]
    palette: np.ndarray = field(repr=False, compare=False, default=None)


# CamVid: 11 semantic classes + void, 360x480 road scenes.
CAMVID = DatasetConfig(
    name="camvid",
    n_classes=11,
    void_label=11,
    height=360,
    width=480,
    in_channels=3,
    train_crop=(224, 224),
    mean=(0.39068785, 0.40521392, 0.41434407),
    std=(0.29652068, 0.30514979, 0.30080369),
    class_names=(
        "sky", "building", "column_pole", "road", "sidewalk", "tree",
        "sign", "fence", "car", "pedestrian", "bicyclist",
    ),
    palette=np.array(
        [
            (128, 128, 128),  # sky
            (128, 0, 0),      # building
            (192, 192, 128),  # column_pole
            (128, 64, 128),   # road
            (0, 0, 192),      # sidewalk
            (128, 128, 0),    # tree
            (192, 128, 128),  # sign
            (64, 64, 128),    # fence
            (64, 0, 128),     # car
            (64, 64, 0),      # pedestrian
            (0, 128, 192),    # bicyclist
            (0, 0, 0),        # void
        ],
        dtype=np.uint8,
    ),
)

# EM membrane stacks (ISBI 2012-style): 2 classes, one input channel.
EM = DatasetConfig(
    name="em",
    n_classes=2,
    void_label=2,
    height=512,
    width=512,
    in_channels=1,
    train_crop=(256, 256),
    mean=(0.5,),
    std=(0.25,),
    class_names=("membrane", "non_membrane"),
    palette=np.array([(0, 0, 0), (255, 255, 255), (128, 128, 128)], dtype=np.uint8),
)

# CVC Polyps endoscopy: binary segmentation.
POLYPS = DatasetConfig(
    name="polyps",
    n_classes=2,
    void_label=2,
    height=384,
    width=288,
    in_channels=3,
    train_crop=(224, 224),
    mean=(0.5, 0.5, 0.5),
    std=(0.25, 0.25, 0.25),
    class_names=("background", "polyp"),
    palette=np.array([(0, 0, 0), (255, 0, 0), (128, 128, 128)], dtype=np.uint8),
)

DATASET_CONFIGS = {c.name: c for c in (CAMVID, EM, POLYPS)}
