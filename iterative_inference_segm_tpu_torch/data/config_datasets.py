"""Per-dataset constants: class count, void label, canonical frame size,
training crop, input channels, normalization statistics and class names.

A copy of the fields of ``iterative_inference_segm_tpu.data.config_datasets``
but the palettes (the port may not import the JAX package; the palettes are
visualization data). The values must stay equal —
``tests/test_torch_flagship.py`` checks them.
"""

from __future__ import annotations

from dataclasses import dataclass


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
)

DATASET_CONFIGS = {c.name: c for c in (CAMVID, EM, POLYPS)}
