"""Per-dataset constants the serving path needs (class count, void label,
normalization statistics, input channels).

A copy of the serving fields of ``iterative_inference_segm_tpu.data.
config_datasets`` (the port may not import the JAX package); the values must
stay equal — ``tests/test_torch_flagship.py`` checks them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DatasetConfig:
    name: str
    n_classes: int  # non-void classes
    void_label: int  # label value marking void (== n_classes by convention)
    in_channels: int
    mean: tuple[float, ...]
    std: tuple[float, ...]


# CamVid: 11 semantic classes + void, 360x480 road scenes.
CAMVID = DatasetConfig(
    name="camvid",
    n_classes=11,
    void_label=11,
    in_channels=3,
    mean=(0.39068785, 0.40521392, 0.41434407),
    std=(0.29652068, 0.30514979, 0.30080369),
)
