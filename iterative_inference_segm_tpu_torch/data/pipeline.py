"""Input preprocessing for serving (``normalize_image``)."""

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
