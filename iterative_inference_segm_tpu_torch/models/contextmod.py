"""Dilated-convolution context module (port of
``iterative_inference_segm_tpu.models.contextmod``).

A Yu & Koltun (2016) context module on the corrupted probability map at
full resolution: seven 3x3 convs + ReLU with dilations (1, 1, 2, 4, 8, 16,
1), then a 1x1 projection back to ``n_classes``, run in f32 even under bf16
compute. It conditions at input scale only (the ``input`` tap).
``contextmod_logits`` stops before the softmax (the refinement engines hand
the logits to the tail kernel); ``contextmod_apply`` takes it.
"""

from __future__ import annotations

from typing import Mapping

import torch

from iterative_inference_segm_tpu_torch.ops.conv import conv2d, init_conv

_DILATIONS = (1, 1, 2, 4, 8, 16, 1)


def init_contextmod(
    generator: torch.Generator,
    *,
    n_classes: int = 11,
    width_mult: int = 2,
    h_channels: int = 0,
    dtype=torch.float32,
    device: torch.device | str = "cpu",
) -> dict:
    """Random context-module params; ``h_channels`` > 0 conditions on a tap
    at input size, concatenated to the map."""
    kw = {"dtype": dtype, "device": device}
    params: dict = {}
    width = n_classes * width_mult
    cin = n_classes + h_channels
    for i in range(len(_DILATIONS)):
        params[f"ctx{i + 1}"] = init_conv(generator, 3, 3, cin, width, scale="he", **kw)
        cin = width
    params["out"] = init_conv(generator, 1, 1, width, n_classes, **kw)
    return params


def contextmod_logits(
    params: dict,
    y: torch.Tensor,
    h: Mapping[str, torch.Tensor] | None = None,
    *,
    compute_dtype=torch.float32,
    space=None,
) -> torch.Tensor:
    """(B, H, W, C) probs (+ taps at input size) -> f32 logits (B, H, W, C).
    ``space``: the layout of an H-sharded ``y`` (and of its taps)."""
    x = y.to(compute_dtype)
    for v in (h or {}).values():
        if tuple(v.shape[1:3]) != tuple(x.shape[1:3]):
            raise ValueError(
                f"contextmod conditioning must be at input scale; got {tuple(v.shape[1:3])} vs "
                f"{tuple(x.shape[1:3])}"
            )
        x = torch.cat([x, v.to(x.dtype)], dim=-1)
    for i, d in enumerate(_DILATIONS):
        p = params[f"ctx{i + 1}"]
        x = torch.relu(conv2d(x, p["w"], p["b"], padding="SAME", dilation=d, space=space))
    p = params["out"]
    return conv2d(x.float(), p["w"].float(), p["b"].float(), padding="SAME", space=space)


def contextmod_apply(
    params: dict,
    y: torch.Tensor,
    h: Mapping[str, torch.Tensor] | None = None,
    *,
    compute_dtype=torch.float32,
    space=None,
) -> torch.Tensor:
    """Context-module forward: (B, H, W, C) probs -> f32 denoised probs.
    ``space`` as in ``contextmod_logits``."""
    return torch.softmax(contextmod_logits(params, y, h, compute_dtype=compute_dtype, space=space), dim=-1)
