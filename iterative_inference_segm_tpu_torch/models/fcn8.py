"""FCN-8: VGG16 fully-convolutional segmenter with skip fusions (port).

Port of ``iterative_inference_segm_tpu.models.fcn8``: the same topology,
parameter names and NHWC interface; parameters are a dict of dicts of
tensors in the layouts of ``ops/conv.py`` (OIHW convs, flipped (I, O, k, k)
transposed convs). 'SAME' convs, ceil-mode pools and centre crops align the
skip fusions exactly as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch

from iterative_inference_segm_tpu_torch.ops.conv import (
    conv2d,
    conv_transpose2d,
    crop_to,
    init_conv,
    init_conv_transpose_bilinear,
    max_pool,
)

# VGG16 convolutional topology: (name, kernel, out_channels); 'P' = 2x2 pool.
_VGG = [
    ("conv1_1", 3, 64), ("conv1_2", 3, 64), "P",
    ("conv2_1", 3, 128), ("conv2_2", 3, 128), "P",
    ("conv3_1", 3, 256), ("conv3_2", 3, 256), ("conv3_3", 3, 256), "P",
    ("conv4_1", 3, 512), ("conv4_2", 3, 512), ("conv4_3", 3, 512), "P",
    ("conv5_1", 3, 512), ("conv5_2", 3, 512), ("conv5_3", 3, 512), "P",
]

FCN8_FEATURES = ("input", "pool1", "pool2", "pool3", "pool4", "pool5", "fc7", "score", "probs")

FCN8_FEATURE_CHANNELS = {
    "pool1": 64,
    "pool2": 128,
    "pool3": 256,
    "pool4": 512,
    "pool5": 512,
    "fc7": 4096,
}


def init_fcn8(
    generator: torch.Generator,
    *,
    n_classes: int = 11,
    in_channels: int = 3,
    fc_channels: int = 4096,
    dtype=torch.float32,
    device: torch.device | str = "cpu",
) -> dict:
    """Random FCN-8 params (He-init VGG/fc, Glorot scores, bilinear deconvs)."""
    kw = {"dtype": dtype, "device": device}
    params: dict = {}
    cin = in_channels
    for item in _VGG:
        if item == "P":
            continue
        name, k, cout = item
        params[name] = init_conv(generator, k, k, cin, cout, scale="he", **kw)
        cin = cout
    params["fc6"] = init_conv(generator, 7, 7, 512, fc_channels, scale="he", **kw)
    params["fc7"] = init_conv(generator, 1, 1, fc_channels, fc_channels, scale="he", **kw)
    params["score_fr"] = init_conv(generator, 1, 1, fc_channels, n_classes, **kw)
    params["score_pool4"] = init_conv(generator, 1, 1, 512, n_classes, **kw)
    params["score_pool3"] = init_conv(generator, 1, 1, 256, n_classes, **kw)
    params["upscore2"] = init_conv_transpose_bilinear(4, n_classes, n_classes, **kw)
    params["upscore_pool4"] = init_conv_transpose_bilinear(4, n_classes, n_classes, **kw)
    params["upscore8"] = init_conv_transpose_bilinear(16, n_classes, n_classes, **kw)
    return params


def fcn8_apply(
    params: dict,
    x: torch.Tensor,
    *,
    return_features: Sequence[str] = (),
    generator: torch.Generator | None = None,
    dropout_rate: float = 0.5,
    compute_dtype=torch.float32,
    probs_dtype=torch.float32,
) -> tuple[torch.Tensor, dict]:
    """FCN-8 forward. ``x``: (B, H, W, in_channels) NHWC. Returns
    ``(probs, features)``: probs (B, H, W, C) at ``probs_dtype``, features
    the requested taps. Dropout after fc6/fc7 runs only when a
    ``generator`` is passed (training)."""
    pools, feats = fcn8_backbone(
        params, x, return_features=return_features, compute_dtype=compute_dtype
    )
    probs, head_feats = fcn8_head(
        params, pools, (int(x.shape[1]), int(x.shape[2])),
        return_features=return_features, generator=generator,
        dropout_rate=dropout_rate, probs_dtype=probs_dtype,
    )
    feats.update(head_feats)
    return probs, feats


def fcn8_backbone(
    params: dict,
    x: torch.Tensor,
    *,
    return_features: Sequence[str] = (),
    compute_dtype=torch.float32,
) -> tuple[dict, dict]:
    """The VGG16 stack through pool5. Returns ``(pools, feats)``: pool3/4/5
    for the head, and the requested backbone taps."""
    feats: dict = {}
    want = set(return_features)
    h = x.to(compute_dtype)
    if "input" in want:
        feats["input"] = h
    pools: dict = {}
    pool_idx = 0
    for item in _VGG:
        if item == "P":
            pool_idx += 1
            h = max_pool(h, window=2, stride=2, ceil_mode=True)
            name = f"pool{pool_idx}"
            pools[name] = h
            if name in want:
                feats[name] = h
            continue
        p = params[item[0]]
        h = torch.relu(conv2d(h, p["w"], p["b"], padding="SAME"))
    return {k: pools[k] for k in ("pool3", "pool4", "pool5")}, feats


def _dropout(h: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=generator.device) < keep
    return h * mask.to(device=h.device, dtype=h.dtype) / keep


def fcn8_head(
    params: dict,
    pools: dict,
    in_hw: tuple[int, int],
    *,
    return_features: Sequence[str] = (),
    generator: torch.Generator | None = None,
    dropout_rate: float = 0.5,
    probs_dtype=torch.float32,
) -> tuple[torch.Tensor, dict]:
    """fc6..softmax + skip-fusion decoder from the backbone's pool maps; the
    compute dtype follows the pool maps'."""
    feats: dict = {}
    want = set(return_features)
    pool3, pool4, h = pools["pool3"], pools["pool4"], pools["pool5"]

    p = params["fc6"]
    h = torch.relu(conv2d(h, p["w"], p["b"], padding="SAME"))
    if generator is not None:
        h = _dropout(h, dropout_rate, generator)
    p = params["fc7"]
    h = torch.relu(conv2d(h, p["w"], p["b"], padding="SAME"))
    if generator is not None:
        h = _dropout(h, dropout_rate, generator)
    if "fc7" in want:
        feats["fc7"] = h

    p = params["score_fr"]
    score = conv2d(h, p["w"], p["b"], padding="SAME")
    up2 = conv_transpose2d(score, params["upscore2"]["w"], stride=2)
    p = params["score_pool4"]
    sp4 = conv2d(pool4, p["w"], p["b"], padding="SAME")
    fuse4 = crop_to(up2, sp4.shape[1], sp4.shape[2]) + sp4

    up4 = conv_transpose2d(fuse4, params["upscore_pool4"]["w"], stride=2)
    p = params["score_pool3"]
    sp3 = conv2d(pool3, p["w"], p["b"], padding="SAME")
    fuse3 = crop_to(up4, sp3.shape[1], sp3.shape[2]) + sp3

    up8 = conv_transpose2d(fuse3, params["upscore8"]["w"], stride=8)
    cropped = crop_to(up8, in_hw[0], in_hw[1])
    logits = cropped.float()

    if "score" in want:
        feats["score"] = logits
    if probs_dtype == torch.bfloat16 and "score" not in want:
        # throughput path: softmax of the compute-dtype logits, written once
        # at bf16 (the refinement carry's dtype)
        probs = torch.softmax(cropped.to(torch.bfloat16), dim=-1)
    else:
        probs = torch.softmax(logits, dim=-1).to(probs_dtype)
    if "probs" in want:
        feats["probs"] = probs
    return probs, feats
