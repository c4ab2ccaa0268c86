"""FCN-8: VGG16 fully-convolutional segmenter with skip fusions (port).

Port of ``iterative_inference_segm_tpu.models.fcn8``: the same topology,
parameter names and NHWC interface; parameters are a dict of dicts of
tensors in the layouts of ``ops/conv.py`` (OIHW convs, flipped (I, O, k, k)
transposed convs). 'SAME' convs, ceil-mode pools and centre crops align the
skip fusions exactly as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Union

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

# dropout after fc6/fc7: a generator that draws the two keep-masks, or the
# masks (fc6's, fc7's)
Dropout = Union[torch.Generator, tuple[torch.Tensor, torch.Tensor]]

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
    dropout: Dropout | None = None,
    dropout_rate: float = 0.5,
    compute_dtype=torch.float32,
    probs_dtype=torch.float32,
    model_group=None,
    space=None,
) -> tuple[torch.Tensor, dict]:
    """FCN-8 forward. ``x``: (B, H, W, in_channels) NHWC. Returns
    ``(probs, features)``: probs (B, H, W, C) at ``probs_dtype``, features
    the requested taps. Dropout after fc6/fc7 runs only when ``dropout`` is
    given (training): a generator that draws both keep-masks, or the two
    masks themselves (``dropout_masks``). ``model_group``: fc6/fc7 tensor-
    parallel over this group (``fcn8_head``). ``space``: the layout of an
    H-sharded ``x`` (``parallel.spatial.Rows``); probs and every tap are
    then this rank's band of rows, a tap at /2^k laid out as
    ``space.scaled(k)``."""
    pools, feats = fcn8_backbone(
        params, x, return_features=return_features, compute_dtype=compute_dtype, space=space
    )
    in_h = int(x.shape[1]) if space is None else space.height
    probs, head_feats = fcn8_head(
        params, pools, (in_h, int(x.shape[2])),
        return_features=return_features, dropout=dropout,
        dropout_rate=dropout_rate, probs_dtype=probs_dtype, model_group=model_group, space=space,
    )
    feats.update(head_feats)
    return probs, feats


def fcn8_backbone(
    params: dict,
    x: torch.Tensor,
    *,
    return_features: Sequence[str] = (),
    compute_dtype=torch.float32,
    through: int = 5,
    space=None,
) -> tuple[dict, dict]:
    """The VGG16 stack through pool5, or through pool ``through`` (0: the
    input alone). Returns ``(pools, feats)``: those of pool3/4/5 it reached,
    for the head, and the requested backbone taps. ``space`` as in
    ``fcn8_apply``."""
    feats: dict = {}
    want = set(return_features)
    h = x.to(compute_dtype)
    if "input" in want:
        feats["input"] = h
    pools: dict = {}
    pool_idx = 0
    for item in _VGG:
        if pool_idx == through:
            break
        if item == "P":
            h = max_pool(h, window=2, stride=2, ceil_mode=True, space=space and space.scaled(pool_idx))
            pool_idx += 1
            name = f"pool{pool_idx}"
            pools[name] = h
            if name in want:
                feats[name] = h
            continue
        p = params[item[0]]
        h = torch.relu(conv2d(h, p["w"], p["b"], padding="SAME", space=space and space.scaled(pool_idx)))
    return {k: pools[k] for k in ("pool3", "pool4", "pool5") if k in pools}, feats


def backbone_depth(taps: Sequence[str]) -> int | None:
    """The last pool that the taps ``taps`` need (0 for the input alone), or
    None if one of them lies in the head (fc7)."""
    depth = 0
    for tap in taps:
        if tap == "input":
            continue
        if not (tap.startswith("pool") and tap[4:].isdigit() and 1 <= int(tap[4:]) <= 5):
            return None
        depth = max(depth, int(tap[4:]))
    return depth


def fc_shape(x_shape: Sequence[int], fc_channels: int) -> tuple[int, int, int, int]:
    """Shape of the fc6/fc7 maps (the dropout masks) for an NHWC input:
    five ceil-mode pools take H, W to ceil(H / 32), ceil(W / 32)."""
    b, h, w = (int(s) for s in x_shape[:3])
    return b, -(-h // 32), -(-w // 32), fc_channels


def dropout_masks(
    generator: torch.Generator, shape: Sequence[int], *, dropout_rate: float = 0.5
) -> tuple[torch.Tensor, torch.Tensor]:
    """The keep-masks after fc6 and fc7 (bool, ``shape``), drawn on the
    generator's device: keep with probability ``1 - dropout_rate``."""
    keep = 1.0 - dropout_rate
    return tuple(
        torch.rand(tuple(shape), generator=generator, device=generator.device) < keep for _ in range(2)
    )


def _dropout(h: torch.Tensor, rate: float, mask: torch.Tensor) -> torch.Tensor:
    """``h * mask / keep`` (the JAX package's inverted dropout)."""
    keep = 1.0 - rate
    return h * mask.to(device=h.device, dtype=h.dtype) / keep


def fcn8_head(
    params: dict,
    pools: dict,
    in_hw: tuple[int, int],
    *,
    return_features: Sequence[str] = (),
    dropout: Dropout | None = None,
    dropout_rate: float = 0.5,
    probs_dtype=torch.float32,
    model_group=None,
    space=None,
) -> tuple[torch.Tensor, dict]:
    """fc6..softmax + skip-fusion decoder from the backbone's pool maps; the
    compute dtype follows the pool maps'. ``dropout`` as in ``fcn8_apply``.

    With ``space`` (the input's layout, ``in_hw`` global), the maps are
    H-sharded. A /32 map of fewer rows than shards is gathered once
    (``parallel.spatial.gather_rows``), fc6..score_fr run on it whole on
    every rank, and ``upscore2``'s output is re-sharded: the one all-gather
    of the forward; every other op exchanges rows with its neighbours.

    With ``model_group``, fc6/fc7 run tensor-parallel over it
    (``parallel.tp``): ``params`` hold this rank's fc6 output-channel slice
    and fc7 input-channel slice (``shard_params_tp``), fc7's partial sums
    are summed over the group before its bias, and the dropout mask after
    fc6 is the rank's slice of the whole mask."""
    feats: dict = {}
    want = set(return_features)
    pool3, pool4, h = pools["pool3"], pools["pool4"], pools["pool5"]
    s3, s4, s5 = (None,) * 3 if space is None else (space.scaled(3), space.scaled(4), space.scaled(5))
    whole = space is not None and s5.height < s5.n
    if whole:
        from iterative_inference_segm_tpu_torch.parallel.spatial import gather_rows, own_rows

        h = gather_rows(h, s5)
    hs = None if whole else s5  # the layout of the /32 maps (None: whole on every rank)
    if model_group is not None:
        from iterative_inference_segm_tpu_torch.parallel.tp import copy_to_model, model_slice, reduce_from_model

        h = copy_to_model(h, model_group)

    p = params["fc6"]
    h = torch.relu(conv2d(h, p["w"], p["b"], padding="SAME", space=hs))
    if isinstance(dropout, torch.Generator):
        fc = int(params["fc7"]["w"].shape[0])  # the whole fc width, also under TP
        rows = int(h.shape[1]) if hs is None else hs.height  # and over all rows under H sharding
        dropout = dropout_masks(dropout, (h.shape[0], rows, h.shape[2], fc), dropout_rate=dropout_rate)
        if hs is not None:
            dropout = tuple(m[:, hs.span[0]: hs.span[1]] for m in dropout)
    if dropout is not None:
        mask = dropout[0] if model_group is None else model_slice(dropout[0], model_group)
        h = _dropout(h, dropout_rate, mask)
    p = params["fc7"]
    if model_group is None:
        h = torch.relu(conv2d(h, p["w"], p["b"], padding="SAME", space=hs))
    else:
        h = reduce_from_model(conv2d(h, p["w"], padding="SAME", space=hs), model_group)
        h = torch.relu(h + p["b"].to(h.dtype))
    if dropout is not None:
        h = _dropout(h, dropout_rate, dropout[1])
    if "fc7" in want:
        feats["fc7"] = h

    p = params["score_fr"]
    score = conv2d(h, p["w"], p["b"], padding="SAME", space=hs)
    up2 = conv_transpose2d(score, params["upscore2"]["w"], stride=2, space=hs)
    if whole:
        up2 = own_rows(up2, s5.at(2 * s5.height))
    p = params["score_pool4"]
    sp4 = conv2d(pool4, p["w"], p["b"], padding="SAME", space=s4)
    h4 = int(sp4.shape[1]) if s4 is None else s4.height
    fuse4 = crop_to(up2, h4, sp4.shape[2], space=s5 and s5.at(2 * s5.height)) + sp4

    up4 = conv_transpose2d(fuse4, params["upscore_pool4"]["w"], stride=2, space=s4)
    p = params["score_pool3"]
    sp3 = conv2d(pool3, p["w"], p["b"], padding="SAME", space=s3)
    h3 = int(sp3.shape[1]) if s3 is None else s3.height
    fuse3 = crop_to(up4, h3, sp3.shape[2], space=s4 and s4.at(2 * h4)) + sp3

    up8 = conv_transpose2d(fuse3, params["upscore8"]["w"], stride=8, space=s3)
    cropped = crop_to(up8, in_hw[0], in_hw[1], space=s3 and s3.at(8 * h3))
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


def fcn8_logits(
    params: dict,
    x: torch.Tensor,
    *,
    dropout: Dropout | None = None,
    dropout_rate: float = 0.5,
    compute_dtype=torch.float32,
    model_group=None,
    space=None,
) -> torch.Tensor:
    """Pre-softmax scores (B, H, W, C) in f32 at input resolution (the
    training loss wants logits); ``dropout``, ``model_group`` and ``space``
    as in ``fcn8_apply``."""
    _, feats = fcn8_apply(
        params, x, return_features=("score",), dropout=dropout, dropout_rate=dropout_rate,
        compute_dtype=compute_dtype, model_group=model_group, space=space,
    )
    return feats["score"]
