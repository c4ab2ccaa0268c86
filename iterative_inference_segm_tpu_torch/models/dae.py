"""Conditional denoising autoencoder over segmentation probability maps (port).

Port of ``iterative_inference_segm_tpu.models.dae``: conv3x3 + ReLU encoder
(ceil-mode max-pool or stride-2 conv per stage) with FCN-8 conditioning taps
concatenated at their scale, an FCN-style decoder of 1x1 score projections
and k4/s2 class-width transposed convs, and for ``stem_pool`` > 0 an
avg-pooled stem whose tail returns to full resolution either densely
('full': k4/s2 ``up_stem`` deconvs + a 3x3 ``score_input``) or separably
('sep', stem_pool=1 only: a depthwise k4/s2 upsampler + a depthwise 3x3 on
the map + one 1x1 channel ``mix``).
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from iterative_inference_segm_tpu_torch.models.fcn8 import FCN8_FEATURE_CHANNELS
from iterative_inference_segm_tpu_torch.ops.conv import (
    avg_pool,
    bilinear_kernel_depthwise,
    conv2d,
    conv2d_depthwise,
    conv_transpose2d,
    conv_transpose2d_depthwise,
    crop_to,
    delta_kernel_depthwise,
    init_conv,
    init_conv_transpose_bilinear,
    max_pool,
)

# Spatial scale (log2 downsampling factor) of each conditioning tap.
_H_SCALE = {
    "input": 0,
    "pool1": 1,
    "pool2": 2,
    "pool3": 3,
    "pool4": 4,
    "pool5": 5,
    "fc7": 5,
}

DAE_H_CHANNELS = dict(FCN8_FEATURE_CHANNELS, input=3)

DEFAULT_WIDTHS = (32, 64, 128, 256)


def init_dae(
    generator: torch.Generator,
    *,
    n_classes: int = 11,
    h_specs: Mapping[str, int] | None = None,
    depth: int = 4,
    widths: tuple[int, ...] = DEFAULT_WIDTHS,
    stem_pool: int = 0,
    tail: str = "full",
    dtype=torch.float32,
    device: torch.device | str = "cpu",
) -> dict:
    """Random DAE params; same names, shapes (in port layouts) and checks as
    the JAX ``init_dae``."""
    if tail not in ("full", "sep"):
        raise ValueError(f"unknown tail {tail!r}; expected 'full' or 'sep'")
    if tail == "sep" and stem_pool != 1:
        raise ValueError("tail='sep' is defined for stem_pool=1 (the flagship layout)")
    if h_specs is None:
        h_specs = {"pool4": DAE_H_CHANNELS["pool4"]}
    for name in h_specs:
        if name not in _H_SCALE:
            raise ValueError(f"unknown conditioning tap {name!r}; known: {sorted(_H_SCALE)}")
        if _H_SCALE[name] > depth + stem_pool:
            raise ValueError(
                f"tap {name!r} lives at scale /{2 ** _H_SCALE[name]} deeper than "
                f"stem_pool+depth {stem_pool + depth}"
            )
        if _H_SCALE[name] < stem_pool:
            raise ValueError(
                f"tap {name!r} at scale /{2 ** _H_SCALE[name]} is shallower than the "
                f"stem (/{2 ** stem_pool}); conditioning above the stem is unsupported"
            )
    if depth > len(widths):
        raise ValueError(f"depth {depth} exceeds len(widths) {len(widths)}")
    widths = tuple(widths[:depth])
    kw = {"dtype": dtype, "device": device}

    def h_extra(scale: int) -> int:
        return sum(c for n, c in h_specs.items() if _H_SCALE[n] == scale)

    params: dict = {}
    cin = n_classes + h_extra(stem_pool)
    for i, cout in enumerate(widths):
        params[f"enc{i + 1}"] = init_conv(generator, 3, 3, cin, cout, scale="he", **kw)
        cin = cout + h_extra(stem_pool + i + 1)
    params["bottleneck"] = init_conv(generator, 3, 3, cin, widths[-1], scale="he", **kw)
    params["score_bottleneck"] = init_conv(generator, 1, 1, widths[-1], n_classes, **kw)
    for i in reversed(range(depth)):
        params[f"up{i + 1}"] = init_conv_transpose_bilinear(4, n_classes, n_classes, **kw)
        params[f"score_enc{i + 1}"] = init_conv(generator, 1, 1, widths[i], n_classes, **kw)
    params["out"] = init_conv(generator, 1, 1, n_classes, n_classes, **kw)
    if tail == "sep":
        # bilinear up + identity passthrough + identity mix: at init the tail
        # computes logits = up(s) + y
        params["up_stem_dw"] = {"w": bilinear_kernel_depthwise(4, n_classes, dtype).to(device)}
        params["score_input_dw"] = {"w": delta_kernel_depthwise(3, n_classes, dtype).to(device)}
        eye = torch.eye(n_classes, dtype=dtype, device=device)[:, :, None, None]
        params["mix"] = {"w": eye, "b": torch.zeros((n_classes,), **kw)}
        return params
    for j in range(stem_pool):
        params[f"up_stem{j + 1}"] = init_conv_transpose_bilinear(4, n_classes, n_classes, **kw)
    if stem_pool:
        params["score_input"] = init_conv(generator, 3, 3, n_classes, n_classes, **kw)
    return params


def dae_stem_pool_of(params: dict) -> int:
    """Number of stem pooling levels encoded in a param tree."""
    if "up_stem_dw" in params:
        return 1
    return sum(1 for k in params if k.startswith("up_stem"))


def dae_tail_of(params: dict) -> str:
    return "sep" if "up_stem_dw" in params else "full"


def _crop_tap(v: torch.Tensor, th: int, tw: int, space) -> torch.Tensor:
    """A conditioning tap (or the map it joins) cropped to (th, tw). Under
    H sharding (``space``, the layout of the map at the tap's scale) a tap
    has the map's rows (both are the input's ceil-mode pool chain), so
    only W is cropped."""
    if space is not None and th != space.height:
        raise ValueError(f"an H-sharded tap of {space.height} rows cannot be cropped to {th}")
    return crop_to(v, th, tw, space=space)


def _height(x: torch.Tensor, space) -> int:
    return int(x.shape[1]) if space is None else space.height


def precompute_bottleneck_h(
    params: dict,
    h: Mapping[str, torch.Tensor],
    *,
    depth: int,
    stem_pool: int,
    in_hw: tuple[int, int],
    space=None,
):
    """Fold bottleneck-scale conditioning taps into a loop-invariant bias:
    ``conv(concat(x, v), W) = conv(x, W[:, :cx]) + conv(v, W[:, cx:])``.
    Returns ``(h_bias, crop_hw, remaining_h)`` (``(None, None, h)`` when no
    tap lives at the bottleneck); ``in_hw`` is the core input's (H, W),
    global; ``space`` the core input's layout when it is H-sharded."""
    scale = stem_pool + depth
    taps = [(n, v) for n, v in h.items() if _H_SCALE[n] == scale]
    remaining = {n: v for n, v in h.items() if _H_SCALE[n] != scale}
    if not taps:
        return None, None, remaining
    xh = -(-in_hw[0] // (1 << depth))
    xw = -(-in_hw[1] // (1 << depth))
    bs = space and space.scaled(depth)
    pieces = []
    ch, cw = xh, xw
    for _, v in taps:
        vh, vw = min(_height(v, bs), ch), min(int(v.shape[2]), cw)
        pieces.append(_crop_tap(v, vh, vw, bs))
        ch, cw = vh, vw
    vcat = torch.cat([_crop_tap(v, ch, cw, bs) for v in pieces], dim=-1)
    w = params["bottleneck"]["w"]
    cx = int(w.shape[1]) - int(vcat.shape[-1])
    h_bias = conv2d(vcat, w[:, cx:], padding="SAME", space=bs)
    return h_bias, (ch, cw), remaining


def dae_core(
    params: dict,
    x: torch.Tensor,
    h: Mapping[str, torch.Tensor] | None = None,
    *,
    depth: int = 4,
    stem_pool: int | None = None,
    bottleneck_h: tuple | None = None,
    encoder: str = "pool",
    predense: bool = False,
    space=None,
):
    """Encoder + decoder on the post-stem map: x at /2^stem_pool -> score map
    at the same scale (after the 'out' 1x1). ``x`` must be at compute dtype.
    ``space``: the layout of an H-sharded ``x`` (``parallel.spatial.Rows``);
    the maps at /2^i of it are laid out as ``space.scaled(i)``, the taps
    too.

    ``predense=True`` stops before the final input-scale decoder stage and
    returns ``(pre, skip1)`` (pool encoder: the input of ``up1`` and the
    stage-1 pre-pool features; stride encoder: the state after the
    ``score_enc1`` fusion and None). ``bottleneck_h`` is
    ``precompute_bottleneck_h``'s result; ``h`` is then its ``remaining_h``.
    """
    if encoder not in ("pool", "stride"):
        raise ValueError(f"unknown encoder {encoder!r}; expected 'pool' or 'stride'")
    if stem_pool is None:
        stem_pool = dae_stem_pool_of(params)
    by_scale: dict[int, list[torch.Tensor]] = {}
    for name, v in (h or {}).items():
        by_scale.setdefault(_H_SCALE[name], []).append(v)

    def at(i: int):  # the layout of the map at /2^i of x
        return space and space.scaled(i)

    def concat_h(x: torch.Tensor, scale: int) -> torch.Tensor:
        xs = at(scale - stem_pool)
        for v in by_scale.get(scale, []):
            v = v.to(x.dtype)
            v = _crop_tap(v, min(_height(v, xs), _height(x, xs)), min(v.shape[2], x.shape[2]), xs)
            x = _crop_tap(x, _height(v, xs), v.shape[2], xs)
            x = torch.cat([x, v], dim=-1)
        return x

    in_hw = (_height(x, space), int(x.shape[2]))
    x = concat_h(x, stem_pool)
    skips = []
    for i in range(depth):
        p = params[f"enc{i + 1}"]
        if encoder == "stride":
            x = torch.relu(conv2d(x, p["w"], p["b"], stride=2, padding="SAME", space=at(i)))
            skips.append(x)
        else:
            x = torch.relu(conv2d(x, p["w"], p["b"], padding="SAME", space=at(i)))
            skips.append(x)
            x = max_pool(x, window=2, stride=2, ceil_mode=True, space=at(i))
        x = concat_h(x, stem_pool + i + 1)

    p = params["bottleneck"]
    if bottleneck_h is not None and bottleneck_h[0] is not None:
        h_bias, (ch, cw), _ = bottleneck_h
        x = _crop_tap(x, ch, cw, at(depth))
        cx = int(x.shape[-1])
        x = conv2d(x, p["w"][:, :cx], p["b"], padding="SAME", space=at(depth))
        x = torch.relu(x + h_bias.to(x.dtype))
    else:
        x = torch.relu(conv2d(x, p["w"], p["b"], padding="SAME", space=at(depth)))

    p = params["score_bottleneck"]
    s = conv2d(x, p["w"], p["b"], padding="SAME", space=at(depth))
    if encoder == "stride":
        ss = at(depth)  # the layout of s
        for i in reversed(range(depth)):
            p = params[f"score_enc{i + 1}"]
            sk = conv2d(skips[i], p["w"], p["b"], padding="SAME", space=at(i + 1))
            s = crop_to(s, _height(sk, at(i + 1)), sk.shape[2], space=ss) + sk
            if predense and i == 0:
                return s, None
            s = conv_transpose2d(s, params[f"up{i + 1}"]["w"], stride=2, space=at(i + 1))
            ss = space and space.at(2 * at(i + 1).height)
        s = crop_to(s, min(_height(s, ss), in_hw[0]), min(s.shape[2], in_hw[1]), space=ss)
    else:
        for i in reversed(range(depth)):
            if predense and i == 0:
                return s, skips[0]
            s = conv_transpose2d(s, params[f"up{i + 1}"]["w"], stride=2, space=at(i + 1))
            p = params[f"score_enc{i + 1}"]
            sk = conv2d(skips[i], p["w"], p["b"], padding="SAME", space=at(i))
            s = crop_to(s, _height(sk, at(i)), sk.shape[2], space=space and space.at(2 * at(i + 1).height)) + sk

    p = params["out"]
    return conv2d(s, p["w"], p["b"], padding="SAME", space=space)


def dae_septail_logits(params: dict, s: torch.Tensor, y: torch.Tensor, *, space=None) -> torch.Tensor:
    """Separable tail: ``logits = mix(crop(up_dw(s)) + dw3x3(y)) + b``; ``s``
    the core's score map at /2, ``y`` the full-res map at s's dtype;
    ``space`` the layout of an H-sharded ``y``."""
    half = space and space.scaled(1)
    u = conv_transpose2d_depthwise(s, params["up_stem_dw"]["w"], stride=2, space=half)
    u = crop_to(u, _height(y, space), int(y.shape[2]), space=half and half.at(2 * half.height))
    d = conv2d_depthwise(y, params["score_input_dw"]["w"], padding="SAME", space=space)
    p = params["mix"]
    return conv2d(u + d, p["w"], p["b"], padding="SAME", space=space)


def dae_logits(
    params: dict,
    y: torch.Tensor,
    h: Mapping[str, torch.Tensor] | None = None,
    *,
    depth: int = 4,
    compute_dtype=torch.float32,
    encoder: str = "pool",
    space=None,
) -> torch.Tensor:
    """DAE forward up to the softmax: probability map (B, H, W, C) (+
    conditioning taps) -> logits at the input resolution and
    ``compute_dtype``. The refinement engines hand these to the tail kernel,
    which takes the softmax itself. ``space``: the layout of an H-sharded
    ``y`` (its taps at /2^k laid out as ``space.scaled(k)``); the logits
    are then this rank's band of rows."""
    stem_pool = dae_stem_pool_of(params)
    x = y.to(compute_dtype)
    xs = space
    for _ in range(stem_pool):
        # edge-pad odd sizes to even so the decoder's x2 chain crops back down
        ph, pw = _height(x, xs) % 2, int(x.shape[2]) % 2
        if xs is not None:
            if pw:
                x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, 0), mode="replicate").permute(0, 2, 3, 1)
            x = avg_pool(x, window=2, stride=2, space=xs, edge=True)
            xs = xs.scaled(1)
            continue
        if ph or pw:
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
        x = avg_pool(x, window=2, stride=2)

    s = dae_core(params, x, h, depth=depth, stem_pool=stem_pool, encoder=encoder, space=xs)
    height = _height(y, space)
    if dae_tail_of(params) == "sep":
        s = dae_septail_logits(params, s, y.to(s.dtype), space=space)
    elif stem_pool:
        ss = xs
        for j in range(stem_pool):
            s = conv_transpose2d(s, params[f"up_stem{j + 1}"]["w"], stride=2, space=ss)
            ss = ss and ss.at(2 * ss.height)
        s = crop_to(s, height, y.shape[2], space=ss)
        p = params["score_input"]
        s = s + conv2d(y.to(s.dtype), p["w"], p["b"], padding="SAME", space=space)

    return crop_to(s, height, y.shape[2], space=space)


def dae_apply(
    params: dict,
    y: torch.Tensor,
    h: Mapping[str, torch.Tensor] | None = None,
    *,
    depth: int = 4,
    compute_dtype=torch.float32,
    out_dtype=torch.float32,
    encoder: str = "pool",
    space=None,
) -> torch.Tensor:
    """DAE forward: probability map (B, H, W, C) (+ conditioning taps) ->
    denoised softmax map at the input resolution and ``out_dtype`` (the f32
    softmax of the logits, or a bf16 one when ``out_dtype`` is bf16).
    ``space`` as in ``dae_logits``."""
    logits = dae_logits(params, y, h, depth=depth, compute_dtype=compute_dtype, encoder=encoder, space=space)
    if out_dtype == torch.bfloat16:
        return torch.softmax(logits.to(torch.bfloat16), dim=-1)
    return torch.softmax(logits.float(), dim=-1).to(out_dtype)
