"""Mirror-architecture conditional DAE (port of
``iterative_inference_segm_tpu.models.dae_mirror``).

A conv/pool encoder mirrored by an unpool/conv decoder, with the classic
tied/untied weight knob:

* **Encoder**, per stage ``i``: 3x3 conv (``cin_i -> widths[i]``) + ReLU +
  ceil-mode 2x2 max-pool; FCN-8 conditioning taps are concatenated at the
  input of the conv at their scale.
* **Decoder**, deepest first: switch-based max-unpool (``ops.conv.
  max_unpool``, the adjoint of the encoder's pool) + 3x3 conv back to the
  encoder stage's input channels, of which the conditioning channels are
  sliced off (the adjoint of a concat is a split) + ReLU (none after the
  last).
* **Tied** (``tied=True``): the decoder's stage-``i`` kernel is the adjoint
  of the encoder's, ``adjoint_kernel(W_enc)``; decoder stages carry only
  their biases.
* **Bottleneck**: taps at the deepest scale (pool4 at depth 4) are
  concatenated there and absorbed by an untied ``mid`` 3x3 conv.
* **Head**: a 1x1 ``out`` conv (n_classes -> n_classes).

``mirror_dae_logits`` stops before the softmax (the refinement engines hand
the logits to the tail kernel); ``mirror_dae_apply`` takes it. The pooling
switches are constants under differentiation, so energy mode runs through
it as in the JAX package.
"""

from __future__ import annotations

from typing import Mapping

import torch

from iterative_inference_segm_tpu_torch.models.dae import _H_SCALE, DAE_H_CHANNELS, DEFAULT_WIDTHS
from iterative_inference_segm_tpu_torch.models.dae import _crop_tap
from iterative_inference_segm_tpu_torch.ops.conv import conv2d, crop_to, init_conv, max_pool, max_unpool


def _h_extra(h_specs: Mapping[str, int], scale: int) -> int:
    return sum(c for n, c in h_specs.items() if _H_SCALE[n] == scale)


def _enc_cins(n_classes: int, h_specs: Mapping[str, int], depth: int, widths) -> list[int]:
    """Input channel count of each encoder conv (h concat included)."""
    cins = []
    cin = n_classes + _h_extra(h_specs, 0)
    for i in range(depth):
        cins.append(cin)
        cin = widths[i] + _h_extra(h_specs, i + 1)
    return cins


def init_mirror_dae(
    generator: torch.Generator,
    *,
    n_classes: int = 11,
    h_specs: Mapping[str, int] | None = None,
    depth: int = 4,
    widths: tuple[int, ...] = DEFAULT_WIDTHS,
    tied: bool = False,
    dtype=torch.float32,
    device: torch.device | str = "cpu",
) -> dict:
    """Random mirror-DAE params; same names, shapes (OIHW) and checks as the
    JAX ``init_mirror_dae``. Taps at scales 0..depth-1 feed the next encoder
    conv, taps at scale ``depth`` the ``mid`` conv. ``tied=True`` gives the
    decoder stages biases only."""
    if h_specs is None:
        h_specs = {"pool4": DAE_H_CHANNELS["pool4"]}
    for name in h_specs:
        if name not in _H_SCALE:
            raise ValueError(f"unknown conditioning tap {name!r}; known: {sorted(_H_SCALE)}")
        if _H_SCALE[name] > depth:
            raise ValueError(
                f"mirror DAE consumes taps at scales 0..{depth}; "
                f"tap {name!r} lives at scale {_H_SCALE[name]} (raise depth)"
            )
    if depth > len(widths):
        raise ValueError(f"depth {depth} exceeds len(widths) {len(widths)}")
    widths = tuple(widths[:depth])
    kw = {"dtype": dtype, "device": device}

    params: dict = {}
    cins = _enc_cins(n_classes, h_specs, depth, widths)
    for i in range(depth):
        params[f"enc{i + 1}"] = init_conv(generator, 3, 3, cins[i], widths[i], scale="he", **kw)
    h_mid = _h_extra(h_specs, depth)
    if h_mid:
        params["mid"] = init_conv(generator, 3, 3, widths[-1] + h_mid, widths[-1], scale="he", **kw)
    for i in reversed(range(depth)):
        if tied:
            params[f"dec{i + 1}"] = {"b": torch.zeros((cins[i],), **kw)}
        else:
            params[f"dec{i + 1}"] = init_conv(generator, 3, 3, widths[i], cins[i], scale="he", **kw)
    params["out"] = init_conv(generator, 1, 1, n_classes, n_classes, **kw)
    return params


def mirror_tied_of(params: dict) -> bool:
    """Whether a mirror-DAE param tree is weight-tied (no decoder kernels)."""
    return "w" not in params["dec1"]


def mirror_depth_of(params: dict) -> int:
    return sum(1 for k in params if k.startswith("enc"))


def adjoint_kernel(w: torch.Tensor) -> torch.Tensor:
    """Adjoint of a SAME-padded odd conv kernel, OIHW: a spatial flip and the
    swap of the O and I axes. ``conv2d(., adjoint_kernel(w))`` is the
    transpose of ``conv2d(., w)`` when input and output spatial shapes
    coincide (odd k, symmetric padding)."""
    return torch.flip(w, dims=(2, 3)).transpose(0, 1)


def mirror_dae_logits(
    params: dict,
    y: torch.Tensor,
    h: Mapping[str, torch.Tensor] | None = None,
    *,
    depth: int | None = None,
    compute_dtype=torch.float32,
    space=None,
) -> torch.Tensor:
    """Mirror DAE forward up to the softmax: probability map (B, H, W, C) (+
    conditioning taps at scales 0..depth) -> logits at the input resolution
    and ``compute_dtype``. Tied or untied is read off the params. ``space``:
    the layout of an H-sharded ``y`` (``parallel.spatial.Rows``; a tap at
    /2^k laid out as ``space.scaled(k)``); the logits are then this rank's
    band of rows."""
    if depth is None:
        depth = mirror_depth_of(params)
    tied = mirror_tied_of(params)
    by_scale: dict[int, list[torch.Tensor]] = {}
    for name, v in (h or {}).items():
        by_scale.setdefault(_H_SCALE[name], []).append(v)

    def at(i: int):
        return space and space.scaled(i)

    def height(t, i):
        return int(t.shape[1]) if space is None else at(i).height

    def concat_h(x: torch.Tensor, scale: int) -> torch.Tensor:
        for v in by_scale.get(scale, []):
            v = v.to(x.dtype)
            v = _crop_tap(v, min(height(v, scale), height(x, scale)), min(v.shape[2], x.shape[2]), at(scale))
            x = _crop_tap(x, height(v, scale), v.shape[2], at(scale))
            x = torch.cat([x, v], dim=-1)
        return x

    x = concat_h(y.to(compute_dtype), 0)
    # base_ch[i]: the channels the decoder slices back to at scale i (the
    # encoder conv's input width less that scale's conditioning channels)
    base_ch = [int(y.shape[-1])]
    pres = []  # pre-pool activations: the pooling switches and the unpool shapes
    for i in range(depth):
        p = params[f"enc{i + 1}"]
        pre = torch.relu(conv2d(x, p["w"], p["b"], padding="SAME", space=at(i)))
        pres.append(pre)
        base_ch.append(int(pre.shape[-1]))
        x = max_pool(pre, window=2, stride=2, ceil_mode=True, space=at(i))
        x = concat_h(x, i + 1)

    d = x
    if "mid" in params:
        p = params["mid"]
        d = torch.relu(conv2d(d, p["w"], p["b"], padding="SAME", space=at(depth)))
    for i in reversed(range(depth)):
        pre = pres[i]
        want = (-(-height(pre, i) // 2), -(-int(pre.shape[2]) // 2))
        if (height(d, i + 1), int(d.shape[2])) != want:
            raise ValueError(
                f"mirror decoder stage {i + 1}: carry {tuple(d.shape[1:3])} does not match the "
                f"encoder's pooled shape {want}: a conditioning tap cropped the encoder mid-chain; "
                "use taps whose shapes align with the DAE's ceil-mode chain (FCN-8 taps on the "
                "same input do)"
            )
        d = max_unpool(d, pre, window=2, stride=2, space=at(i))
        p = params[f"dec{i + 1}"]
        w = adjoint_kernel(params[f"enc{i + 1}"]["w"]) if tied else p["w"]
        d = conv2d(d, w, p["b"], padding="SAME", space=at(i))
        d = d[..., : base_ch[i]]
        if i > 0:
            d = torch.relu(d)

    p = params["out"]
    logits = conv2d(d, p["w"], p["b"], padding="SAME", space=space)
    return crop_to(logits, height(y, 0), int(y.shape[2]), space=space)


def mirror_dae_apply(
    params: dict,
    y: torch.Tensor,
    h: Mapping[str, torch.Tensor] | None = None,
    *,
    depth: int | None = None,
    compute_dtype=torch.float32,
    out_dtype=torch.float32,
    space=None,
) -> torch.Tensor:
    """Mirror DAE forward: the softmax of ``mirror_dae_logits`` at
    ``out_dtype`` (taken in f32, or in bf16 when ``out_dtype`` is bf16).
    ``space`` as in ``mirror_dae_logits``."""
    logits = mirror_dae_logits(params, y, h, depth=depth, compute_dtype=compute_dtype, space=space)
    if out_dtype == torch.bfloat16:
        return torch.softmax(logits.to(torch.bfloat16), dim=-1)
    return torch.softmax(logits.float(), dim=-1).to(out_dtype)
