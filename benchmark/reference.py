"""The plain reference of both configurations: FCN-8 (VGG16) and the
conditional DAE's refinement, in plain PyTorch, NCHW, float32 with TF32 off.

Written from the model's equations (arXiv:1705.07450; the layer layout of
``weights.specs``), not from the port, and imports nothing of it. Every
convolution is 'SAME' at stride 1; max-pools are 2x2 windows that keep a
partial last window (the map is padded with -inf to even size); a k-tap
transposed convolution at stride s gives exactly s times its input, taken
from the full transposed convolution at offset ``k - 1 - ceil((k + s -
2) / 2)``; skip fusions centre-crop at offset ``(size - target) // 2``.

The refinement takes the FCN's softmax ``y0`` and the pool4 tap, and runs K
steps of ``y <- (1 - eps) y + eps softmax(logits(y))``:

* ``general``: the logits are the DAE's at full resolution;
* ``half``: the steps run on ``x = avg_pool2(y0)`` with the logits
  ``core(x) + score_input(x)``, then one full-resolution rectification
  ``y = (1 - eps) y0 + eps softmax(crop(up_stem(core(x_K))) +
  score_input(y0))``.

``quant`` stands in another precision for the operands of every
convolution (the control of ``check.py``: float8 e4m3 with one scale a
tensor); None keeps float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.weights import TAP_SCALE, VGG


def exact_f32() -> None:
    """Float32 stays float32 on the card: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, returned in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def conv(x, p, quant=None):
    w, b = p["w"], p["b"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def up(x, w, stride, quant=None):
    """Transposed convolution whose output is ``stride`` times its input."""
    k = w.shape[-1]
    off = k - 1 - (-(-(k + stride - 2) // 2))
    if quant is not None:
        x, w = quant(x), quant(w)
    full = F.conv_transpose2d(x, w, stride=stride)
    return full[..., off: off + x.shape[-2] * stride, off: off + x.shape[-1] * stride]


def pool(x):
    n, c, h, w = x.shape
    x = F.pad(x, (0, w % 2, 0, h % 2), value=float("-inf"))
    return x.reshape(n, c, (h + 1) // 2, 2, (w + 1) // 2, 2).amax(dim=(3, 5))


def crop(x, h, w):
    oh, ow = (x.shape[-2] - h) // 2, (x.shape[-1] - w) // 2
    return x[..., oh: oh + h, ow: ow + w]


def fcn8(p: dict, frames: torch.Tensor, config: dict, quant=None):
    """frames (N, H, W, C) in [0, 1] -> (softmax (N, classes, H, W), taps
    {name: map})."""
    ds = config["dataset"]
    mean = torch.tensor(ds["mean"], device=frames.device).view(1, -1, 1, 1)
    std = torch.tensor(ds["std"], device=frames.device).view(1, -1, 1, 1)
    h = (frames.permute(0, 3, 1, 2).float() - mean) / std
    taps = {"input": h}
    n_pool = 0
    for item in VGG:
        if item == "P":
            h = pool(h)
            n_pool += 1
            taps[f"pool{n_pool}"] = h
        else:
            h = torch.relu(conv(h, p[item[0]], quant))
    h = torch.relu(conv(h, p["fc6"], quant))
    h = torch.relu(conv(h, p["fc7"], quant))
    s = up(conv(h, p["score_fr"], quant), p["upscore2"]["w"], 2, quant)
    s4 = conv(taps["pool4"], p["score_pool4"], quant)
    s = up(crop(s, *s4.shape[-2:]) + s4, p["upscore_pool4"]["w"], 2, quant)
    s3 = conv(taps["pool3"], p["score_pool3"], quant)
    s = up(crop(s, *s3.shape[-2:]) + s3, p["upscore8"]["w"], 8, quant)
    logits = crop(s, frames.shape[1], frames.shape[2])
    return torch.softmax(logits, dim=1), taps


def dae_core(p: dict, x, taps: dict, dae: dict, quant=None):
    """The DAE from its stem's scale to the score map at the same scale
    (after ``out``); ``taps`` the FCN's, joined where their scale is
    reached."""
    depth, sp = dae["depth"], dae["stem_pool"]

    def join(x, scale):
        for name in dae["h_taps"]:
            if TAP_SCALE[name] == scale:
                v = taps[name]
                hh, ww = min(v.shape[-2], x.shape[-2]), min(v.shape[-1], x.shape[-1])
                x = torch.cat([crop(x, hh, ww), crop(v, hh, ww)], dim=1)
        return x

    x = join(x, sp)
    skips = []
    for i in range(depth):
        x = torch.relu(conv(x, p[f"enc{i + 1}"], quant))
        skips.append(x)
        x = join(pool(x), sp + i + 1)
    x = torch.relu(conv(x, p["bottleneck"], quant))
    s = conv(x, p["score_bottleneck"], quant)
    for i in reversed(range(depth)):
        s = up(s, p[f"up{i + 1}"]["w"], 2, quant)
        sk = conv(skips[i], p[f"score_enc{i + 1}"], quant)
        s = crop(s, *sk.shape[-2:]) + sk
    return conv(s, p["out"], quant)


def refine(fcn: dict, dae: dict, frames: torch.Tensor, config: dict, quant=None):
    """frames (N, H, W, C) in [0, 1] -> the refined probabilities (N, H,
    W, classes), float32, after the configuration's engine."""
    eps, k_steps, spec = config["eps"], config["num_steps"], config["dae"]
    y0, taps = fcn8(fcn, frames, config, quant)

    def blend(y, logits):
        return (1.0 - eps) * y + eps * torch.softmax(logits, dim=1)

    if config["engine"] == "general":
        if spec["stem_pool"]:
            raise ValueError("the general engine's reference takes a DAE without a stem")
        y = y0
        for _ in range(k_steps):
            y = blend(y, crop(dae_core(dae, y, taps, spec, quant), *y.shape[-2:]))
    elif config["engine"] == "half":
        if spec["stem_pool"] != 1:
            raise ValueError("the half engine's reference takes a DAE with stem_pool 1")
        x = F.avg_pool2d(y0, 2)
        for _ in range(k_steps):
            x = blend(x, dae_core(dae, x, taps, spec, quant) + conv(x, dae["score_input"], quant))
        u = up(dae_core(dae, x, taps, spec, quant), dae["up_stem1"]["w"], 2, quant)
        y = blend(y0, crop(u, *y0.shape[-2:]) + conv(y0, dae["score_input"], quant))
    else:
        raise ValueError(f"unknown engine {config['engine']!r}")
    return y.permute(0, 2, 3, 1)
