"""The benchmark's own weights and frames, made from the seed on the device.

Frozen here so that a change to the port's initializers cannot move the
yardstick. The parameters follow the port's layout (a dict of dicts of
float32 tensors: OIHW convolutions with a bias, transposed convolutions as
(I, O, k, k) kernels flipped as ``F.conv_transpose2d`` takes them, no
bias), because the same tensors are handed to the port and to the plain
reference. Every random number comes from one ``torch.Generator`` on the
device, in one draw for all weights and biases: He scaling for the ReLU
convolutions, Glorot for the score projections, biases of standard
deviation 0.1 and transposed convolutions a bilinear kernel plus noise of
standard deviation 0.05, so that the comparison sees every bias and any
mixing of channels or flip of a kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

VGG = (
    ("conv1_1", 64), ("conv1_2", 64), "P",
    ("conv2_1", 128), ("conv2_2", 128), "P",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "P",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "P",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "P",
)
TAP_SCALE = {"input": 0, "pool1": 1, "pool2": 2, "pool3": 3, "pool4": 4, "pool5": 5}
TAP_CHANNELS = {"input": 3, "pool1": 64, "pool2": 128, "pool3": 256, "pool4": 512, "pool5": 512}
BIAS_STD = 0.1
UP_NOISE_STD = 0.05


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, frames, the sample),
    so that the uses draw independent streams."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), *tag.encode()]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)


def specs(config: dict) -> list[tuple[str, str, str, tuple[int, ...], float]]:
    """Every leaf: (tree 'fcn' or 'dae', layer, kind, shape, std), kind
    'w' (a convolution's weight), 'b' (its bias) or 'up' (a transposed
    convolution's kernel; std unused)."""
    ds, fcn, dae = config["dataset"], config["fcn"], config["dae"]
    c, fc = ds["n_classes"], fcn["fc_channels"]
    out = []

    def conv(tree, name, k, cin, cout, scale):
        fan_in, fan_out = k * k * cin, k * k * cout
        std = math.sqrt(2.0 / fan_in) if scale == "he" else math.sqrt(2.0 / (fan_in + fan_out))
        out.append((tree, name, "w", (cout, cin, k, k), std))
        out.append((tree, name, "b", (cout,), BIAS_STD))

    def up(tree, name, k):
        out.append((tree, name, "up", (c, c, k, k), 0.0))

    cin = ds["in_channels"]
    for item in VGG:
        if item != "P":
            conv("fcn", item[0], 3, cin, item[1], "he")
            cin = item[1]
    conv("fcn", "fc6", 7, 512, fc, "he")
    conv("fcn", "fc7", 1, fc, fc, "he")
    conv("fcn", "score_fr", 1, fc, c, "glorot")
    conv("fcn", "score_pool4", 1, 512, c, "glorot")
    conv("fcn", "score_pool3", 1, 256, c, "glorot")
    up("fcn", "upscore2", 4)
    up("fcn", "upscore_pool4", 4)
    up("fcn", "upscore8", 16)

    depth, sp, widths = dae["depth"], dae["stem_pool"], dae["widths"]

    def extra(scale):
        return sum(TAP_CHANNELS[t] for t in dae["h_taps"] if TAP_SCALE[t] == scale)

    cin = c + extra(sp)
    for i, w in enumerate(widths):
        conv("dae", f"enc{i + 1}", 3, cin, w, "he")
        cin = w + extra(sp + i + 1)
    conv("dae", "bottleneck", 3, cin, widths[-1], "he")
    conv("dae", "score_bottleneck", 1, widths[-1], c, "glorot")
    for i in reversed(range(depth)):
        up("dae", f"up{i + 1}", 4)
        conv("dae", f"score_enc{i + 1}", 1, widths[i], c, "glorot")
    conv("dae", "out", 1, c, c, "glorot")
    for j in range(sp):
        up("dae", f"up_stem{j + 1}", 4)
    if sp:
        conv("dae", "score_input", 3, c, c, "glorot")
    return out


def bilinear(k: int, c: int) -> torch.Tensor:
    """(c, c, k, k): channel i to channel i by the separable triangle
    filter of a k-tap bilinear upsampler, nothing across channels."""
    f = (k + 1) // 2
    centre = f - 1.0 if k % 2 == 1 else f - 0.5
    tri = 1.0 - (torch.arange(k, dtype=torch.float64) - centre).abs() / f
    w = torch.zeros((c, c, k, k), dtype=torch.float64)
    w[range(c), range(c)] = tri[:, None] * tri[None, :]
    return w.float()


def make_params(config: dict, seed: int, device) -> tuple[dict, dict]:
    """(fcn, dae) parameter trees, float32 on ``device``, from ``seed``. On
    the meta device they are shapes alone (for counting operations)."""
    leaves = specs(config)
    total = sum(math.prod(s) for *_, s, _ in leaves)
    device = torch.device(device)
    if device.type == "meta":
        flat = torch.empty(total, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
        flat = torch.randn(total, generator=gen, device=device)
    trees: dict = {"fcn": {}, "dae": {}}
    at = 0
    for tree, name, kind, shape, std in leaves:
        n = math.prod(shape)
        t = flat[at: at + n].view(shape)
        at += n
        if kind == "up":
            t = t * UP_NOISE_STD + bilinear(shape[-1], shape[0]).to(device)
            trees[tree].setdefault(name, {})["w"] = t
        else:
            trees[tree].setdefault(name, {})[kind] = t * std
    return trees["fcn"], trees["dae"]


def make_frames(n_pool: int, batch: int, config: dict, seed: int, device) -> np.ndarray:
    """``n_pool`` distinct batches of frames, (n_pool, batch, H, W, C)
    float32 in [0, 1) on the host, drawn on ``device`` from ``seed``."""
    ds = config["dataset"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "frames"))
    out = np.empty((n_pool, batch, ds["height"], ds["width"], ds["in_channels"]), np.float32)
    for i in range(n_pool):
        out[i] = torch.rand(out.shape[1:], generator=gen, device=device).cpu().numpy()
    return out
