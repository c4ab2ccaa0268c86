"""How should max-pool be formulated, and can conv1_2 + pool1 fuse into one
phase-strided conv? The twin of the repo's ``tools/pool_probe.py`` on the
card.

Batch 128, bf16, seeded maps and weights. For VGG's pool1 (360x480x64) and
pool2 (180x240x128) maps: the reduction alone (the baseline), max-pool by
the package's ``max_pool`` (``F.max_pool2d``; the JAX label says
``reduce_window``, the op it lowers to there) and by reshape + maximum. Then
conv1_2 (64 -> 64, 3x3) + pool1 with either pool, and the phase-strided
form: one 4x4 stride-2 conv into 4 x 64 channels, the 3x3 kernel placed at
each of the four offsets (ph, pw) of the 2x2 window (``phase_weight``), its
ReLU'd phases reduced by a group max. The JAX probe printed the
equivalence of the last with conv + ReLU + pool on a slice; this twin
asserts it (``equivalence_error``, within two bf16 ulps of the slice's
largest value), one JSON line. Each row's scalar is the JAX row's, the f32
sum of the map's channel 0. Timing and lines as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.pool_probe [--iters 8]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, first_class, probe_parser

B = 128
MAPS = ((360, 480, 64), (180, 240, 128))
CONV1 = (360, 480, 64)  # conv1_1's output, conv1_2's input
CHECK_ULPS = 2  # the phase form's bf16 rounding against conv + pool's: another summation order


def pool_reshape(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool of an even map by reshape + maximum."""
    b, hh, ww, cc = x.shape
    g = x.reshape(b, hh // 2, 2, ww // 2, 2, cc)
    m = torch.maximum(g[:, :, 0], g[:, :, 1])
    return torch.maximum(m[:, :, :, 0], m[:, :, :, 1])


def phase_weight(w3: torch.Tensor, b3: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The phase-strided conv's (4*C, C, 4, 4) OIHW kernel and bias from a
    3x3 OIHW ``w3``: output phase ph*2 + pw holds ``w3`` at rows ph..ph+2,
    columns pw..pw+2 (the JAX probe's HWIO slots ``w4[ph:ph+3, pw:pw+3, :,
    phase]``, transposed as ``utils/jax_bridge`` transposes a conv)."""
    c = int(w3.shape[0])
    w4 = torch.zeros((4 * c, int(w3.shape[1]), 4, 4), dtype=w3.dtype, device=w3.device)
    for ph in range(2):
        for pw in range(2):
            phase = ph * 2 + pw
            w4[phase * c:(phase + 1) * c, :, ph:ph + 3, pw:pw + 3] = w3
    return w4, b3.repeat(4)


def conv_pool(x, w3, b3, *, reshape: bool = False) -> torch.Tensor:
    """conv1_2 + ReLU + pool1, the pool by ``max_pool`` or reshape-max."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, max_pool

    h = torch.relu(conv2d(x, w3, b3, padding="SAME"))
    return pool_reshape(h) if reshape else max_pool(h, window=2, stride=2, ceil_mode=True)


def conv_phase(x, w4, b4) -> torch.Tensor:
    """The phase-strided conv (stride 2, padding 1) + ReLU + group max."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d

    c = int(w4.shape[0]) // 4
    out = torch.relu(conv2d(x, w4, stride=2, padding=((1, 1), (1, 1))) + b4.to(x.dtype))
    m = torch.maximum(out[..., :2 * c], out[..., 2 * c:])
    return torch.maximum(m[..., :c], m[..., c:])


def equivalence_error(x, w3, b3) -> tuple[float, float]:
    """(max abs difference of the phase form from conv + ReLU + pool on
    ``x``, the latter's largest magnitude)."""
    a = conv_pool(x, w3, b3)
    got = conv_phase(x, *phase_weight(w3, b3))
    return (a.float() - got.float()).abs().max().item(), a.float().abs().max().item()


def pool_cases(x: torch.Tensor):
    """``[(label, fn)]`` of one map's pools."""
    from iterative_inference_segm_tpu_torch.ops.conv import max_pool

    h, w, c = (int(d) for d in x.shape[1:])
    return [
        (f"baseline read ({h},{w},{c})", lambda: (x,)),
        (f"max_pool reduce_window ({h},{w},{c})", lambda: (max_pool(x, window=2, stride=2, ceil_mode=True),)),
        (f"max_pool reshape+maximum ({h},{w},{c})", lambda: (pool_reshape(x),)),
    ]


def conv_cases(x1: torch.Tensor, w3: torch.Tensor, b3: torch.Tensor):
    """``[(label, fn)]`` of the conv1_2 + pool1 forms."""
    w4, b4 = phase_weight(w3, b3)
    return [
        ("conv1_2 + reduce_window pool1 (current)", lambda: (conv_pool(x1, w3, b3),)),
        ("conv1_2 + reshape-max pool1", lambda: (conv_pool(x1, w3, b3, reshape=True),)),
        ("conv1_2 phase-strided conv + group-max (fused pool)", lambda: (conv_phase(x1, w4, b4),)),
    ]


def main(argv=None) -> int:
    args = probe_parser(__doc__, iters=8, repeats=3).parse_args(argv)
    run = ProbeRun("pool_probe", args)
    dev, dt = run.device, torch.bfloat16
    with torch.inference_mode():
        for i, (h, w, c) in enumerate(MAPS):
            x = run.normal((B, h, w, c), i, dt)
            for label, fn in pool_cases(x):
                run.time(label, fn, B, first_class)
            del x
        c = CONV1[-1]
        x1 = run.normal((B, *CONV1), 2, dt)
        w3 = run.normal((c, c, 3, 3), 3).mul(0.05).to(dt)
        b3 = torch.zeros((c,), dtype=dt, device=dev)
        for label, fn in conv_cases(x1, w3, b3):
            run.time(label, fn, B, first_class)
        err, top = equivalence_error(x1[:2, :16, :16], w3, b3)
        run.check("phase-conv vs conv+pool max abs err", err, CHECK_ULPS * 2.0**-8 * top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
