"""Decompose ``dae_core`` at the flagship configuration: the twin of the
repo's ``tools/core_probe.py`` on the card.

Batch 128, the half-resolution map (180x240, C = 11, bf16), the flagship
DAE (stem_pool 1, depth 3, widths (32, 64, 128), seeded weights cast to
bf16) with its pool4 tap as a folded bottleneck bias (a seeded (128, 23, 30,
128) map). Rows, with the JAX probe's labels: the encoder and bottleneck
alone; the encoder and the skips' 1x1 scores (no deconv chain); the full
core; and the JAX probe's STRIDED candidate, defined here as there (stride-2
convolutions in place of conv + max-pool, the skips at the reduced scales),
encoder alone and full core. Each row's scalar is the JAX row's f32 sum of
its outputs. Timing and lines as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.core_probe [--iters 10]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, probe_parser

B, C = 128, 11
HH, WH = 180, 240
DEPTH = 3


def _bottleneck(dae: dict, h: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, crop_to

    p = dae["bottleneck"]  # its kernel's first inputs read the encoder, the rest the pool4 tap
    return torch.relu(conv2d(h, p["w"][:, :h.shape[-1]], p["b"], padding="SAME")
                      + crop_to(hb, h.shape[1], h.shape[2]).to(h.dtype))


def encoder(dae: dict, x: torch.Tensor, hb: torch.Tensor, *, strided: bool = False):
    """``(bottleneck map, skips)``: three conv3x3 + ReLU stages, each then
    max-pooled (ceil mode), or (``strided``) each a stride-2 conv; the
    bottleneck with ``hb`` added before its ReLU."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, max_pool

    skips, h = [], x
    for i in range(DEPTH):
        p = dae[f"enc{i + 1}"]
        h = torch.relu(conv2d(h, p["w"], p["b"], stride=2 if strided else 1, padding="SAME"))
        skips.append(h)
        if not strided:
            h = max_pool(h, window=2, stride=2, ceil_mode=True)
    return _bottleneck(dae, h, hb), skips


def cases(dae: dict, x: torch.Tensor, hb: torch.Tensor):
    """``[(label, fn)]``; ``fn()`` returns the row's map(s)."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, conv_transpose2d, crop_to

    def score(name, v):
        p = dae[name]
        return conv2d(v, p["w"], p["b"], padding="SAME")

    def full_core():
        h, skips = encoder(dae, x, hb)
        s = score("score_bottleneck", h)
        for i in reversed(range(DEPTH)):
            s = conv_transpose2d(s, dae[f"up{i + 1}"]["w"], stride=2)
            skc = score(f"score_enc{i + 1}", skips[i])
            s = crop_to(s, skc.shape[1], skc.shape[2]) + skc
        return (score("out", s),)

    def dec_scores_only():
        h, skips = encoder(dae, x, hb)
        return (*(score(f"score_enc{i + 1}", skips[i]) for i in range(DEPTH)), h)

    def core_strided():
        h, skips = encoder(dae, x, hb, strided=True)
        s = score("score_bottleneck", h)
        for i in reversed(range(DEPTH)):
            skc = score(f"score_enc{i + 1}", skips[i])
            s = crop_to(s, skc.shape[1], skc.shape[2]) + skc
            s = conv_transpose2d(s, dae[f"up{i + 1}"]["w"], stride=2)
        return (score("out", crop_to(s, x.shape[1], x.shape[2])),)

    return [
        ("encoder + bottleneck only", lambda: (encoder(dae, x, hb)[0],)),
        ("encoder + skip 1x1 scores (no deconv chain)", dec_scores_only),
        ("full core (enc + decoder chain + out)", full_core),
        ("STRIDED encoder + bottleneck (candidate)", lambda: (encoder(dae, x, hb, strided=True)[0],)),
        ("STRIDED full core (candidate)", core_strided),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae

    args = probe_parser(__doc__, iters=10, repeats=3).parse_args(argv)
    run = ProbeRun("core_probe", args)
    dev, dt = run.device, torch.bfloat16
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=C, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                   depth=DEPTH, stem_pool=1, device=dev)
    dae = {k: {kk: t.to(dt) for kk, t in v.items()} for k, v in dae.items()}
    x = torch.softmax(run.normal((B, HH, WH, C), 0), -1).to(dt)
    hb = run.normal((B, 23, 30, dae["bottleneck"]["w"].shape[0]), 2, dt)
    with torch.inference_mode():
        for label, fn in cases(dae, x, hb):
            run.time(label, fn, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
