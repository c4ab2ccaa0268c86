"""Decompose the phase-major (fused) step against the NHWC tails: the twin
of the repo's ``tools/fused_probe.py`` on the card.

Batch 128, C = 11, 360x480 (180x240 at half resolution), bf16 maps, the
'sep'-tail and 'full'-tail DAEs (stem_pool 1, depth 3) from seeded
weights. The JAX probe's rows with its labels: the two baselines (the
reduction alone; the twin perturbs nothing), the phase-major tail's logits,
its whole step with softmax, update, the next step's phase mean and the
mean's transpose, the NHWC tails (full C x C and the separable one) with
update and pool, ``dae_core`` at half resolution, the phase mean alone and
``s``'s NHWC -> channel-leading copy. After the phase step, its kernel
row: the same function with the tail, softmax and update in one launch of
S1 (``ops.septail_step``, called as ``inference/fused.fused_refinement_scan``
calls it: ``s`` as the core hands it, the weights by ``septail_weights`` at
the carry's dtype), the mean and transpose after it as before. Each row's
scalar is the JAX row's f32 sum of its outputs. Timing and lines as
``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.fused_probe [--iters 10]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, bf16, probe_parser

B, C, HH, WH = 128, 11, 180, 240
DEPTH = 3
TAIL_LAYERS = ("up_stem_dw", "score_input_dw", "mix")


def phase_step_maps(tail: dict, y_ph: torch.Tensor, s_cl: torch.Tensor):
    """``[(label, fn)]``: the phase-major step op by op (the JAX row) and by
    S1; ``fn()`` returns ``(y_ph', the mean of its phases, NHWC)``. ``tail``
    the 'sep' tail's layers at the carry's dtype; ``s_cl`` (B, C, Hh, Wh)."""
    from iterative_inference_segm_tpu_torch.inference.fused import septail_phase_logits, septail_weights
    from iterative_inference_segm_tpu_torch.ops.septail_step import septail_step

    dt = y_ph.dtype
    eps = bf16(0.1)

    def pool_t(y_new):
        return torch.mean(y_new.float(), (1, 2)).to(dt).permute(0, 2, 3, 1)

    def ops():
        r = torch.softmax(septail_phase_logits(tail, s_cl, y_ph).float(), 3).to(dt)
        y_new = y_ph - eps * (y_ph - r)
        return y_new, pool_t(y_new)

    weights = [t.to(dt) for t in septail_weights(tail)]

    def kernel():
        y_new = septail_step(y_ph, s_cl.permute(0, 2, 3, 1), *weights, eps)
        return y_new, pool_t(y_new)

    return [("phase tail+softmax+update+pool+T", ops),
            ("phase tail+softmax+update+pool+T, septail_step (S1)", kernel)]


def nhwc_cases(dae_full: dict, tail: dict, y: torch.Tensor, s: torch.Tensor):
    """``[(label, fn)]`` of the two NHWC tails with update and pool."""
    from iterative_inference_segm_tpu_torch.models.dae import dae_septail_logits
    from iterative_inference_segm_tpu_torch.ops.conv import avg_pool, conv2d, conv_transpose2d

    dt = y.dtype
    eps = bf16(0.1)
    p_si = dae_full["score_input"]

    def step(logits):
        r = torch.softmax(logits.float(), -1).to(dt)
        y_new = y - eps * (y - r)
        return y_new, avg_pool(y_new, window=2, stride=2)

    return [
        ("NHWC tail full-CxC +update+pool (r1)",
         lambda: step(conv_transpose2d(s, dae_full["up_stem1"]["w"], stride=2) + conv2d(y, p_si["w"], p_si["b"]))),
        ("NHWC septail grouped-conv +update+pool", lambda: step(dae_septail_logits(tail, s, y))),
    ]


def cases(dae: dict, dae_full: dict, y_ph, s_cl, y, s, yp, h):
    """``[(label, fn)]`` of every row, in the JAX probe's order; ``dae`` the
    'sep'-tail DAE, ``dae_full`` the 'full'-tail one, ``y_ph``/``s_cl``
    the phase-major state and score map, ``y``/``s`` their NHWC
    counterparts, ``yp`` a half-res map and ``h`` the pool4 tap for the
    core."""
    from iterative_inference_segm_tpu_torch.inference.fused import septail_phase_logits
    from iterative_inference_segm_tpu_torch.models.dae import dae_core

    tail = {k: {kk: t.to(y_ph.dtype) for kk, t in dae[k].items()} for k in TAIL_LAYERS}
    full = {k: {kk: t.to(y.dtype) for kk, t in v.items()} for k, v in dae_full.items()}
    return [
        ("baseline: perturb+reduce phase state", lambda: (y_ph,)),
        ("baseline: perturb+reduce NHWC state", lambda: (y,)),
        ("phase septail logits", lambda: (septail_phase_logits(tail, s_cl, y_ph),)),
        *phase_step_maps(tail, y_ph, s_cl),
        *nhwc_cases(full, tail, y, s),
        ("dae_core mid-res (NHWC)", lambda: (dae_core(dae, yp, h, depth=DEPTH, stem_pool=1),)),
        ("phase pool only", lambda: (torch.mean(y_ph.float(), (1, 2)),)),
        ("s NHWC -> CL transpose", lambda: (s.permute(0, 3, 1, 2).contiguous(),)),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae

    args = probe_parser(__doc__, iters=10, repeats=3).parse_args(argv)
    run = ProbeRun("fused_probe", args)
    dev, dt = run.device, torch.bfloat16
    kw = dict(n_classes=C, h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=DEPTH, stem_pool=1, device=dev)
    dae = init_dae(torch.Generator().manual_seed(0), tail="sep", **kw)
    dae_full = init_dae(torch.Generator().manual_seed(0), tail="full", **kw)
    y_ph = torch.softmax(run.normal((B, 2, 2, C, HH, WH), 1), 3).to(dt)
    s_cl = run.normal((B, C, HH, WH), 2, dt)
    y = torch.softmax(run.normal((B, 2 * HH, 2 * WH, C), 1), -1).to(dt)
    s = run.normal((B, HH, WH, C), 2, dt)
    h = {"pool4": run.normal((B, 23, 30, 512), 3, dt)}
    yp = run.normal((B, HH, WH, C), 4, dt)
    with torch.inference_mode():
        for label, fn in cases(dae, dae_full, y_ph, s_cl, y, s, yp, h):
            run.time(label, fn, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
