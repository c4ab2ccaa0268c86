"""Decompose the pipeline's cost at the bench configuration (batch 128,
bf16): the twin of the repo's ``tools/pipeline_probe.py`` on the card.

FCN-8 / VGG16 fc 4096, C = 11, 360x480, a DAE of stem_pool 1 and depth 3
(``--stem-pool``, ``--depth``) with the pool4 tap, weights from seeded
generators. The JAX probe's rows, with its labels:

  - the backbone to fc7 (the VGG stack and fc6/fc7 only: the JAX row's jit
    drops the decoder, whose output it never reads), then FCN + decoder;
  - the pipeline at K = 0, 1 and 5 (the general engine over the DAE's
    logits, each score step one launch of the tail kernel K3) and the
    marginal cost of a step;
  - one ``dae_apply``;
  - the tail at full resolution (the ``up_stem1`` deconv, the 3x3
    ``score_input``, softmax, update) op by op, with an f32 iterate and in
    all-bf16 state, each followed by its kernel row: the same function with
    the crop, add, softmax and blend in one launch of K3 (``ops.refine_tail``,
    the deconv and the 3x3 conv left to cuDNN, as the half engine's step
    does), its logits the same bf16 maps (the f32 row's 3x3 output widened
    to the iterate's dtype, as the kernel takes ``v``);
  - the stem's avg-pools;
  - the mid-resolution encoder/decoder: a stem_pool 0 DAE on the half-res
    map, its /16 tap (512 channels) declared at 'pool3', the /8 of the
    half-res input, as the JAX probe builds it. It runs; nothing catches
    its failure.

Each row's scalar is the JAX row's f32 sum of its outputs. Timing and lines
as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.pipeline_probe [--batch 128] [--iters 8]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, bf16, probe_parser

H, W, C = 360, 480, 11
FC_CHANNELS = 4096
EPS = 0.1


def parse_args(argv=None):
    p = probe_parser(__doc__, iters=8, repeats=2)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--stem-pool", type=int, default=1)
    p.add_argument("--depth", type=int, default=3)
    return p.parse_args(argv)


def to_fc7(fcn: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """What the JAX row computes of ``fcn8_apply(..., ('fc7',))``: the VGG
    stack, fc6 and fc7."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_backbone
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d

    pools, _ = fcn8_backbone(fcn, x, compute_dtype=compute_dtype)
    h = pools["pool5"]
    for name in ("fc6", "fc7"):
        h = torch.relu(conv2d(h, fcn[name]["w"], fcn[name]["b"], padding="SAME"))
    return h


def pipeline_cases(fcn: dict, dae: dict, x: torch.Tensor, *, depth: int, compute_dtype):
    """``[(label, fn)]``: the backbone, FCN + decoder, the pipeline at K = 0,
    1, 5; ``fn()`` returns the row's maps."""
    from iterative_inference_segm_tpu_torch.inference.iterative import logits_refinement_scan
    from iterative_inference_segm_tpu_torch.models.dae import dae_logits
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply

    cd = compute_dtype

    def full_fcn():
        y0, h = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd)
        return y0, h["pool4"]

    def steps(k):
        def fn():
            y0, h = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd)
            return (logits_refinement_scan(lambda y: dae_logits(dae, y, h, depth=depth, compute_dtype=cd), y0,
                                           eps=EPS, num_steps=k, mode="score"),)
        return fn

    return [
        ("FCN backbone (to fc7)", lambda: (to_fc7(fcn, x, cd),)),
        ("FCN fwd + decoder (y0 + pool4)", full_fcn),
        ("pipeline K=0", steps(0)),
        ("pipeline K=1", steps(1)),
        ("pipeline K=5", steps(5)),
    ]


def tail_terms(dae: dict, y: torch.Tensor, s_half: torch.Tensor, *, compute_dtype, all_bf16: bool):
    """``(u, v, eps)`` the kernel rows hand ``refine_tail``: the ``up_stem1``
    deconv of ``s_half`` (uncropped: the kernel crops), the 3x3
    ``score_input`` of ``y`` at ``y``'s dtype, the blend's eps (the JAX
    row's ``bf16(0.1)`` in the all-bf16 rows)."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, conv_transpose2d

    cd = compute_dtype
    p = dae["score_input"]
    v = conv2d(y if all_bf16 else y.to(cd), p["w"], p["b"], padding="SAME").to(y.dtype)
    return conv_transpose2d(s_half, dae["up_stem1"]["w"], stride=2), v, bf16(EPS) if all_bf16 else EPS


def tail_maps(dae: dict, y: torch.Tensor, s_half: torch.Tensor, *, compute_dtype, all_bf16: bool):
    """``[(label, fn)]`` of the tail rows with an f32 iterate ``y``, or (
    ``all_bf16``) the all-bf16 rows' formula (``y`` bf16 on the card): the
    op-by-op tail and its kernel row (``tail_terms``, then one launch of
    K3), ``fn()`` returning the new iterate."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, conv_transpose2d
    from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail

    cd = compute_dtype
    w_up, w_si, b_si = dae["up_stem1"]["w"], dae["score_input"]["w"], dae["score_input"]["b"]
    hh, ww = int(y.shape[1]), int(y.shape[2])

    def kernel():
        u, v, eps = tail_terms(dae, y, s_half, compute_dtype=cd, all_bf16=all_bf16)
        return refine_tail(u, y, eps, v=v)

    if not all_bf16:
        def ops():
            u = conv_transpose2d(s_half, w_up, stride=2)[:, :hh, :ww]
            r = torch.softmax((u + conv2d(y.to(cd), w_si, b_si, padding="SAME")).float(), -1)
            return (1 - EPS) * y + EPS * r

        return [("tail: deconv+conv3x3+softmax+update (f32 y)", ops),
                ("tail: deconv+conv3x3 + refine_tail (K3) (f32 y)", kernel)]
    eps16 = bf16(EPS)  # jnp.bfloat16(0.1), and 1 - it rounded in bf16 as JAX does

    def ops16():
        u = conv_transpose2d(s_half, w_up, stride=2)[:, :hh, :ww]
        r = torch.softmax(u + conv2d(y, w_si, b_si, padding="SAME"), -1)
        return bf16(1 - eps16) * y + eps16 * r

    return [("tail all-bf16 state", ops16), ("tail all-bf16 state + refine_tail (K3)", kernel)]


def op_cases(dae: dict, dae0: dict, y: torch.Tensor, h: dict, s_half: torch.Tensor, yh: torch.Tensor, *, depth: int,
             compute_dtype):
    """``[(label, fn)]``: one dae_apply, the four tail rows (``tail_maps``
    at an f32 and a bf16 iterate), the stem's avg-pools and the mid-res
    encoder/decoder; ``y`` the f32 probabilities, ``h`` the pool4 tap."""
    from iterative_inference_segm_tpu_torch.models.dae import dae_apply
    from iterative_inference_segm_tpu_torch.ops.conv import avg_pool

    cd = compute_dtype
    y16 = y.to(cd)
    tails = [(label, lambda fn=fn: (fn(),)) for yy, all_bf16 in ((y, False), (y16, True))
             for label, fn in tail_maps(dae, yy, s_half, compute_dtype=cd, all_bf16=all_bf16)]
    return [
        ("one dae_apply (f32 y in)", lambda: (dae_apply(dae, y, h, depth=depth, compute_dtype=cd),)),
        *tails,
        ("stem avg_pool f32->bf16 @/1", lambda: (avg_pool(y.to(cd), window=2, stride=2),)),
        ("stem avg_pool bf16 @/1", lambda: (avg_pool(y16, window=2, stride=2),)),
        ("mid-res enc+dec (stem0 dae on half-res)",
         lambda: (dae_apply(dae0, yh, {"pool3": h["pool4"]}, depth=depth, compute_dtype=cd),)),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8

    args = parse_args(argv)
    run = ProbeRun("pipeline_probe", args)
    dev, b, cd = run.device, args.batch, torch.bfloat16
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=FC_CHANNELS, device=dev)
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=C, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                   depth=args.depth, stem_pool=args.stem_pool, device=dev)
    dae0 = init_dae(torch.Generator().manual_seed(2), n_classes=C, h_specs={"pool3": 512}, depth=args.depth,
                    stem_pool=0, device=dev)
    x = run.normal((b, H, W, 3), 0)
    with torch.inference_mode():
        t = {label: run.time(label, fn, b) for label, fn in pipeline_cases(fcn, dae, x, depth=args.depth,
                                                                           compute_dtype=cd)}
        run.derived("marginal per step", (t["pipeline K=5"] - t["pipeline K=1"]) / 4, b)
        run.derived("first step", t["pipeline K=1"] - t["pipeline K=0"], b)
        y = torch.softmax(run.normal((b, H, W, C), 1), -1)
        _, h = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd)
        s_half = run.normal((b, H // 2, W // 2, C), 2, cd)
        yh = run.normal((b, H // 2, W // 2, C), 3, cd)
        for label, fn in op_cases(dae, dae0, y, h, s_half, yh, depth=args.depth, compute_dtype=cd):
            run.time(label, fn, b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
