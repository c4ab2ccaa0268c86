"""Can the half engine's per-step tail get cheaper by conv folding? The twin
of the repo's ``tools/tailfold_probe.py`` on the card.

Batch 128, C = 11, the pooled scale 180x240 of 360x480, bf16, the stem-1
depth-3 DAE whose pool4 conditioning is folded into a bottleneck bias
``hb`` (128, 23, 30, 128). ``out`` is a 1x1 linear map of a sum, so it
composes into the kernels that feed it. The JAX probe's rows, with its
labels, each one step (core + tail + softmax + blend) and a K = 5 loop:

  v0: the unfolded tail: up1, score_enc1 + add, out, score_input + add,
      softmax + blend;
  v1: ``out`` folded into up1' and score_enc1';
  v2: v1 with score_enc1' and score_input merged into one 3x3 conv over
      ``cat(skip1, x)`` (the port's half engine's step).

Beside them, one row of the port's own: its folded step as
``inference.fused`` runs it (``dae_core(predense=True)``, then the
deconv and the merged 3x3 conv, then one launch of K3,
``ops.refine_tail``, for the crop, add, softmax and blend, at the engine's
eps 0.1).

Checks, asserted as ``check`` lines (f32, TF32 off, through ``ops.conv`` as
every f32 conv of the port): v1 and v2 against v0 within 1e-3 (the JAX
probe's assert), and the port's folded step against v2 within 1e-5.

Weights: ``init_dae`` from seed 1, then the four transposed convs (up1..3,
up_stem1) re-drawn as 0.1 N(0, 1) so that the checks are not trivial. The
JAX probe draws them from ``PRNGKey(hash(name) % 2**31)``, and a ``str``
hash changes from one process to the next, so its weights are not
reproducible; the twin draws each from a fixed seed (``DECONV_SEEDS``). The
folded kernels are ``inference.fused.fold_half_tail``'s: the JAX probe's
``folded_kernels`` composed in f32, in the port's layouts (OIHW convs,
flipped (I, O, k, k) transposed convs), cast at use as the JAX probe casts
them to the params' dtype. The blend's constant is the JAX row's
``jnp.asarray(0.1, x.dtype)`` (``timing.bf16`` in bf16). Each row's scalar
is the JAX row's f32 sum of the new iterate. Timing and lines as
``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.tailfold_probe [--iters 10]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, bf16, probe_parser

B, C = 128, 11
H2, W2 = 180, 240  # the pooled scale of 360x480
EPS = 0.1
DECONV_SEEDS = {"up1": 11, "up2": 12, "up3": 13, "up_stem1": 14}
FOLD_TOL = 1e-3  # the JAX probe's assert: f32 reassociation of the composed mix
PORT_TOL = 1e-5  # the port's folded step against v2, f32


def bottleneck_hw(h: int, w: int) -> tuple[int, int]:
    """The /8 of the pooled map (ceil-mode pools): 23x30 at 180x240."""
    return -(-h // 8), -(-w // 8)


def probe_dae(device, dtype=torch.float32) -> dict:
    """The probe's DAE: ``init_dae`` (seed 1, the pool4 tap, stem 1, depth
    3), its transposed convs drawn from ``DECONV_SEEDS``."""
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae

    dae = init_dae(torch.Generator().manual_seed(1), n_classes=C, h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3,
                   stem_pool=1, device=device)
    for name, seed in DECONV_SEEDS.items():
        w = dae[name]["w"]
        dae[name] = {"w": 0.1 * torch.randn(tuple(w.shape), generator=torch.Generator().manual_seed(seed)).to(device)}
    return {k: {kk: t.to(dtype) for kk, t in v.items()} for k, v in dae.items()}


def _eps(x: torch.Tensor) -> float:
    return bf16(EPS) if x.dtype == torch.bfloat16 else EPS


def encoder(p: dict, x: torch.Tensor, hb: torch.Tensor):
    """The pool encoder and the bottleneck with ``hb`` as its bias: the
    bottleneck's first ``hb``-channels inputs are the encoder's."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, crop_to, max_pool

    skips, h = [], x
    for i in range(3):
        q = p[f"enc{i + 1}"]
        h = torch.relu(conv2d(h, q["w"], q["b"], padding="SAME"))
        skips.append(h)
        h = max_pool(h, window=2, stride=2, ceil_mode=True)
    q = p["bottleneck"]
    cx = int(hb.shape[-1])
    h = torch.relu(conv2d(h, q["w"][:, :cx], q["b"], padding="SAME")
                   + crop_to(hb, int(h.shape[1]), int(h.shape[2])).to(h.dtype))
    return h, skips


def decode_to_predense(p: dict, h: torch.Tensor, skips: list) -> torch.Tensor:
    """The decoder up to up1's input (90x120, C channels at full width)."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, conv_transpose2d, crop_to

    q = p["score_bottleneck"]
    s = conv2d(h, q["w"], q["b"], padding="SAME")
    for i in (2, 1):
        s = conv_transpose2d(s, p[f"up{i + 1}"]["w"], stride=2)
        q = p[f"score_enc{i + 1}"]
        sk = conv2d(skips[i], q["w"], q["b"], padding="SAME")
        s = crop_to(s, int(sk.shape[1]), int(sk.shape[2])) + sk
    return s


def _blend(x: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    r = torch.softmax(logits, -1)
    eps = _eps(x)
    return x - eps * (x - r)


def step_v0(p: dict, fk: dict, x: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, conv_transpose2d, crop_to

    h, skips = encoder(p, x, hb)
    u = decode_to_predense(p, h, skips)
    s = conv_transpose2d(u, p["up1"]["w"], stride=2)
    q = p["score_enc1"]
    sk = conv2d(skips[0], q["w"], q["b"], padding="SAME")
    s = crop_to(s, int(sk.shape[1]), int(sk.shape[2])) + sk
    q = p["out"]
    s = conv2d(s, q["w"], q["b"], padding="SAME")
    q = p["score_input"]
    return _blend(x, s + conv2d(x, q["w"], q["b"], padding="SAME"))


def step_v1(p: dict, fk: dict, x: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, conv_transpose2d, crop_to

    h, skips = encoder(p, x, hb)
    u = decode_to_predense(p, h, skips)
    s = conv_transpose2d(u, fk["up1p"], stride=2)
    sk = conv2d(skips[0], fk["se1p_w"], fk["bp"], padding="SAME")
    s = crop_to(s, int(sk.shape[1]), int(sk.shape[2])) + sk
    q = p["score_input"]
    return _blend(x, s + conv2d(x, q["w"], q["b"], padding="SAME"))


def step_v2(p: dict, fk: dict, x: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, conv_transpose2d, crop_to

    h, skips = encoder(p, x, hb)
    u = decode_to_predense(p, h, skips)
    s = conv_transpose2d(u, fk["up1p"], stride=2)
    cat = torch.cat([skips[0], x.to(skips[0].dtype)], dim=-1)
    sk = conv2d(cat, fk["cat_w"], fk["cat_b"], padding="SAME")
    return _blend(x, crop_to(s, int(sk.shape[1]), int(sk.shape[2])) + sk)


def port_step_terms(p: dict, fk: dict, x: torch.Tensor, hb: torch.Tensor):
    """``(u, v, b)`` of the port's folded step (``inference.fused``'s
    ``_folded_step_terms`` over ``dae_core(predense=True)`` with ``hb`` as
    the bottleneck's conditioning bias): what it hands K3."""
    from iterative_inference_segm_tpu_torch.inference.fused import _folded_step_terms
    from iterative_inference_segm_tpu_torch.models.dae import dae_core

    pre, skip1 = dae_core(p, x, {}, depth=3, stem_pool=1, bottleneck_h=(hb, tuple(hb.shape[1:3]), {}),
                          predense=True)
    return _folded_step_terms(fk, pre, skip1, x, encoder="pool")


def step_port(p: dict, fk: dict, x: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    """The port's folded step: one launch of K3 on a CUDA tensor."""
    from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail

    u, v, b = port_step_terms(p, fk, x, hb)
    return refine_tail(u, x, EPS, v=v, b=b)


STEPS = (("v0", step_v0), ("v1", step_v1), ("v2", step_v2))
PORT_LABEL = "step v2 as the port runs it (dae_core predense + folded terms + refine_tail (K3))"


def cases(p: dict, fk: dict, x: torch.Tensor, hb: torch.Tensor):
    """``[(label, fn)]``: each variant's step, the port's step, each
    variant's K = 5 loop; ``fn()`` returns the new iterate."""
    def loop(step):
        def fn():
            y = x
            for _ in range(5):
                y = step(p, fk, y, hb)
            return (y,)
        return fn

    steps = dict(STEPS)
    return [
        ("step v0 (current)", lambda: (step_v0(p, fk, x, hb),)),
        ("step v1 (out folded)", lambda: (step_v1(p, fk, x, hb),)),
        ("step v2 (out folded + concat-merged tail)", lambda: (step_v2(p, fk, x, hb),)),
        (PORT_LABEL, lambda: (step_port(p, fk, x, hb),)),
        ("K=5 scan v0", loop(steps["v0"])),
        ("K=5 scan v1", loop(steps["v1"])),
        ("K=5 scan v2", loop(steps["v2"])),
    ]


def fold_errors(p: dict, x: torch.Tensor, hb: torch.Tensor) -> dict:
    """The checks in f32: max abs error of v1 and v2 against v0, and of the
    port's folded step against v2."""
    from iterative_inference_segm_tpu_torch.inference.fused import fold_half_tail

    p32 = {k: {kk: t.float() for kk, t in v.items()} for k, v in p.items()}
    xf, hf = x.float(), hb.float()
    fk = fold_half_tail(p32)
    v0 = step_v0(p32, fk, xf, hf)
    v2 = step_v2(p32, fk, xf, hf)
    return {"v1": (step_v1(p32, fk, xf, hf) - v0).abs().max().item(), "v2": (v2 - v0).abs().max().item(),
            "port": (step_port(p32, fk, xf, hf) - v2).abs().max().item()}


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.inference.fused import fold_half_tail

    args = probe_parser(__doc__, iters=10, repeats=3).parse_args(argv)
    run = ProbeRun("tailfold_probe", args)
    dev, dt = run.device, torch.bfloat16
    dae = probe_dae(dev)
    x = torch.softmax(run.normal((B, H2, W2, C), 0), -1).to(dt)
    hb = run.normal((B, *bottleneck_hw(H2, W2), int(dae["bottleneck"]["w"].shape[0])), 2, dt)
    with torch.inference_mode():
        errs = fold_errors(dae, x, hb)
        run.check("fold correctness (f32 max abs err): v1", errs["v1"], FOLD_TOL)
        run.check("fold correctness (f32 max abs err): v2", errs["v2"], FOLD_TOL)
        run.check("port folded step vs v2 (f32 max abs err)", errs["port"], PORT_TOL)
        daeb = probe_dae(dev, dt)
        fk = fold_half_tail(daeb)
        for label, fn in cases(daeb, fk, x, hb):
            run.time(label, fn, B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
