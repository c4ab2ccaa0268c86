"""Pooled-scale refinement engine (half / quarter): port of the main-path
subset of ``iterative_inference_segm_tpu.inference.fused``.

The engine runs K refinement steps on the class map avg-pooled to the DAE's
stem scale (/2 for stem_pool=1, the "half" engine; /4 for stem_pool=2, the
"quarter" engine), then one full-resolution rectification:

    x_0     = avg_pool^sp(y_0)
    x_{k+1} = blend(x_k, softmax(core(x_k) + si_h(x_k)), eps)
    y_K     = blend(y_0, softmax(up(core(x_K)) + si(y_0)), eps)

``lax.scan`` becomes a Python loop of K steps. Every score-mode softmax +
blend (K per-step ones and the rectification's, which also emits the argmax
labels) runs in ``ops.refine_tail``: the per-step crop + add of the two
convolution outputs, the softmax, the blend and the argmax are one pass of
the hand-written kernel on a CUDA tensor. The convolutions stay on cuDNN.

Blend forms. The JAX package writes the update as ``x - eps * (x - r)``;
the kernel computes ``(1 - eps) * x + eps * r`` in f32 and rounds once on
the store. In f32 the two agree to a few ulps. In bf16 the JAX form rounds
three times (and holds ``eps`` itself in bf16: 0.1 becomes 0.10009765625),
so one step differs by at most 2^-8 = 0.0039, one bf16 ulp on [0.5, 1);
measured on the CPU with torch's bf16 arithmetic over 10^6 random C=11
pixels: mean |diff| 3.8e-5, 16% of values differ, argmax agreement
99.986%. The bf16 tests tolerate this.

Both tails ('full', and the separable 'sep' whose per-step and
rectification logits reach the kernel whole) and both update rules: score
steps go through the kernel; energy steps differentiate ``0.5 * ||x -
r(x)||^2`` through the denoiser with ``torch.autograd.grad`` in plain
PyTorch and launch no kernel. Energy mode needs autograd, so it runs under
``torch.no_grad`` (it enables grad locally), never ``torch.inference_mode``.
Folding stays score-mode and 'full'-tail only. The phase-major ``fused``
engine is not ported (ROADMAP.md, "Not ported").
"""

from __future__ import annotations

from typing import Callable

import torch

from iterative_inference_segm_tpu_torch.models.dae import (
    dae_core,
    dae_septail_logits,
    dae_stem_pool_of,
    dae_tail_of,
    precompute_bottleneck_h,
)
from iterative_inference_segm_tpu_torch.ops.conv import (
    avg_pool,
    conv2d,
    conv2d_depthwise,
    conv_transpose2d,
    crop_to,
)
from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail


def check_mode(mode: str) -> None:
    if mode not in ("score", "energy"):
        raise ValueError(f"unknown mode {mode!r}; expected 'score' or 'energy'")


def energy_gradient(denoise: Callable[[torch.Tensor], torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    """``d/dy 0.5 * ||y - denoise(y)||^2`` by ``torch.autograd.grad`` through
    the denoiser (the JAX package's ``jax.grad`` of the same energy). Runs
    with grad enabled locally; under ``torch.inference_mode`` autograd cannot
    run, so that raises. Where grad is enabled by the caller (a gradient
    taken through the refinement, as through the pipeline's refinement
    stage), the gradient is built with ``create_graph`` at a new node over
    ``y`` (a view), so that it can be differentiated in turn: the inner
    gradient counts only the paths through that node, and what ``denoise``
    closes over stays a constant of it, as in JAX's ``jax.grad`` of the
    energy, even where it depends on ``y`` upstream. Under
    ``torch.no_grad`` it is a plain value of a detached ``y``."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError(
            "energy mode differentiates through the DAE: run it under torch.no_grad(), "
            "not torch.inference_mode()"
        )
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        yy = y.view_as(y) if outer and y.requires_grad else y.detach().requires_grad_(True)
        energy = 0.5 * torch.sum(torch.square(yy - denoise(yy)))
        (g,) = torch.autograd.grad(energy, yy, create_graph=outer)
    return g


def no_autograd(mode: str):
    """The context a refinement runs in: ``torch.inference_mode`` for score
    mode; ``torch.no_grad`` for energy mode, whose gradient steps enable
    autograd locally (inference tensors cannot enter autograd)."""
    check_mode(mode)
    return torch.no_grad() if mode == "energy" else torch.inference_mode()


def _height(x: torch.Tensor, space) -> int:
    return int(x.shape[1]) if space is None else space.height


def _rows_for_kernel(u: torch.Tensor, height: int, space) -> torch.Tensor:
    """Under H sharding, the rows of ``u`` (laid out as ``space``) that
    cover the band of a ``height``-row map: the global centre crop in H,
    done before ``refine_tail``, which then crops W alone (its offsets
    are local). Without ``space``, ``u`` as it is: the kernel crops."""
    return u if space is None else crop_to(u, height, int(u.shape[2]), space=space)


def half_logits(params: dict, x: torch.Tensor, s: torch.Tensor, *, space=None) -> torch.Tensor:
    """Pooled-scale tail logits; ``s`` = dae_core(x). 'full': ``s +
    score_input(x)``; 'sep': ``mix(s + dw3x3(x))``. ``space``: the layout
    of an H-sharded ``x`` (``parallel.spatial.Rows``)."""
    if dae_tail_of(params) == "sep":
        d = conv2d_depthwise(x, params["score_input_dw"]["w"], space=space)
        p = params["mix"]
        return conv2d(s + d, p["w"], p["b"], padding="SAME", space=space)
    p = params["score_input"]
    return s + conv2d(x, p["w"], p["b"], padding="SAME", space=space)


def _half_step_terms(params: dict, x: torch.Tensor, s: torch.Tensor, space=None):
    """``(u, v)`` with ``half_logits = u + v`` for the kernel: the 'full'
    tail's two addends, or the 'sep' tail's whole logits and no ``v``."""
    if dae_tail_of(params) == "sep":
        return half_logits(params, x, s, space=space), None
    p = params["score_input"]
    return s, conv2d(x, p["w"], p["b"], padding="SAME", space=space)


def _full_tail_terms(params: dict, s_k: torch.Tensor, y: torch.Tensor, space=None):
    """``(u, v)`` with ``full_logits = crop_to(u, H, W) + v``: for the 'full'
    tail ``u`` the uncropped ``up_stem`` deconv chain of ``s_k`` and ``v``
    score_input on y; for the 'sep' tail (the channel mix comes after the
    crop and add) ``u`` the whole logits and no ``v``. ``space``: the
    layout of an H-sharded ``y``; ``u`` is then cropped in H already."""
    if dae_tail_of(params) == "sep":
        return dae_septail_logits(params, s_k, y.to(s_k.dtype), space=space), None
    u = s_k
    us = space and space.scaled(dae_stem_pool_of(params))
    for j in range(dae_stem_pool_of(params)):
        u = conv_transpose2d(u, params[f"up_stem{j + 1}"]["w"], stride=2, space=us)
        us = us and us.at(2 * us.height)
    p = params["score_input"]
    return (_rows_for_kernel(u, _height(y, space), us),
            conv2d(y.to(u.dtype), p["w"], p["b"], padding="SAME", space=space))


def full_logits(params: dict, s_k: torch.Tensor, y: torch.Tensor, *, space=None) -> torch.Tensor:
    """Full-resolution rectification logits: the DAE's stem tail applied
    once (``up_stem`` chain back to /1 + score_input on y, or the 'sep'
    tail). ``space`` as in ``_full_tail_terms``."""
    u, v = _full_tail_terms(params, s_k, y, space)
    u = crop_to(u, _height(y, space), int(y.shape[2]), space=space)
    return u if v is None else u + v


def fold_half_tail(params: dict, *, encoder: str = "pool") -> dict:
    """Compose the per-step tail's linear ops into fewer convolutions
    (``out`` folds into ``up1`` and ``score_enc1``; for the pool encoder
    ``score_enc1'`` and ``score_input`` merge into one 3x3 conv over
    ``concat(skip1, x)``). Kernels are composed and kept in f32, in the
    port's layouts (OIHW convs, flipped (I, O, k, k) transposed convs)."""
    if dae_tail_of(params) != "full" or dae_stem_pool_of(params) < 1:
        raise ValueError("fold_half_tail requires a stem_pool>=1, tail='full' DAE")
    f32 = torch.float32
    w_out = params["out"]["w"][:, :, 0, 0].to(f32)  # (C_out, C_mid)
    b_out = params["out"]["b"].to(f32)
    up1p = torch.einsum("imhw,om->iohw", params["up1"]["w"].to(f32), w_out)
    si_w = params["score_input"]["w"].to(f32)  # (C, C, 3, 3)
    si_b = params["score_input"]["b"].to(f32)
    fk = {"up1p": up1p, "b_out": b_out, "si_w": si_w, "si_b": si_b}
    if encoder == "pool":
        se1_w = params["score_enc1"]["w"].to(f32)  # (C_mid, c1, 1, 1)
        se1p_w = torch.einsum("om,mihw->oihw", w_out, se1_w)
        bp = w_out @ params["score_enc1"]["b"].to(f32) + b_out
        c1 = int(se1_w.shape[1])
        cat_w = torch.zeros((si_w.shape[0], c1 + si_w.shape[1], 3, 3), dtype=f32, device=si_w.device)
        cat_w[:, :c1, 1, 1] = se1p_w[:, :, 0, 0]
        cat_w[:, c1:] = si_w
        fk.update(se1p_w=se1p_w, bp=bp, cat_w=cat_w, cat_b=bp + si_b)
    return fk


def _folded_step_terms(fk: dict, pre, skip1, x, *, encoder: str, space=None):
    """``(u, v, b)`` with ``folded_step_logits = crop_to(u) + b + v``;
    ``space`` the layout of an H-sharded ``x`` (``pre`` at ``space.
    scaled(1)``), ``u`` then cropped in H already."""
    half = space and space.scaled(1)
    u = conv_transpose2d(pre, fk["up1p"], stride=2, space=half)
    u = _rows_for_kernel(u, _height(x, space), half and half.at(2 * half.height))
    if encoder == "pool":
        cat = torch.cat([skip1, x.to(skip1.dtype)], dim=-1)
        return u, conv2d(cat, fk["cat_w"], fk["cat_b"], padding="SAME", space=space), None
    return u, conv2d(x, fk["si_w"], fk["si_b"], padding="SAME", space=space), fk["b_out"]


def folded_step_logits(fk: dict, pre, skip1, x, *, encoder: str, space=None) -> torch.Tensor:
    """Per-step denoiser logits from the predense core state (== out(core) +
    score_input(x) by linearity; see ``fold_half_tail``)."""
    u, v, b = _folded_step_terms(fk, pre, skip1, x, encoder=encoder, space=space)
    s = crop_to(u, _height(x, space), int(v.shape[2]), space=space)
    if b is not None:
        s = s + b.to(s.dtype)
    return s + v


def folded_core_out(fk: dict, pre, skip1, *, encoder: str, out_hw: tuple[int, int], space=None):
    """The standard core output (dae_core's post-``out`` result) recovered
    from the predense state, for the rectification's ``full_logits``;
    ``space`` the layout of the core's H-sharded input (``out_hw``
    global)."""
    half = space and space.scaled(1)
    s = conv_transpose2d(pre, fk["up1p"], stride=2, space=half)
    up = half and half.at(2 * half.height)
    if encoder == "pool":
        sk = conv2d(skip1, fk["se1p_w"], fk["bp"], padding="SAME", space=space)
        return crop_to(s, _height(sk, space), int(sk.shape[2]), space=up) + sk
    return crop_to(s, out_hw[0], out_hw[1], space=up) + fk["b_out"].to(s.dtype)


def _pooled_carry(params: dict, y0: torch.Tensor, state_dtype, space=None):
    """Validate the engine's preconditions (stem_pool>=1 DAE, H and W
    divisible by the pooling factor) and build ``x0 = avg_pool^sp(y0)``.
    Returns ``(sp, state_dtype, x0)``; ``space`` the layout of an H-sharded
    ``y0`` (``x0`` at ``space.scaled(sp)``)."""
    sp = dae_stem_pool_of(params)
    if sp < 1:
        raise ValueError("half engine requires a stem_pool>=1 DAE")
    if state_dtype is None:
        state_dtype = y0.dtype
    h, w = _height(y0, space), int(y0.shape[2])
    if h % (1 << sp) or w % (1 << sp):
        raise ValueError(f"half engine requires H, W divisible by {1 << sp}")
    x0 = y0.to(state_dtype)
    for j in range(sp):
        x0 = avg_pool(x0, window=2, stride=2, space=space and space.scaled(j))
    return sp, state_dtype, x0


def _half_denoise(params: dict, core_fn: Callable, x: torch.Tensor, state_dtype, space=None) -> torch.Tensor:
    """The pooled engine's per-step denoiser ``r(x) = softmax(core(x) +
    tail_h(x))``, in plain PyTorch (differentiable)."""
    s = core_fn(x).to(state_dtype)
    return torch.softmax(half_logits(params, x, s, space=space), -1)


def half_step_gradient(
    params: dict,
    core_fn: Callable,
    x: torch.Tensor,
    *,
    mode: str,
    state_dtype,
    space=None,
) -> torch.Tensor:
    """Refinement gradient at the pooled scale, in plain PyTorch: ``x -
    r(x)`` ('score') or ``d/dx 0.5 * ||x - r(x)||^2`` through the pooled
    denoiser ('energy'). The engine's score steps take the kernel instead.
    ``space``: the layout of an H-sharded ``x``."""
    check_mode(mode)
    if mode == "score":
        return x - _half_denoise(params, core_fn, x, state_dtype, space)
    return energy_gradient(lambda xx: _half_denoise(params, core_fn, xx, state_dtype, space), x)


def full_rect_gradient(params: dict, s_k: torch.Tensor, y: torch.Tensor, *, mode: str, space=None) -> torch.Tensor:
    """Gradient of the one full-resolution rectification step; ``s_k`` is a
    constant of it (energy mode carries the tail's Jacobian only).
    ``space``: the layout of an H-sharded ``y``."""
    check_mode(mode)

    def denoise(yy):
        return torch.softmax(full_logits(params, s_k, yy, space=space), -1)

    if mode == "score":
        return y - denoise(y)
    return energy_gradient(denoise, y)


def _rectify(params, s_k, y0, eps, state_dtype, with_labels, mode="score", space=None):
    """The one full-resolution step: in score mode the kernel over
    ``full_logits``' terms; in energy mode the plain gradient step."""
    y0s = y0.to(state_dtype)
    s_k = s_k.to(state_dtype)
    if mode == "score":
        u, v = _full_tail_terms(params, s_k, y0s, space)
        return refine_tail(u, y0s, eps, v=v, with_labels=with_labels)
    y = y0s - eps * full_rect_gradient(params, s_k, y0s, mode=mode, space=space)
    return (y, torch.argmax(y, dim=-1).to(torch.int32)) if with_labels else y


def halfres_refinement_scan(
    params: dict,
    core_fn: Callable[[torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    *,
    eps: float,
    num_steps: int,
    state_dtype=None,
    mode: str = "score",
    with_labels: bool = False,
    space=None,
):
    """K steps on the pooled class map + one full-res rectification
    (unfolded tail, either tail). Returns ``y_K`` at ``state_dtype``, or
    ``(y_K, labels)`` with ``with_labels``. Score steps launch the kernel;
    energy steps are ``x - eps * grad`` in plain PyTorch. ``space``: the
    layout of an H-sharded ``y0``."""
    check_mode(mode)
    sp, state_dtype, x = _pooled_carry(params, y0, state_dtype, space)
    xs = space and space.scaled(sp)
    for _ in range(num_steps):
        if mode == "score":
            u, v = _half_step_terms(params, x, core_fn(x).to(state_dtype), xs)
            x = refine_tail(u, x, eps, v=v)
        else:
            x = x - eps * half_step_gradient(params, core_fn, x, mode=mode, state_dtype=state_dtype, space=xs)
    return _rectify(params, core_fn(x), y0, eps, state_dtype, with_labels, mode, space)


def halfres_refinement_scan_folded(
    params: dict,
    predense_fn: Callable[[torch.Tensor], tuple],
    y0: torch.Tensor,
    *,
    eps: float,
    num_steps: int,
    state_dtype=None,
    encoder: str = "pool",
    with_labels: bool = False,
    space=None,
):
    """Score-mode engine with the folded per-step tail (``fold_half_tail``).
    ``predense_fn(x) -> (pre, skip1)`` is ``dae_core(..., predense=True)``.
    Returns ``y_K`` or ``(y_K, labels)``. ``space``: the layout of an
    H-sharded ``y0``."""
    sp, state_dtype, x = _pooled_carry(params, y0, state_dtype, space)
    xs = space and space.scaled(sp)
    fk = fold_half_tail(params, encoder=encoder)
    for _ in range(num_steps):
        pre, sk1 = predense_fn(x)
        u, v, b = _folded_step_terms(fk, pre, sk1, x, encoder=encoder, space=xs)
        # bf16 u beside an f32 state is widened in the kernel, not cast here
        u = u if u.dtype == torch.bfloat16 else u.to(state_dtype)
        x = refine_tail(u, x, eps, v=v.to(state_dtype), b=b)
    pre, sk1 = predense_fn(x)
    s_k = folded_core_out(
        fk, pre, sk1, encoder=encoder, out_hw=(_height(x, xs), int(x.shape[2])), space=xs
    )
    return _rectify(params, s_k, y0, eps, state_dtype, with_labels, space=space)


def _resolve_fold(dae_params: dict, mode: str, fold_tail: bool | None) -> bool:
    check_mode(mode)
    legal = mode == "score" and dae_tail_of(dae_params) == "full"
    if fold_tail is None:
        return legal
    if fold_tail and not legal:
        raise ValueError("fold_tail requires score mode and tail='full'")
    return fold_tail


def halfres_refine(
    dae_params: dict,
    y0: torch.Tensor,
    h,
    in_hw: tuple[int, int],
    *,
    eps: float,
    num_steps: int,
    depth: int,
    compute_dtype,
    state_dtype=None,
    encoder: str = "pool",
    mode: str = "score",
    fold_tail: bool | None = None,
    with_labels: bool = False,
    space=None,
):
    """The pooled-engine refinement from a precomputed FCN forward (shared
    by ``flagship_forward_fn`` and ``Predictor``). ``in_hw`` is the full
    resolution; stem_pool comes from the param tree; ``fold_tail=None``
    folds whenever legal (score mode, 'full' tail). ``space``: the layout
    of an H-sharded ``y0`` (``in_hw`` global, the taps laid out as
    ``space.scaled(k)``); the result is this rank's band."""
    fold_tail = _resolve_fold(dae_params, mode, fold_tail)
    sp = dae_stem_pool_of(dae_params)
    xs = space and space.scaled(sp)
    bh = precompute_bottleneck_h(
        dae_params, h, depth=depth, stem_pool=sp, in_hw=(in_hw[0] >> sp, in_hw[1] >> sp), space=xs
    )
    state_dtype = state_dtype or compute_dtype
    if fold_tail:

        def predense_fn(x_half):
            return dae_core(
                dae_params, x_half.to(compute_dtype), bh[2], depth=depth, stem_pool=sp,
                bottleneck_h=bh, encoder=encoder, predense=True, space=xs,
            )

        return halfres_refinement_scan_folded(
            dae_params, predense_fn, y0, eps=eps, num_steps=num_steps,
            state_dtype=state_dtype, encoder=encoder, with_labels=with_labels, space=space,
        )

    def core_fn(x_half):
        return dae_core(
            dae_params, x_half.to(compute_dtype), bh[2], depth=depth, stem_pool=sp,
            bottleneck_h=bh, encoder=encoder, space=xs,
        )

    return halfres_refinement_scan(
        dae_params, core_fn, y0, eps=eps, num_steps=num_steps,
        state_dtype=state_dtype, mode=mode, with_labels=with_labels, space=space,
    )


def flagship_forward_fn(
    *,
    fcn_apply: Callable | None = None,
    eps: float = 0.1,
    num_steps: int = 5,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 3,
    compute_dtype=torch.bfloat16,
    state_dtype=None,
    encoder: str = "pool",
    mode: str = "score",
    fold_tail: bool | None = None,
    with_labels: bool = False,
    space_group=None,
) -> Callable:
    """The flagship pipeline as one function: ``forward(fcn_params,
    dae_params, x) -> (y0, y_k)`` (``(y0, y_k, labels)`` with
    ``with_labels``): FCN-8 forward with the conditioning taps, K pooled-map
    steps at the DAE's stem scale, one full-res rectification.
    ``fold_tail=None`` folds whenever legal (the JAX default, True, would
    run energy mode as folded score steps). ``space_group``: H is sharded
    over this group ('space'); ``x`` is this rank's equal band of rows
    (``parallel.sharding.shard_batch(..., spatial_axis='space')``), and so
    are the outputs."""
    check_mode(mode)
    if fcn_apply is None:
        from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply as fcn_apply

    def forward(fcn_params, dae_params, x):
        space, on_rows = None, {}
        if space_group is not None:
            from iterative_inference_segm_tpu_torch.parallel.spatial import rows_of

            space = rows_of(space_group, x)
            on_rows = {"space": space}
        y0, h = fcn_apply(
            fcn_params, x, return_features=h_taps, compute_dtype=compute_dtype,
            probs_dtype=state_dtype or compute_dtype, **on_rows,
        )
        out = halfres_refine(
            dae_params, y0, h, (_height(x, space), int(x.shape[2])),
            eps=eps, num_steps=num_steps, depth=depth, compute_dtype=compute_dtype,
            state_dtype=state_dtype, encoder=encoder, mode=mode, fold_tail=fold_tail,
            with_labels=with_labels, space=space,
        )
        return (y0, *out) if with_labels else (y0, out)

    return forward


def fused_refinement_scan(*args, **kwargs):
    """The phase-major engine is a TPU lane-padding layout (ROADMAP.md, "Not
    ported"); the half engine above is the port's throughput path."""
    raise NotImplementedError("the phase-major 'fused' engine is not ported (ROADMAP.md)")


def make_fused_refiner(*args, **kwargs):
    """See ``fused_refinement_scan``."""
    raise NotImplementedError("the phase-major 'fused' engine is not ported (ROADMAP.md)")


def make_half_refiner(
    fcn_apply: Callable,
    fcn_params: dict,
    dae_params: dict,
    *,
    eps: float,
    num_steps: int,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 3,
    compute_dtype=torch.float32,
    state_dtype=None,
    encoder: str = "pool",
    mode: str = "score",
    fold_tail: bool | None = None,
    space_group=None,
) -> Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Image batch -> ``(y0, yK)`` via the pooled engine, over fixed params
    (the JAX version's jit has no counterpart: PyTorch runs eagerly).
    ``space_group`` as in ``flagship_forward_fn``."""
    forward = flagship_forward_fn(
        fcn_apply=fcn_apply, eps=eps, num_steps=num_steps, h_taps=h_taps, depth=depth,
        compute_dtype=compute_dtype, state_dtype=state_dtype, encoder=encoder, mode=mode,
        fold_tail=fold_tail, space_group=space_group,
    )
    _resolve_fold(dae_params, mode, fold_tail)

    def refine(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with no_autograd(mode):
            return forward(fcn_params, dae_params, x)

    return refine
