"""The general refinement engine: K score or energy steps of the DAE at full
resolution (port of ``iterative_inference_segm_tpu.inference.iterative``).

Starting from the FCN-8 softmax ``y0``, each step follows the conditional
score that the DAE estimates,

    y_{k+1} = y_k - eps * g(y_k)
    g = y - r(y)                               (mode 'score')
    g = d/dy 0.5 * ||y - r(y)||^2               (mode 'energy')

with ``r(y) = softmax(logits_fn(y))``. ``logits_fn`` is the DAE forward up
to its logits (``models.dae.dae_logits`` closed over the params and the
conditioning taps): the softmax belongs to the step. A score step is one
launch of the hand-written tail kernel on a CUDA tensor, ``refine_tail(u =
f32 logits, y, eps)``: softmax, then ``(1 - eps) y + eps r`` rounded once
(the JAX package's ``y - eps (y - r)``, equal to a few f32 ulps). The
iterate stays in f32, as in the JAX package. An energy step differentiates
the energy through the DAE with ``torch.autograd.grad`` in plain PyTorch
and launches no kernel; it needs autograd, so it runs under
``torch.no_grad`` (``fused.no_autograd``), never ``torch.inference_mode``.
``renorm='softmax'`` re-projects each iterate onto the simplex,
``softmax(log(clip(y, 1e-8)))``, in plain PyTorch.

``lax.scan`` becomes a Python loop; ``jax.jit`` has no counterpart.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from iterative_inference_segm_tpu_torch.inference.fused import (
    check_mode,
    energy_gradient,
    no_autograd,
)
from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail


def _check_renorm(renorm: str) -> None:
    if renorm not in ("none", "softmax"):
        raise ValueError(f"unknown renorm {renorm!r}")


def _step_gradient(
    logits_fn: Callable[[torch.Tensor], torch.Tensor], y: torch.Tensor, *, mode: str
) -> torch.Tensor:
    """Gradient of the refinement objective at ``y``, in plain PyTorch (the
    engine's score steps take the kernel instead)."""
    check_mode(mode)

    def denoise(yy):
        return torch.softmax(logits_fn(yy).float(), dim=-1)

    if mode == "score":
        return y - denoise(y)
    return energy_gradient(denoise, y)


def _step(logits_fn, y: torch.Tensor, eps: float, mode: str, renorm: str) -> torch.Tensor:
    if mode == "score":
        y = refine_tail(logits_fn(y).float(), y, eps)
    else:
        y = y - eps * _step_gradient(logits_fn, y, mode=mode)
    if renorm == "softmax":
        y = torch.softmax(torch.log(torch.clamp(y, min=1e-8)), dim=-1)
    return y


def refinement_scan(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    *,
    eps: float,
    num_steps: int,
    mode: str = "score",
    renorm: str = "none",
) -> torch.Tensor:
    """K refinement steps from ``y0`` (B, H, W, C) f32; returns ``y_K``."""
    check_mode(mode)
    _check_renorm(renorm)
    y = y0
    for _ in range(num_steps):
        y = _step(logits_fn, y, eps, mode, renorm)
    return y


def refine_with_trajectory(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    *,
    eps: float,
    num_steps: int,
    mode: str = "score",
    renorm: str = "none",
) -> torch.Tensor:
    """Like ``refinement_scan`` but stacks every iterate: (K+1, B, H, W, C)
    (the (eps, K) search scores every K <= K_max from one run)."""
    check_mode(mode)
    _check_renorm(renorm)
    ys = [y0]
    for _ in range(num_steps):
        ys.append(_step(logits_fn, ys[-1], eps, mode, renorm))
    return torch.stack(ys)


def make_refiner(
    fcn_apply: Callable,
    score_logits: Callable,
    fcn_params: dict,
    dae_params: dict,
    *,
    eps: float,
    num_steps: int,
    h_taps: tuple[str, ...] = ("pool4",),
    mode: str = "score",
    renorm: str = "none",
    compute_dtype=torch.float32,
    dae_kwargs: Mapping | None = None,
) -> Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Image batch -> ``(y0, yK)``: FCN-8 forward (taps computed once, f32
    softmax), then K steps of the general engine. ``score_logits`` is the
    score network's logits apply (``models.registry.score_logits_fn``)."""
    check_mode(mode)
    _check_renorm(renorm)
    dae_kwargs = dict(dae_kwargs or {})
    dae_kwargs.setdefault("compute_dtype", compute_dtype)

    def refine(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with no_autograd(mode):
            y0, h = fcn_apply(fcn_params, x, return_features=h_taps, compute_dtype=compute_dtype)
            y_k = refinement_scan(
                lambda y: score_logits(dae_params, y, h, **dae_kwargs), y0,
                eps=eps, num_steps=num_steps, mode=mode, renorm=renorm,
            )
        return y0, y_k

    return refine
