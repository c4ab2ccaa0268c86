"""The general refinement engine: K score or energy steps of the DAE at full
resolution (port of ``iterative_inference_segm_tpu.inference.iterative``).

Starting from the FCN-8 softmax ``y0``, each step follows the conditional
score that the DAE estimates,

    y_{k+1} = y_k - eps * g(y_k)
    g = y - r(y)                               (mode 'score')
    g = d/dy 0.5 * ||y - r(y)||^2               (mode 'energy')

The public functions take JAX's callables. ``refinement_scan`` and
``refine_with_trajectory`` take ``dae_fn: y -> r(y)``, a probability map,
and run the JAX step in plain PyTorch: a bare closure hands over
probabilities, and a softmax already taken cannot be fused into a kernel.
``make_refiner`` and ``inference.search.grid_search_eps_k`` take the
score network's probability apply (``dae_apply``, ``mirror_dae_apply``,
``contextmod_apply``, or ``models.registry.score_apply_fn``'s), map it to
its logits twin (``models.registry.score_logits_of``) and run
``logits_refinement_scan``, the port's own loop with ``r(y) =
softmax(logits_fn(y))``: there a score step is one launch of the
hand-written tail kernel K3 on a CUDA tensor, ``refine_tail(u = logits, y,
eps)``: the logits in the DAE's compute dtype (bf16 logits are widened to
f32 in the kernel's registers, exactly as ``.float()`` would, with no cast
pass), softmax, then ``(1 - eps) y + eps r`` rounded once (the JAX
package's ``y - eps (y - r)``, equal to a few f32 ulps). Every path of the
port that launches K3 in the general engine (``Predictor``, the pipeline's
refinement stage, the benches and probes) goes through that loop. The
iterate stays in f32, as in the JAX package. An energy step differentiates
the energy through the DAE with ``torch.autograd.grad`` in plain PyTorch
and launches no kernel; it needs autograd, so it runs under
``torch.no_grad`` (``fused.no_autograd``), never ``torch.inference_mode``.
``renorm='softmax'`` re-projects each iterate onto the simplex,
``softmax(log(clip(y, 1e-8)))``, in plain PyTorch.

``lax.scan`` becomes a Python loop, so ``unroll`` has nothing to unroll;
``jax.jit`` has no counterpart.
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


def _renorm(y: torch.Tensor, renorm: str) -> torch.Tensor:
    if renorm == "softmax":
        y = torch.softmax(torch.log(torch.clamp(y, min=1e-8)), dim=-1)
    return y


def _step_gradient(
    dae_fn: Callable[[torch.Tensor], torch.Tensor], y: torch.Tensor, *, mode: str
) -> torch.Tensor:
    """Gradient of the refinement objective at ``y``, ``dae_fn`` the
    denoised probabilities, in plain PyTorch."""
    check_mode(mode)
    if mode == "score":
        return y - dae_fn(y)
    return energy_gradient(dae_fn, y)


def _steps(step, y0: torch.Tensor, num_steps: int, trajectory: bool) -> torch.Tensor:
    ys = [y0]
    for _ in range(num_steps):
        ys.append(step(ys[-1]))
    return torch.stack(ys) if trajectory else ys[-1]


def refinement_scan(
    dae_fn: Callable[[torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    *,
    eps: float,
    num_steps: int,
    mode: str = "score",
    renorm: str = "none",
    unroll: int | bool = 1,
) -> torch.Tensor:
    """K refinement steps from ``y0`` (B, H, W, C); returns ``y_K``.

    ``dae_fn: y -> r(y)`` returns the denoised probabilities, as in JAX (a
    closure over ``dae_apply``, the params and the taps). The steps run in
    plain PyTorch and launch no kernel; ``logits_refinement_scan`` is the
    loop that launches K3. ``unroll`` is accepted for JAX's call and
    ignored: the loop is Python's, and there is no ``lax.scan`` to unroll."""
    del unroll
    check_mode(mode)
    _check_renorm(renorm)
    return _steps(lambda y: _renorm(y - eps * _step_gradient(dae_fn, y, mode=mode), renorm), y0, num_steps, False)


def refine_with_trajectory(
    dae_fn: Callable[[torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    *,
    eps: float,
    num_steps: int,
    mode: str = "score",
    renorm: str = "none",
) -> torch.Tensor:
    """Like ``refinement_scan`` but stacks every iterate: (K+1, B, H, W, C)
    (the (eps, K) search scores every K <= K_max from one run). Takes
    ``dae_fn: y -> r(y)`` and runs plain PyTorch, as ``refinement_scan``."""
    check_mode(mode)
    _check_renorm(renorm)
    return _steps(lambda y: _renorm(y - eps * _step_gradient(dae_fn, y, mode=mode), renorm), y0, num_steps, True)


def logits_refinement_scan(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    *,
    eps: float,
    num_steps: int,
    mode: str = "score",
    renorm: str = "none",
    trajectory: bool = False,
) -> torch.Tensor:
    """K refinement steps with ``r(y) = softmax(logits_fn(y))``: the
    port's general engine. A score step is one launch of K3
    (``refine_tail(logits_fn(y), y, eps)``) on a CUDA tensor, its plain
    version on a CPU one; an energy step differentiates through the
    softmax of the logits. Returns ``y_K``, or with ``trajectory`` every
    iterate stacked, (K+1, B, H, W, C)."""
    check_mode(mode)
    _check_renorm(renorm)

    def step(y):
        if mode == "score":
            y = refine_tail(logits_fn(y), y, eps)
        else:
            y = y - eps * energy_gradient(lambda yy: torch.softmax(logits_fn(yy).float(), dim=-1), y)
        return _renorm(y, renorm)

    return _steps(step, y0, num_steps, trajectory)


def make_refiner(
    fcn_apply: Callable,
    dae_apply: Callable,
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
    space_group=None,
) -> Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Image batch -> ``(y0, yK)``: FCN-8 forward (taps computed once, f32
    softmax), then K steps of the general engine. ``dae_apply`` is the
    score network's probability apply, as in JAX (``dae_apply``,
    ``mirror_dae_apply``, ``contextmod_apply`` or what
    ``models.registry.score_apply_fn`` returns); it is mapped to its
    logits twin and the steps run ``logits_refinement_scan``, so score
    steps launch K3 on the card. Any other callable raises a
    ``ValueError``. ``space_group``: H is sharded over this group
    ('space'): ``x`` is this rank's equal band of rows, and so are ``y0``
    and ``yK``; the FCN and the score network take the layout as
    ``space``."""
    from iterative_inference_segm_tpu_torch.models.registry import score_logits_of

    check_mode(mode)
    _check_renorm(renorm)
    score_logits = score_logits_of(dae_apply)
    dae_kwargs = dict(dae_kwargs or {})
    dae_kwargs.setdefault("compute_dtype", compute_dtype)

    def refine(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        on_rows = {}
        if space_group is not None:
            from iterative_inference_segm_tpu_torch.parallel.spatial import rows_of

            on_rows = {"space": rows_of(space_group, x)}
        with no_autograd(mode):
            y0, h = fcn_apply(fcn_params, x, return_features=h_taps, compute_dtype=compute_dtype, **on_rows)
            y_k = logits_refinement_scan(
                lambda y: score_logits(dae_params, y, h, **dae_kwargs, **on_rows), y0,
                eps=eps, num_steps=num_steps, mode=mode, renorm=renorm,
            )
        return y0, y_k

    return refine
