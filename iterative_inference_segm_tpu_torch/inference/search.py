"""(eps, K) grid search on the validation split (port of
``iterative_inference_segm_tpu.inference.search``).

One K_max-step trajectory per eps scores every prefix K <= K_max: the
general search stacks the iterates (``logits_refinement_scan`` with
``trajectory=True``) and takes a confusion matrix of each; the half-engine search scores the engine's own
output ``rectify(x_k)`` at every k of one pooled trajectory, sharing each
step's core output between the rectification and the update. The steps run
the engines' own code, so score steps go through the tail kernel on a CUDA
tensor and the search selects under the numerics it will serve. Both take
JAX's calls: ``grid_search_eps_k`` the score network's probability apply
(``dae_apply``, ``mirror_dae_apply``, ``contextmod_apply``), and
``device`` defaults to the DAE params' device.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.inference.fused import (
    _folded_step_terms,
    _half_step_terms,
    _pooled_carry,
    _rectify,
    fold_half_tail,
    folded_core_out,
    half_step_gradient,
    no_autograd,
)
from iterative_inference_segm_tpu_torch.inference.iterative import logits_refinement_scan
from iterative_inference_segm_tpu_torch.models.dae import (
    dae_core,
    dae_stem_pool_of,
    dae_tail_of,
    precompute_bottleneck_h,
)
from iterative_inference_segm_tpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion
from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail


def _best(miou: np.ndarray, eps_grid: Sequence[float]) -> dict:
    best_ei, best_k = divmod(int(np.argmax(miou)), miou.shape[1])
    return {
        "best_eps": float(eps_grid[best_ei]),
        "best_k": int(best_k),
        "best_miou": float(miou[best_ei, best_k]),
        "miou": miou,
    }


def _device(device, dae_params) -> torch.device:
    """``device``, or where the DAE params are (JAX's call names none)."""
    if device is not None:
        return torch.device(device)
    from iterative_inference_segm_tpu_torch.train.loop import device_of

    return device_of(dae_params)


def _grid(batches, eps_grid, k_max, device, cms_fn) -> np.ndarray:
    """mIoU (n_eps, k_max + 1) from ``cms_fn(eps, x, labels) -> (k_max + 1,
    C, C)`` summed over the batches."""
    miou = np.zeros((len(eps_grid), k_max + 1), dtype=np.float64)
    for ei, eps in enumerate(eps_grid):
        cms = None
        for x, labels in batches:
            # numpy batches, or tensors already on the device (the CLI's u8
            # wire normalizes val there once)
            x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
            labels = torch.as_tensor(labels).to(device)
            c = cms_fn(float(eps), x, labels)
            cms = c if cms is None else cms + c
        for k in range(k_max + 1):
            miou[ei, k] = float(metrics_from_confusion(cms[k]).mean_iou)
    return miou


def grid_search_eps_k(
    fcn_apply: Callable,
    dae_apply: Callable,
    fcn_params: dict,
    dae_params: dict,
    batches: Iterable[tuple[np.ndarray, np.ndarray]],
    *,
    n_classes: int,
    eps_grid: Sequence[float],
    k_max: int,
    device: torch.device | str | None = None,
    h_taps: tuple[str, ...] = ("pool4",),
    mode: str = "score",
    renorm: str = "none",
    dae_kwargs: dict | None = None,
    compute_dtype=torch.float32,
) -> dict:
    """mIoU of the general engine for every (eps in eps_grid, K in
    0..k_max) on ``batches`` ((normalized images NHWC, labels BHW) numpy
    pairs, re-iterated per eps). Returns {'best_eps', 'best_k',
    'best_miou', 'miou': (n_eps, k_max + 1) array}; ties go to the first
    (smallest eps, then smallest K), as ``np.argmax``. ``dae_apply`` is the
    score network's probability apply, as in JAX; it is mapped to its
    logits twin (``models.registry.score_logits_of``, which raises a
    ``ValueError`` for any other callable) and the trajectory runs
    ``logits_refinement_scan``, so score steps launch K3 on the card.
    ``device``: where the batches go, by default the DAE params'."""
    from iterative_inference_segm_tpu_torch.models.registry import score_logits_of

    score_logits = score_logits_of(dae_apply)
    device = _device(device, dae_params)
    batches = list(batches)
    dae_kwargs = dict(dae_kwargs or {})
    dae_kwargs.setdefault("compute_dtype", compute_dtype)

    def cms_fn(eps, x, labels):
        with no_autograd(mode):
            y0, h = fcn_apply(fcn_params, x, return_features=h_taps, compute_dtype=compute_dtype)
            traj = logits_refinement_scan(
                lambda y: score_logits(dae_params, y, h, **dae_kwargs), y0,
                eps=eps, num_steps=k_max, mode=mode, renorm=renorm, trajectory=True,
            )
            preds = torch.argmax(traj, dim=-1)
            return torch.stack([confusion_matrix(p, labels, n_classes=n_classes) for p in preds])

    return _best(_grid(batches, eps_grid, k_max, device, cms_fn), eps_grid)


def grid_search_eps_k_half(
    fcn_apply: Callable,
    fcn_params: dict,
    dae_params: dict,
    batches: Iterable[tuple[np.ndarray, np.ndarray]],
    *,
    n_classes: int,
    eps_grid: Sequence[float],
    k_max: int,
    device: torch.device | str | None = None,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 3,
    compute_dtype=torch.float32,
    encoder: str = "pool",
    mode: str = "score",
) -> dict:
    """(eps, K) search for the half engine, whose K=0 is one rectification
    pass: row k of each eps is the engine's output with ``num_steps=k``.
    Score mode with the 'full' tail scores the folded step, as the engine
    serves it; energy mode and the 'sep' tail the unfolded one. ``device``
    as in ``grid_search_eps_k``."""
    batches = list(batches)
    sp = dae_stem_pool_of(dae_params)
    if sp < 1:
        raise ValueError("half-engine search requires a stem_pool>=1 DAE")
    for x, _ in batches:
        if x.shape[1] % (1 << sp) or x.shape[2] % (1 << sp):
            raise ValueError(f"half engine requires H, W divisible by {1 << sp}; got batch {x.shape}")
    fold = mode == "score" and dae_tail_of(dae_params) == "full"
    device = _device(device, dae_params)

    def cms_fn(eps, x_img, labels):
        with no_autograd(mode):
            y0, h = fcn_apply(
                fcn_params, x_img, return_features=h_taps, compute_dtype=compute_dtype,
                probs_dtype=compute_dtype,
            )
            bh = precompute_bottleneck_h(
                dae_params, h, depth=depth, stem_pool=sp,
                in_hw=(int(x_img.shape[1]) >> sp, int(x_img.shape[2]) >> sp),
            )

            def core_fn(xx, predense=False):
                return dae_core(
                    dae_params, xx.to(compute_dtype), bh[2], depth=depth, stem_pool=sp,
                    bottleneck_h=bh, encoder=encoder, predense=predense,
                )

            _, _, xc = _pooled_carry(dae_params, y0, compute_dtype)
            fk = fold_half_tail(dae_params, encoder=encoder) if fold else None
            cms = []
            for k in range(k_max + 1):
                if fold:
                    pre, sk1 = core_fn(xc, predense=True)
                    s = folded_core_out(
                        fk, pre, sk1, encoder=encoder, out_hw=(int(xc.shape[1]), int(xc.shape[2]))
                    )
                else:
                    s = core_fn(xc).to(compute_dtype)
                _, labels_k = _rectify(dae_params, s, y0, eps, compute_dtype, True, mode)
                cms.append(confusion_matrix(labels_k, labels, n_classes=n_classes))
                if k == k_max:
                    break
                if fold:
                    u, v, b = _folded_step_terms(fk, pre, sk1, xc, encoder=encoder)
                    xc = refine_tail(u, xc, eps, v=v, b=b)
                elif mode == "score":
                    u, v = _half_step_terms(dae_params, xc, s)
                    xc = refine_tail(u, xc, eps, v=v)
                else:
                    xc = xc - eps * half_step_gradient(
                        dae_params, core_fn, xc, mode=mode, state_dtype=compute_dtype
                    )
            return torch.stack(cms)

    return _best(_grid(batches, eps_grid, k_max, device, cms_fn), eps_grid)
