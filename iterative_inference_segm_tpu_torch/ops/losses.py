"""Training losses: void-masked categorical crossentropy + L2 weight decay.

Port of ``iterative_inference_segm_tpu.ops.losses``. Pixels whose label is
outside [0, C) are void: they are excluded from the mean, and the pixel
count is clamped to at least 1 so an all-void batch gives 0. The JAX
package picks the label's class with a one-hot reduction (a TPU lane-gather
workaround); here it is a plain ``torch.gather``, which selects the same
element.
"""

from __future__ import annotations

import torch


def _masked_mean_nll(logp: torch.Tensor, labels: torch.Tensor, n_classes: int, space=None) -> torch.Tensor:
    valid = (labels >= 0) & (labels < n_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).to(torch.int64)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = valid.sum()
    if space is not None:
        from iterative_inference_segm_tpu_torch.parallel.spatial import sum_over

        count = sum_over(count, space)
    return nll.sum() / count.clamp(min=1)


def masked_crossentropy(logits: torch.Tensor, labels: torch.Tensor, *, n_classes: int, space=None) -> torch.Tensor:
    """Mean categorical crossentropy over non-void pixels. logits (B,H,W,C)
    pre-softmax scores; labels (B,H,W) int. Returns a scalar f32. ``space``:
    the layout of H-sharded maps (``parallel.spatial.Rows``); the pixel
    count is then summed over the 'space' group, so the rank's value is its
    rows' part of the whole map's mean (the parts sum to it)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _masked_mean_nll(logp, labels, n_classes, space)


def crossentropy_probs(
    probs: torch.Tensor, labels: torch.Tensor, *, n_classes: int, eps: float = 1e-7, space=None
) -> torch.Tensor:
    """Crossentropy against already-softmaxed predictions (the DAE output),
    probabilities clipped to [eps, 1] before the log. ``space`` as in
    ``masked_crossentropy``."""
    logp = torch.log(torch.clamp(probs.float(), eps, 1.0))
    return _masked_mean_nll(logp, labels, n_classes, space)


def l2_regularization(params: dict, *, weight_keys: tuple[str, ...] = ("w",)) -> torch.Tensor:
    """Sum of squared weights over every leaf named in ``weight_keys``
    (biases excluded), in f32."""
    leaves = [
        torch.sum(torch.square(t.float()))
        for layer in params.values()
        for k, t in layer.items()
        if k in weight_keys
    ]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return sum(leaves)
