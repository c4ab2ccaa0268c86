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


def _masked_mean_nll(logp: torch.Tensor, labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    valid = (labels >= 0) & (labels < n_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).to(torch.int64)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = valid.sum().clamp(min=1)
    return nll.sum() / count


def masked_crossentropy(logits: torch.Tensor, labels: torch.Tensor, *, n_classes: int) -> torch.Tensor:
    """Mean categorical crossentropy over non-void pixels. logits (B,H,W,C)
    pre-softmax scores; labels (B,H,W) int. Returns a scalar f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return _masked_mean_nll(logp, labels, n_classes)


def crossentropy_probs(
    probs: torch.Tensor, labels: torch.Tensor, *, n_classes: int, eps: float = 1e-7
) -> torch.Tensor:
    """Crossentropy against already-softmaxed predictions (the DAE output),
    probabilities clipped to [eps, 1] before the log."""
    logp = torch.log(torch.clamp(probs.float(), eps, 1.0))
    return _masked_mean_nll(logp, labels, n_classes)


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
