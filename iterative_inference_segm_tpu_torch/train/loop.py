"""Shared training scaffold: configuration, optimizer, early stopping.

Port of ``iterative_inference_segm_tpu.train.loop``. The JAX optimizer is
``optax.chain(add_decayed_weights(wd, mask=w-leaves), adam(lr))``: the L2
term is added to the gradient *before* Adam's moments (coupled decay, not
AdamW). ``torch.optim.Adam(weight_decay=wd)`` does exactly that, so
``make_optimizer`` gives it two parameter groups: every leaf named ``w``
with ``weight_decay=wd``, every other leaf with 0. Adam's defaults match
optax's (betas 0.9/0.999, eps 1e-8 added to the bias-corrected sqrt(v)).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    max_epochs: int = 500
    patience: int = 25
    batch_size: int = 10
    seed: int = 0
    compute_dtype: Any = torch.float32
    # recompute the DAE forward during backprop (torch.utils.checkpoint):
    # trades FLOPs for activation memory
    remat: bool = False


def make_optimizer(cfg: TrainConfig, params: dict) -> torch.optim.Adam:
    """Adam with coupled L2 decay on the ``w`` leaves of ``params`` (a
    ``{layer: {leaf: tensor}}`` tree) only. Every leaf is made a leaf
    tensor that requires grad; the optimizer updates them in place."""
    decayed, plain = [], []
    for layer in params.values():
        for name, t in layer.items():
            t.requires_grad_(True)
            (decayed if name == "w" else plain).append(t)
    return torch.optim.Adam(
        [
            {"params": decayed, "weight_decay": cfg.weight_decay},
            {"params": plain, "weight_decay": 0.0},
        ],
        lr=cfg.learning_rate,
    )


class EarlyStopper:
    """Patience-based early stopping on a maximized validation metric."""

    def __init__(self, patience: int):
        self.patience = patience
        self.best = -float("inf")
        self.best_epoch = -1
        self.bad_epochs = 0

    def update(self, epoch: int, value: float) -> bool:
        """Record ``value``; returns True if this is a new best."""
        if value > self.best:
            self.best = value
            self.best_epoch = epoch
            self.bad_epochs = 0
            return True
        self.bad_epochs += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.bad_epochs > self.patience
