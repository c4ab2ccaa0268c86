"""Shared training scaffold: configuration, optimizer, early stopping, and
what both trainers do around their steps (batches to the device, resuming
from a workdir).

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
from pathlib import Path
from typing import Any

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.utils.checkpoint import latest_step, load_npz, restore_checkpoint
from iterative_inference_segm_tpu_torch.utils.experiment import MetricLogger


@dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    max_epochs: int = 500
    patience: int = 25
    batch_size: int = 10
    seed: int = 0
    compute_dtype: Any = torch.float32
    # recompute the trained network's forward during backprop
    # (torch.utils.checkpoint): trades FLOPs for activation memory
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


def device_of(params: dict) -> torch.device:
    return next(iter(next(iter(params.values())).values())).device


def clone_params(params: dict) -> dict:
    return {k: {kk: t.detach().clone() for kk, t in v.items()} for k, v in params.items()}


def batches(src):
    """A fresh iterator over ``src``: a callable returning one, or an iterable."""
    return src() if callable(src) else iter(src)


def to_device(images, labels, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch to ``device`` as it is, but for uint8 labels (the packed u8
    wire), which become int32 once they are there: the losses and metrics
    take int32. uint8 images stay uint8; the step normalizes them."""
    x = torch.as_tensor(np.asarray(images)).to(device)
    y = torch.as_tensor(np.asarray(labels)).to(device)
    if y.dtype == torch.uint8:
        y = y.to(torch.int32)
    return x, y


def resume_training(
    workdir: str,
    params: dict,
    optimizer: torch.optim.Optimizer,
    generator: torch.Generator,
    logger: MetricLogger,
    stopper: EarlyStopper,
    best_npz: str,
) -> tuple[list[dict], int, dict]:
    """Restore a trainer from ``workdir/ckpt``'s latest epoch: the params (in
    place), the optimizer state, the generator, the history up to that epoch
    (replayed into ``stopper``) and the best params from ``workdir/best_npz``,
    which may predate the latest checkpoint. Returns ``(history,
    start_epoch, best_params)``; a workdir without a checkpoint gives
    ``([], 0, a copy of params)``."""
    ckpt_dir = Path(workdir) / "ckpt"
    step = latest_step(ckpt_dir)
    if step is None:
        return [], 0, clone_params(params)
    state = restore_checkpoint(ckpt_dir, step)
    with torch.no_grad():
        for layer, leaves in params.items():
            for k, t in leaves.items():
                t.copy_(state["params"][layer][k])
    optimizer.load_state_dict(state["opt_state"])
    generator.set_state(state["rng"])
    history = [h for h in logger.read() if h["step"] <= step]
    for h in history:
        stopper.update(h["step"], h.get("val_miou", -float("inf")))
    best = Path(workdir) / best_npz
    best_params = load_npz(best, params) if best.exists() else clone_params(params)
    return history, step + 1, best_params
