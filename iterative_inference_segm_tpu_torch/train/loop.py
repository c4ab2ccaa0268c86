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
from typing import Any, NamedTuple

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


class TrainState(NamedTuple):
    """A trainer's state: the JAX ``TrainState``'s fields, with the
    ``torch.optim.Adam`` of ``make_optimizer`` (which holds Adam's moments
    and updates ``params`` in place) as ``opt_state``."""

    step: int
    params: dict
    opt_state: torch.optim.Adam


def init_train_state(params: dict, cfg: TrainConfig) -> tuple[TrainState, torch.optim.Adam]:
    """``(TrainState at step 0, its optimizer)``, as the JAX
    ``init_train_state`` returns ``(state, tx)``."""
    opt = make_optimizer(cfg, params)
    return TrainState(step=0, params=params, opt_state=opt), opt


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


class DataParallel:
    """What a trainer does differently under a 'data' mesh, in one place;
    with ``mesh=None`` every method is the single-device identity.

    * ``put(images, labels)``: this rank's shard of a whole batch (a short
      batch padded with ``void_label`` rows,
      ``parallel.sharding.padded_batch_putter``);
    * ``own(draw)``: this rank's randomness. Every rank calls ``draw`` once
      for each 'data' rank, in rank order, and keeps its own draw, so the
      generators stay equal on every rank (a checkpoint holds one state)
      while each rank's crops, noise and masks differ;
    * ``average_gradients(optimizer, loss)``: the gradients of the
      optimizer's tensors and the loss averaged with one all-reduce;
    * ``sum`` / ``mean``: an eval count summed, a loss averaged;
    * ``replicate(params)``: rank 0's params on every rank;
    * ``writer``: whether this rank writes the workdir (rank 0).

    A mesh with a 'space' axis also shards H (``parallel.spatial``): ``put``
    gives the rank its band of rows, ``whole_rows`` gathers a band back
    into the data shard's whole map and ``rows`` lays one out; the ranks of
    a 'space' group draw one data rank's randomness; the one all-reduce
    and the eval sums also sum over 'space' (its ranks hold parts of one
    loss and gradient).
    """

    def __init__(self, mesh=None, *, void_label: int | None = None):
        self.mesh = mesh
        self.writer = True
        self.size, self.index = 1, 0
        self.space_group = None
        self._put = lambda images, labels: (images, labels)
        if mesh is not None:
            import torch.distributed as dist

            from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, has_axis
            from iterative_inference_segm_tpu_torch.parallel.sharding import padded_batch_putter

            self.size, self.index = axis_size(mesh, "data"), axis_index(mesh, "data")
            self.writer = dist.get_rank() == 0
            spatial = "space" if has_axis(mesh, "space") else None
            if spatial:
                self.space_group = axis_group(mesh, spatial)
            if void_label is not None:
                self._put = padded_batch_putter(mesh, void_label=void_label, spatial_axis=spatial)

    def put(self, images, labels):
        return self._put(images, labels)

    def own(self, draw):
        draws = [draw() for _ in range(self.size)]
        return draws[self.index]

    @property
    def _sum_axis(self):
        return None if self.space_group is None else "space"

    def whole_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The data shard's whole map from this rank's band of H (equal
        bands; ``t`` itself without a 'space' axis)."""
        if self.space_group is None:
            return t
        from iterative_inference_segm_tpu_torch.parallel import comm

        return comm.all_gather_cat(t, self.space_group, dim=1)

    def rows(self, whole: torch.Tensor):
        """The layout over 'space' of a map whose whole height ``whole``
        has (None without a 'space' axis)."""
        if self.space_group is None:
            return None
        import torch.distributed as dist

        from iterative_inference_segm_tpu_torch.parallel.spatial import Rows

        return Rows(self.space_group, dist.get_world_size(self.space_group), dist.get_rank(self.space_group),
                    int(whole.shape[1]))

    def average_gradients(self, optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return loss
        from iterative_inference_segm_tpu_torch.parallel.dp import average_gradients

        tensors = [t for g in optimizer.param_groups for t in g["params"]]
        return average_gradients(tensors, loss, self.mesh, sum_axis=self._sum_axis)

    def _reduce(self, t: torch.Tensor, *, mean: bool) -> torch.Tensor:
        if self.mesh is None:
            return t
        from iterative_inference_segm_tpu_torch.parallel import comm
        from iterative_inference_segm_tpu_torch.parallel.dp import reduce_group

        t = comm.all_reduce_(t.clone(), reduce_group(self.mesh, "data", self._sum_axis))
        return t / self.size if mean else t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, mean=False)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, mean=True)

    def replicate(self, params: dict) -> dict:
        if self.mesh is not None:
            from iterative_inference_segm_tpu_torch.parallel.sharding import replicate

            replicate(self.mesh, params)
        return params


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
