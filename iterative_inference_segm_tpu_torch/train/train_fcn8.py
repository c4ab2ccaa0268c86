"""FCN-8 training (port of ``iterative_inference_segm_tpu.train.train_fcn8``).

Batches -> in-step random crop + flip + normalize -> void-masked
crossentropy of the logits -> Adam with coupled L2 -> epoch loop with train
and val metrics -> early stopping on val mIoU -> best-checkpoint save.

Randomness is explicit. A step takes a ``StepRandomness``: the per-sample
crop offsets and flips, and the dropout after fc6 and fc7, either as the
two keep-masks or as the generator that draws them. ``train_fcn8`` draws
both from a ``torch.Generator`` seeded from ``tcfg.seed``; a test hands the
step what the JAX step derives from its key. The step draws the masks
before the forward, so a rematerialized forward (``tcfg.remat``) sees the
same ones when it runs again.

``mesh`` trains data-parallel over the mesh's 'data' axis, one rank a
device (``parallel.launch``): each rank steps on its shard of every batch
with crops and dropout keep-masks of its own, drawn for its shard; the loss
and gradients are averaged with one all-reduce, the eval confusion counts
summed. Only rank 0 writes the workdir.
"""

from __future__ import annotations

import time
import types
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID, DatasetConfig
from iterative_inference_segm_tpu_torch.data.pipeline import (
    crop_and_flip,
    draw_crop_and_flip,
    normalize_image,
)
from iterative_inference_segm_tpu_torch.models.fcn8 import (
    Dropout,
    dropout_masks,
    fc_shape,
    fcn8_apply,
    fcn8_logits,
    init_fcn8,
)
from iterative_inference_segm_tpu_torch.ops.losses import masked_crossentropy
from iterative_inference_segm_tpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion
from iterative_inference_segm_tpu_torch.train.loop import (
    DataParallel,
    EarlyStopper,
    TrainConfig,
    batches,
    clone_params,
    device_of,
    make_optimizer,
    resume_training,
    to_device,
)
from iterative_inference_segm_tpu_torch.utils.checkpoint import (
    save_checkpoint,
    save_npz,
    wait_for_checkpoints,
)
from iterative_inference_segm_tpu_torch.utils.experiment import MetricLogger


@dataclass(frozen=True)
class StepRandomness:
    """Everything random in one FCN-8 train step."""

    dropout: Dropout  # the keep-masks after fc6 and fc7, or a generator that draws them
    crop: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None  # (oy, ox, flip)


def draw_step_randomness(
    generator: torch.Generator,
    *,
    batch: int,
    hw: tuple[int, int],
    crop: tuple[int, int] | None,
    device: torch.device | str,
) -> StepRandomness:
    """A step's randomness from the CPU ``generator``: crop offsets and flips
    when ``crop`` is given, and a generator on ``device`` for the dropout
    masks, seeded from ``generator``."""
    offsets = draw_crop_and_flip(generator, batch, hw, crop) if crop is not None else None
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return StepRandomness(dropout=torch.Generator(device=device).manual_seed(seed), crop=offsets)


def make_fcn8_train_step(
    cfg: DatasetConfig,
    tcfg: TrainConfig,
    optimizer: torch.optim.Optimizer,
    *,
    augment: bool = True,
    normalize: bool = True,
    input_scale: float = 1.0,
    fc_channels: int = 4096,
    mesh=None,
):
    """``(train_step, eval_step)``.

    ``train_step(params, images, labels, rand)`` updates the params in place
    through ``optimizer`` (built over the same tensors by ``make_optimizer``)
    and returns the loss; ``eval_step(params, images, labels)`` returns
    ``(confusion matrix, loss)``, the loss taken of ``log(clip(probs, 1e-7,
    1))`` of the f32 softmax, as in the JAX step. images (B, H, W, C) float,
    labels (B, H, W) int, both on the params' device; ``rand`` a
    ``StepRandomness``. With ``mesh``, images and labels are this rank's
    shard and ``rand`` this rank's randomness; the loss and confusion counts
    come back averaged and summed over the 'data' axis, and every rank
    applies the one averaged gradient. ``train_step.stages`` exposes the step's parts
    (``prepare``, ``masks``, ``loss``) for timing.
    """
    dp = DataParallel(mesh)
    if dp.space_group is not None:
        raise ValueError("the FCN-8 step shards the batch over 'data' alone, as the JAX step; a 'space' axis "
                         "(H sharding) is the DAE step's")
    n_classes = cfg.n_classes

    def logits_fn(params, images, masks):
        return fcn8_logits(params, images, dropout=masks, compute_dtype=tcfg.compute_dtype)

    def loss(params, images, labels, masks):
        if tcfg.remat and torch.is_grad_enabled():
            logits = checkpoint(logits_fn, params, images, masks, use_reentrant=False)
        else:
            logits = logits_fn(params, images, masks)
        return masked_crossentropy(logits, labels, n_classes=n_classes)

    def prepare(images, labels, rand: StepRandomness | None, *, crop: bool):
        if crop:
            if rand is None or rand.crop is None:
                raise ValueError("augment=True needs the step's crop offsets (rand.crop)")
            # elementwise normalize commutes with the crop; cropping first
            # normalizes fewer pixels
            images, labels = crop_and_flip(images, labels, *rand.crop, crop=cfg.train_crop)
        if normalize:
            images = normalize_image(images, cfg, input_scale=input_scale)
        return images, labels

    def masks(images, rand: StepRandomness):
        if isinstance(rand.dropout, torch.Generator):
            return dropout_masks(rand.dropout, fc_shape(images.shape, fc_channels))
        return rand.dropout

    def train_step(params, images, labels, rand: StepRandomness):
        images, labels = prepare(images, labels, rand, crop=augment)
        m = masks(images, rand)
        optimizer.zero_grad(set_to_none=True)
        value = loss(params, images, labels, m)
        value.backward()
        value = dp.average_gradients(optimizer, value)
        optimizer.step()
        return value.detach()

    def eval_step(params, images, labels):
        with torch.no_grad():
            images, labels = prepare(images, labels, None, crop=False)
            probs, _ = fcn8_apply(params, images, compute_dtype=tcfg.compute_dtype)
            cm = confusion_matrix(torch.argmax(probs, dim=-1), labels, n_classes=n_classes)
            value = masked_crossentropy(torch.log(torch.clamp(probs, 1e-7, 1.0)), labels,
                                        n_classes=n_classes)
        return dp.sum(cm), dp.mean(value)

    train_step.stages = types.SimpleNamespace(
        prepare=lambda images, labels, rand: prepare(images, labels, rand, crop=augment),
        masks=masks,
        loss=loss,
    )
    return train_step, eval_step


def train_fcn8(
    *,
    dataset: DatasetConfig = CAMVID,
    train_data: Iterable | Callable | None = None,
    val_data: Iterable | Callable | None = None,
    tcfg: TrainConfig | None = None,
    fc_channels: int = 4096,
    workdir: str | None = None,
    augment: bool = True,
    normalize: bool = True,
    input_scale: float = 1.0,
    params: dict | None = None,
    resume: bool = True,
    checkpoint_every: int = 1,
    mesh=None,
    epoch_callback: Callable | None = None,
    device: torch.device | str = "cuda",
) -> dict:
    """Train FCN-8; returns {'params', 'best_miou', 'best_epoch', 'history',
    'epochs'}, with the JAX ``train_fcn8``'s arguments and history keys.
    Everything runs on the params' device: ``device`` when ``params`` is
    None (random init from ``tcfg.seed``), else the device ``params`` are
    on. ``train_data`` / ``val_data``: iterables of numpy ``(images,
    labels)`` batches, or callables that return a fresh one per epoch. With
    a ``workdir``, ``metrics.jsonl``, ``best_fcn8.npz`` (JAX layout, stamped
    ``{"arch": "fcn8", "fc_channels": ...}``) and ``ckpt/<epoch>/`` are
    written, and a rerun resumes from the latest checkpoint. ``mesh``:
    data-parallel over its 'data' axis, every rank fed the same whole
    batches (a short last batch padded with void rows, which add nothing);
    the params are broadcast from rank 0 first and only rank 0 writes the
    workdir."""
    dp = DataParallel(mesh, void_label=dataset.void_label)
    tcfg = tcfg or TrainConfig()
    gen = torch.Generator().manual_seed(tcfg.seed)
    if params is None:
        params = init_fcn8(gen, n_classes=dataset.n_classes, in_channels=dataset.in_channels,
                           fc_channels=fc_channels, device=device)
    device = device_of(params)
    dp.replicate(params)
    optimizer = make_optimizer(tcfg, params)
    train_step, eval_step = make_fcn8_train_step(
        dataset, tcfg, optimizer, augment=augment, normalize=normalize,
        input_scale=input_scale, fc_channels=fc_channels, mesh=mesh,
    )

    logger = MetricLogger(workdir) if workdir else None
    stopper = EarlyStopper(tcfg.patience)
    best_params = clone_params(params)
    history: list[dict] = []
    start_epoch = 0
    if workdir and resume:
        history, start_epoch, best_params = resume_training(
            workdir, params, optimizer, gen, logger, stopper, "best_fcn8.npz")

    for epoch in range(start_epoch, tcfg.max_epochs):
        t_epoch = time.perf_counter()
        losses = []
        n_images = 0
        for images, labels in batches(train_data):
            x, y = to_device(*dp.put(images, labels), device)
            rand = dp.own(lambda: draw_step_randomness(
                gen, batch=int(y.shape[0]), hw=(int(y.shape[1]), int(y.shape[2])),
                crop=dataset.train_crop if augment else None, device=device,
            ))
            losses.append(train_step(params, x, y, rand))
            n_images += int(np.shape(images)[0])
        train_loss = float(torch.stack(losses).mean())  # waits for the device
        epoch_seconds = time.perf_counter() - t_epoch

        cm_total = None
        val_losses = []
        for images, labels in batches(val_data):
            x, y = to_device(*dp.put(images, labels), device)
            cm, vloss = eval_step(params, x, y)
            cm_total = cm if cm_total is None else cm_total + cm
            val_losses.append(vloss)
        m = metrics_from_confusion(cm_total)
        val_miou = float(m.mean_iou)
        history.append(
            {"epoch": epoch, "train_loss": train_loss,
             "val_loss": float(torch.stack(val_losses).mean()),
             "val_miou": val_miou, "val_acc": float(m.pixel_accuracy),
             "epoch_seconds": round(epoch_seconds, 3),
             "train_images_per_sec": round(n_images / max(epoch_seconds, 1e-9), 2)}
        )
        if logger and dp.writer:
            logger.log(epoch, **history[-1])
        if epoch_callback:
            epoch_callback(epoch, history[-1], params)

        if stopper.update(epoch, val_miou):
            best_params = clone_params(params)
            if workdir and dp.writer:
                save_npz(Path(workdir) / "best_fcn8.npz", best_params,
                         meta={"arch": "fcn8", "fc_channels": fc_channels})
        if workdir and dp.writer and checkpoint_every and epoch % checkpoint_every == 0:
            save_checkpoint(
                Path(workdir) / "ckpt", epoch,
                {"params": clone_params(params), "opt_state": optimizer.state_dict(),
                 "rng": gen.get_state()},
            )
        if stopper.should_stop:
            break

    if workdir:
        wait_for_checkpoints()

    return {
        "params": best_params,
        "best_miou": stopper.best,
        "best_epoch": stopper.best_epoch,
        "history": history,
        "epochs": len(history),
    }
