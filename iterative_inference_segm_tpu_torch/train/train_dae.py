"""DAE (conditional score network) training against a frozen FCN-8.

Port of ``iterative_inference_segm_tpu.train.train_dae``. The DAE learns to
map corrupted segmentation maps back to the clean ground truth,
conditioned on frozen FCN-8 features. Three corruption regimes, chosen by
``from_gt``:

* ``True``  : input = softmax(one_hot(y_gt) + sigma*N(0,1))     (K1),
* ``False`` : input = the frozen FCN's softmax output, with extra
              softmax(probs + sigma*N(0,1)) noise when sigma > 0 (K2),
* ``p`` in (0, 1): per batch, one coin picks the noisy-GT regime with
  probability p; both branches use the step's one noise seed.

Loss: void-masked crossentropy of the DAE output against the clean ground
truth. The frozen FCN runs inside the step under ``torch.no_grad`` without
dropout (in the ground-truth regime only as far as the DAE's deepest tap:
its probabilities are not read); the DAE's backward is plain autograd
through cuDNN.

Randomness is explicit. A step takes a ``StepRandomness`` (the uint32 noise
seed, the per-sample crop offsets and flips, the mix regime's coin), which
``train_dae`` draws from a ``torch.Generator`` seeded from ``tcfg.seed``;
a test hands the step what the JAX step derives from its key.

``mesh`` trains data-parallel over the mesh's 'data' axis, one rank a
device (``parallel.launch``): each rank steps on its shard of every batch
with randomness of its own (the JAX step folds the device index into its
key: each device draws its own crops, noise and coin), the loss and the
gradients are averaged with one all-reduce (``parallel.dp``), the
confusion counts summed. Only rank 0 writes the workdir.

A ``('data', 'space')`` mesh also shards H over 'space'
(``parallel.spatial``): the step takes each rank's band of rows, gathers
the data shard's whole images and labels to crop them (the same crop on
every rank of a 'space' group) and to corrupt the labels (K1 and K2 index
their noise by global pixel, so the whole map is corrupted and the rank
keeps its band: the same draws as the unsharded step), then runs the
frozen FCN, the DAE and the loss on its band; the loss's pixel count and
the one all-reduce of the gradients sum over 'space' as well.
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
from iterative_inference_segm_tpu_torch.models.fcn8 import backbone_depth, fcn8_apply, fcn8_backbone
from iterative_inference_segm_tpu_torch.models.registry import (
    checkpoint_meta,
    init_score_template,
    score_apply_fn,
    score_kwargs,
)
from iterative_inference_segm_tpu_torch.ops import corruption as oracle
from iterative_inference_segm_tpu_torch.ops import corruption_kernel as kernels
from iterative_inference_segm_tpu_torch.ops.losses import crossentropy_probs
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

CORRUPTION_IMPLS = ("kernel", "torch", "auto")


@dataclass(frozen=True)
class StepRandomness:
    """Everything random in one DAE step."""

    noise_seed: int  # uint32: seeds K1/K2, or the torch oracle's generator
    crop: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None  # (oy, ox, flip)
    take_gt: bool = True  # the mix regime's coin; the pure regimes ignore it


def draw_step_randomness(
    generator: torch.Generator,
    *,
    batch: int,
    hw: tuple[int, int],
    crop: tuple[int, int] | None,
    p_gt: float,
) -> StepRandomness:
    """A step's randomness from ``generator``: a noise seed, crop offsets
    and flips when ``crop`` is given, and the mix regime's coin."""
    seed = int(torch.randint(0, 2**32, (1,), generator=generator))
    offsets = draw_crop_and_flip(generator, batch, hw, crop) if crop is not None else None
    take_gt = bool(torch.rand((), generator=generator) < p_gt)
    return StepRandomness(noise_seed=seed, crop=offsets, take_gt=take_gt)


def make_dae_train_step(
    cfg: DatasetConfig,
    tcfg: TrainConfig,
    optimizer: torch.optim.Optimizer,
    *,
    h_taps: tuple[str, ...],
    sigma: float,
    from_gt: bool | float,
    augment: bool = True,
    normalize: bool = True,
    input_scale: float = 1.0,
    dae_depth: int = 4,
    dae_encoder: str = "pool",
    corruption_impl: str = "auto",
    arch: str = "dae",
    mesh=None,
):
    """``(train_step, eval_step)`` with the frozen FCN inside the step.

    ``train_step(dae_params, fcn_params, images, labels, rand)`` updates the
    DAE params in place through ``optimizer`` (built over the same tensors
    by ``make_optimizer``) and returns the loss; ``eval_step(dae_params,
    fcn_params, images, labels, rand)`` returns ``(confusion matrix,
    loss)``. images (B, H, W, C) float, labels (B, H, W) int, both on the
    params' device; ``rand`` a ``StepRandomness``.

    ``corruption_impl``: 'kernel' (K1/K2: the CUDA kernels on a card, their
    plain versions on the CPU), 'torch' (the oracle, ``torch.randn``), or
    'auto' (kernel on CUDA, torch on the CPU). The two draw different
    (same-distribution) noise. ``train_step.stages`` exposes the step's
    parts (``prepare``, ``features``, ``corrupt``, ``loss``) for timing.
    """
    dp = DataParallel(mesh)
    if corruption_impl not in CORRUPTION_IMPLS:
        raise ValueError(f"unknown corruption_impl {corruption_impl!r}; expected one of "
                         f"{CORRUPTION_IMPLS}")
    resolved_from_auto = corruption_impl == "auto"
    if resolved_from_auto:
        device = optimizer.param_groups[0]["params"][0].device
        corruption_impl = "kernel" if device.type == "cuda" else "torch"
    # the two impls draw different noise, so a run is reproducible only
    # under a fixed impl: say which one this run uses
    print(
        f"[train_dae] corruption_impl={corruption_impl}"
        + (" (auto-selected for this platform)" if resolved_from_auto else ""),
        flush=True,
    )
    p_gt = float(from_gt)
    if not 0.0 <= p_gt <= 1.0:
        raise ValueError(f"from_gt must be bool or in [0,1], got {from_gt}")
    n_classes = cfg.n_classes

    def oracle_generator(seed: int, device: torch.device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)

    def gt_corrupted(labels, seed):
        if corruption_impl == "kernel":
            return kernels.corrupt_onehot(labels, seed, n_classes=n_classes, sigma=sigma)
        return oracle.corrupt_onehot(
            labels, oracle_generator(seed, labels.device), n_classes=n_classes, sigma=sigma
        )

    def fcn_corrupted(probs, seed):
        if sigma <= 0:
            return probs
        if corruption_impl == "kernel":
            return kernels.corrupt_probs(probs, seed, sigma=sigma)
        return oracle.corrupt_probs(probs, oracle_generator(seed, probs.device), sigma=sigma)

    def corrupt(labels, probs, rand: StepRandomness, rows=None):
        """The DAE's input; under H sharding (``rows``) from the whole
        ``labels`` (and the whole FCN probabilities, gathered), the rank's
        band of it."""
        from iterative_inference_segm_tpu_torch.parallel.spatial import gather_rows, own_rows

        take_gt = p_gt >= 1.0 or (p_gt > 0.0 and rand.take_gt)
        if take_gt:
            y = gt_corrupted(labels, rand.noise_seed)
        else:
            y = fcn_corrupted(probs if rows is None else gather_rows(probs, rows), rand.noise_seed)
        return y if rows is None else own_rows(y, rows)

    arch_apply = score_apply_fn(arch)
    arch_kw = score_kwargs(arch, depth=dae_depth, encoder=dae_encoder)

    def apply(dae_params, y, h, rows=None):
        on_rows = {} if rows is None else {"space": rows}
        return arch_apply(dae_params, y, h, compute_dtype=tcfg.compute_dtype, **arch_kw, **on_rows)

    def loss(dae_params, y_tilde, h, labels, rows=None):
        if tcfg.remat and torch.is_grad_enabled():
            recon = checkpoint(apply, dae_params, y_tilde, h, rows, use_reentrant=False)
        else:
            recon = apply(dae_params, y_tilde, h, rows)
        return crossentropy_probs(recon, labels, n_classes=n_classes, space=rows), recon

    def prepare(images, labels, rand: StepRandomness, *, crop: bool):
        if crop:
            if rand.crop is None:
                raise ValueError("augment=True needs the step's crop offsets (rand.crop)")
            # elementwise normalize commutes with the crop; cropping first
            # normalizes fewer pixels
            images, labels = crop_and_flip(images, labels, *rand.crop, crop=cfg.train_crop)
        if normalize:
            images = normalize_image(images, cfg, input_scale=input_scale)
        return images, labels

    # the ground-truth regime reads no probabilities: the frozen FCN runs
    # only as far as the deepest tap (XLA drops the unread rest of the JAX
    # step's forward by itself); probs are then None
    depth = backbone_depth(h_taps) if p_gt >= 1.0 else None

    def features(fcn_params, images, rows=None):
        with torch.no_grad():
            if depth is not None:
                _, h = fcn8_backbone(fcn_params, images, return_features=h_taps,
                                     compute_dtype=tcfg.compute_dtype, through=depth, space=rows)
                return None, h
            return fcn8_apply(
                fcn_params, images, return_features=h_taps, compute_dtype=tcfg.compute_dtype, space=rows
            )

    def staged(images, labels, rand, *, crop):
        """``(images, labels, whole labels, rows)``: the prepared batch, and
        under H sharding the rank's bands of it, the data shard's whole
        labels (for the corruption) and the layout (None without)."""
        if dp.space_group is None:
            images, labels = prepare(images, labels, rand, crop=crop)
            return images, labels, labels, None
        from iterative_inference_segm_tpu_torch.parallel.spatial import own_rows

        images, labels = prepare(dp.whole_rows(images), dp.whole_rows(labels), rand, crop=crop)
        rows = dp.rows(images)
        return own_rows(images, rows), own_rows(labels, rows), labels, rows

    def train_step(dae_params, fcn_params, images, labels, rand: StepRandomness):
        images, labels, whole, rows = staged(images, labels, rand, crop=augment)
        probs, h = features(fcn_params, images, rows)
        with torch.no_grad():
            y_tilde = corrupt(whole, probs, rand, rows)
        optimizer.zero_grad(set_to_none=True)
        value, _ = loss(dae_params, y_tilde, h, labels, rows)
        value.backward()
        value = dp.average_gradients(optimizer, value)
        optimizer.step()
        return value.detach()

    def eval_step(dae_params, fcn_params, images, labels, rand: StepRandomness):
        with torch.no_grad():
            images, labels, whole, rows = staged(images, labels, rand, crop=False)
            probs, h = features(fcn_params, images, rows)
            y_tilde = corrupt(whole, probs, rand, rows)
            value, recon = loss(dae_params, y_tilde, h, labels, rows)
            cm = confusion_matrix(torch.argmax(recon, dim=-1), labels, n_classes=n_classes)
        return dp.sum(cm), dp.mean(value)

    train_step.stages = types.SimpleNamespace(
        prepare=lambda images, labels, rand: prepare(images, labels, rand, crop=augment),
        features=features,
        corrupt=corrupt,
        loss=loss,
    )
    return train_step, eval_step


def train_dae(
    *,
    fcn_params: dict,
    dataset: DatasetConfig = CAMVID,
    train_data: Iterable | Callable | None = None,
    val_data: Iterable | Callable | None = None,
    tcfg: TrainConfig | None = None,
    h_taps: tuple[str, ...] = ("pool4",),
    sigma: float = 1.0,
    from_gt: bool | float = True,
    dae_depth: int = 4,
    dae_stem_pool: int = 0,
    dae_tail: str = "full",
    dae_widths: tuple[int, ...] | None = None,
    dae_encoder: str = "pool",
    dae_tied: bool = False,
    arch: str = "dae",
    workdir: str | None = None,
    augment: bool = True,
    normalize: bool = True,
    input_scale: float = 1.0,
    dae_params: dict | None = None,
    resume: bool = True,
    checkpoint_every: int = 1,
    corruption_impl: str = "auto",
    mesh=None,
    epoch_callback: Callable | None = None,
) -> dict:
    """Train the conditional DAE against the frozen FCN-8 ``fcn_params``;
    everything runs on their device. Same arguments, history keys and
    return dict as the JAX ``train_dae``. ``train_data`` / ``val_data``:
    iterables of numpy ``(images, labels)`` batches, or callables that
    return a fresh one per epoch. ``mesh``: data-parallel over its 'data'
    axis, every rank fed the same whole batches (a short last batch is
    padded with void rows, which add nothing); the params are broadcast
    from rank 0 first and only rank 0 writes the workdir."""
    dp = DataParallel(mesh, void_label=dataset.void_label)
    tcfg = tcfg or TrainConfig()
    device = device_of(fcn_params)
    gen = torch.Generator().manual_seed(tcfg.seed)
    if dae_params is None:
        dae_params = init_score_template(
            arch, gen, n_classes=dataset.n_classes, h_taps=tuple(h_taps), depth=dae_depth,
            stem_pool=dae_stem_pool, tail=dae_tail, widths=dae_widths, tied=dae_tied,
            device=device,
        )
    dp.replicate(fcn_params)
    dp.replicate(dae_params)
    optimizer = make_optimizer(tcfg, dae_params)
    train_step, eval_step = make_dae_train_step(
        dataset, tcfg, optimizer, h_taps=tuple(h_taps), sigma=sigma, from_gt=from_gt,
        augment=augment, normalize=normalize, input_scale=input_scale, dae_depth=dae_depth,
        dae_encoder=dae_encoder, corruption_impl=corruption_impl, arch=arch, mesh=mesh,
    )
    p_gt = float(from_gt)
    ckpt_meta = checkpoint_meta(
        arch, h_taps=tuple(h_taps), depth=dae_depth, stem_pool=dae_stem_pool, tail=dae_tail,
        widths=dae_widths, encoder=dae_encoder, tied=dae_tied,
    )

    logger = MetricLogger(workdir) if workdir else None
    stopper = EarlyStopper(tcfg.patience)
    best_params = clone_params(dae_params)
    history: list[dict] = []
    start_epoch = 0
    if workdir and resume:
        history, start_epoch, best_params = resume_training(
            workdir, dae_params, optimizer, gen, logger, stopper, "best_dae.npz")

    for epoch in range(start_epoch, tcfg.max_epochs):
        t_epoch = time.perf_counter()
        losses = []
        n_images = 0
        for images, labels in batches(train_data):
            x, y = to_device(*dp.put(images, labels), device)
            rand = dp.own(lambda: draw_step_randomness(  # the whole frame's crop, also for a band of its rows
                gen, batch=int(y.shape[0]), hw=tuple(int(d) for d in np.shape(labels)[1:3]),
                crop=dataset.train_crop if augment else None, p_gt=p_gt,
            ))
            losses.append(train_step(dae_params, fcn_params, x, y, rand))
            n_images += int(np.shape(images)[0])
        train_loss = float(torch.stack(losses).mean())  # waits for the device
        epoch_seconds = time.perf_counter() - t_epoch

        # eval noise from a generator of its own, so the number of val
        # batches does not shift the training draws
        eval_gen = torch.Generator().manual_seed(int(torch.randint(0, 2**62, (1,), generator=gen)))
        cm_total = None
        val_losses = []
        for images, labels in batches(val_data):
            x, y = to_device(*dp.put(images, labels), device)
            rand = dp.own(lambda: draw_step_randomness(eval_gen, batch=int(y.shape[0]), hw=(0, 0),
                                                       crop=None, p_gt=p_gt))
            cm, vloss = eval_step(dae_params, fcn_params, x, y, rand)
            cm_total = cm if cm_total is None else cm_total + cm
            val_losses.append(vloss)
        m = metrics_from_confusion(cm_total)
        val_miou = float(m.mean_iou)
        val_loss = float(torch.stack(val_losses).mean())
        history.append(
            {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss,
             "val_miou": val_miou, "epoch_seconds": round(epoch_seconds, 3),
             "train_images_per_sec": round(n_images / max(epoch_seconds, 1e-9), 2)}
        )
        if logger and dp.writer:
            logger.log(epoch, **history[-1])
        if epoch_callback:
            epoch_callback(epoch, history[-1], dae_params)

        if stopper.update(epoch, val_miou):
            best_params = clone_params(dae_params)
            if workdir and dp.writer:
                save_npz(Path(workdir) / "best_dae.npz", best_params, meta=ckpt_meta)
        if workdir and dp.writer and checkpoint_every and epoch % checkpoint_every == 0:
            save_checkpoint(
                Path(workdir) / "ckpt", epoch,
                {"params": clone_params(dae_params), "opt_state": optimizer.state_dict(),
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
