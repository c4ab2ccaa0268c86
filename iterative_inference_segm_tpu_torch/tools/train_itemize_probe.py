"""Itemize the FCN-8 train step: the twin of the repo's
``tools/train_itemize_probe.py`` on the card.

FCN-8 / VGG16 fc 4096, C = 11, bf16 compute, Adam 1e-3 with the coupled L2
of ``train.loop.make_optimizer``, at ``--batch`` (128) and ``--crop`` (128):
inputs pre-cropped (no augmentation), uniform in [0, 1) and normalized with
CamVid's statistics, labels uniform over the classes, both from
``numpy.random.default_rng(0)``. Rows, with the JAX probe's labels:

  (1) the forward loss (dropout on, no autograd);
  (2) the forward and backward (``torch.autograd.grad`` of the loss in every
      leaf: the JAX probe's ``value_and_grad``);
  (3) the full step (forward, backward, Adam; the params move in place);
  (4) the forward without dropout;

then (2) - (1) as the backward and (3) - (2) as the optimizer, each with its
share of the step; and (5) the gradient of ``sum(max_pool(x))`` at the
pool1 shape (batch x crop x crop x 64, bf16) two ways: PyTorch's own
``max_pool2d`` backward (the JAX label names XLA's SelectAndScatter), and
the JAX probe's mask recompute as a ``torch.autograd.Function``
(``MaskPool``): the gradient goes to every input equal to its window's
maximum, so a tied window passes it on several times, where PyTorch's
backward (and XLA's) passes it to one input. The dropout masks come from a
generator on the device. Each row's scalar is the JAX row's: the loss, or
the gradient's first entry. Timing and lines as ``tools/perf_probe.py``,
with autograd on.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.train_itemize_probe [--batch 128] [--crop 128]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.nn.functional as F

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, probe_parser

FC_CHANNELS = 4096


def parse_args(argv=None):
    p = probe_parser(__doc__, iters=10, repeats=3)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--crop", type=int, default=128)
    return p.parse_args(argv)


def first_entry(outs) -> torch.Tensor:
    """The JAX probe's scalar: the first output's first entry, in f32."""
    return outs[0].reshape(-1)[0].float()


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class MaskPool(torch.autograd.Function):
    """2x2 stride-2 max-pool (VALID), NHWC, whose backward recomputes the
    mask: the window's gradient goes to every input equal to its maximum."""

    @staticmethod
    def forward(ctx, x):
        y = _pool(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        up = y.repeat_interleave(2, 1).repeat_interleave(2, 2)
        gup = g.repeat_interleave(2, 1).repeat_interleave(2, 2)
        return torch.where(x == up, gup, torch.zeros_like(gup)).to(x.dtype)


def pool_grad(x: torch.Tensor, *, mask: bool) -> torch.Tensor:
    """The gradient of ``sum(max_pool(x))`` (in f32) in ``x``."""
    x = x.detach().requires_grad_(True)
    y = MaskPool.apply(x) if mask else _pool(x)
    (g,) = torch.autograd.grad(y.float().sum(), x)
    return g


def step_cases(params: dict, opt: torch.optim.Optimizer, images, labels, dropout, *, n_classes: int,
               compute_dtype=torch.bfloat16):
    """``[(label, fn)]`` of rows (1)-(4); ``dropout`` a generator or the two
    keep-masks (``models.fcn8.fcn8_logits``). (2) returns the loss and the
    gradient of every leaf, in ``params``' order; (3) moves ``params``."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_logits
    from iterative_inference_segm_tpu_torch.ops.losses import masked_crossentropy

    leaves = [t for layer in params.values() for t in layer.values()]

    def loss(drop):
        return masked_crossentropy(fcn8_logits(params, images, dropout=drop, compute_dtype=compute_dtype), labels,
                                   n_classes=n_classes)

    def fwd():
        with torch.no_grad():
            return (loss(dropout),)

    def vag():
        value = loss(dropout)
        return (value.detach(), *torch.autograd.grad(value, leaves))

    def step():
        opt.zero_grad(set_to_none=True)
        value = loss(dropout)
        value.backward()
        opt.step()
        return (value.detach(),)

    def fwd_nodrop():
        with torch.no_grad():
            return (loss(None),)

    return [
        ("(1) fwd loss", fwd),
        ("(2) fwd+bwd (value_and_grad)", vag),
        ("(3) full step (fwd+bwd+adam)", step),
        ("(4) fwd, no dropout", fwd_nodrop),
    ]


def pool_cases(x: torch.Tensor):
    """``[(label, fn)]`` of rows (5a) and (5b)."""
    return [
        ("(5a) pool grad: SelectAndScatter", lambda: (pool_grad(x, mask=False),)),
        ("(5b) pool grad: mask recompute", lambda: (pool_grad(x, mask=True),)),
    ]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
    from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer

    args = parse_args(argv)
    run = ProbeRun("train_itemize_probe", args)
    dev, b, crop = run.device, args.batch, args.crop
    cfg = dataclasses.replace(CAMVID, train_crop=(crop, crop))
    tcfg = TrainConfig(learning_rate=1e-3, compute_dtype=torch.bfloat16)
    params = init_fcn8(torch.Generator().manual_seed(0), n_classes=cfg.n_classes, fc_channels=FC_CHANNELS, device=dev)
    opt = make_optimizer(tcfg, params)
    rng = np.random.default_rng(0)
    images = normalize_image(torch.from_numpy(rng.random((b, crop, crop, 3), np.float32)).to(dev), cfg)
    labels = torch.from_numpy(rng.integers(0, cfg.n_classes, (b, crop, crop)).astype(np.int32)).to(dev)
    dropout = torch.Generator(dev).manual_seed(1)
    t = {label: run.time(label, fn, b, first_entry)
         for label, fn in step_cases(params, opt, images, labels, dropout, n_classes=cfg.n_classes,
                                     compute_dtype=tcfg.compute_dtype)}
    step = t["(3) full step (fwd+bwd+adam)"]
    bwd = t["(2) fwd+bwd (value_and_grad)"] - t["(1) fwd loss"]
    adam = step - t["(2) fwd+bwd (value_and_grad)"]
    run.derived("bwd ~= (2)-(1)", bwd, b, share_of_step=bwd / step)
    run.derived("opt ~= (3)-(2)", adam, b, share_of_step=adam / step)
    del params, opt, images, labels
    x = torch.from_numpy(rng.random((b, crop, crop, 64), np.float32)).to(dev, torch.bfloat16)
    for label, fn in pool_cases(x):
        run.time(label, fn, b, first_entry)
    return 0


if __name__ == "__main__":
    sys.exit(main())
