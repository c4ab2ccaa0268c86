"""Segmentation-map corruption, plain PyTorch: one-hot + Gaussian noise +
softmax.

Port of ``iterative_inference_segm_tpu.ops.corruption``, the oracle path
(``corruption_impl="torch"``, the counterpart of the JAX package's
``"jax"``). The noise is ``torch.randn`` from an explicit generator, as the
JAX oracle draws ``jax.random.normal`` from a key; the two streams differ,
so the tests compare distributions. The fused kernels with the TPU kernels'
own counter-based noise are ``ops/corruption_kernel.py``.
"""

from __future__ import annotations

import torch


def one_hot_probs(labels: torch.Tensor, n_classes: int, *, dtype=torch.float32) -> torch.Tensor:
    """(B,H,W) int -> (B,H,W,C); void labels (outside [0, C)) map to the
    all-zero row, as ``jax.nn.one_hot`` does."""
    cls = torch.arange(n_classes, device=labels.device)
    return (labels[..., None] == cls).to(dtype)


def corrupt_onehot(
    labels: torch.Tensor,
    generator: torch.Generator,
    *,
    n_classes: int,
    sigma: float,
    dtype=torch.float32,
) -> torch.Tensor:
    """softmax(one_hot(labels) + sigma * N(0,1)) over the class axis."""
    y = one_hot_probs(labels, n_classes, dtype=dtype)
    noise = torch.randn(y.shape, generator=generator, dtype=dtype, device=y.device)
    return torch.softmax(y + sigma * noise, dim=-1)


def corrupt_probs(probs: torch.Tensor, generator: torch.Generator, *, sigma: float) -> torch.Tensor:
    """softmax(probs + sigma * N(0,1)) over the class axis."""
    noise = torch.randn(probs.shape, generator=generator, dtype=probs.dtype, device=probs.device)
    return torch.softmax(probs + sigma * noise, dim=-1)
