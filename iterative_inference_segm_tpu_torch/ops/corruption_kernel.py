"""The fused corruption kernels K1 and K2, with their plain versions.

``corrupt_onehot`` computes ``softmax(one_hot(labels) + sigma * N(0,1))``
(labels (B,H,W) -> (B,H,W,C) f32; void labels get a zero one-hot) and
``corrupt_probs`` computes ``softmax(probs + sigma * N(0,1))`` ((..., C) ->
f32). They port the Pallas kernels ``_corrupt_kernel`` and
``_corrupt_probs_kernel`` of ``iterative_inference_segm_tpu/ops/pallas/
corruption_kernel.py`` and draw the same noise bits: a counter-based
murmur3 hash of (pixel * 128 + class) and a uint32 seed, Box-Muller in f32
(see ``csrc/corruption.cu``). ``seed_from_key_data`` derives that seed from
a JAX key's data exactly as the JAX wrappers do, so a test can hand both
packages the same key.

On a CUDA tensor each wrapper launches the hand-written kernel (built at
first use by ``ops/_build.py``) or raises; on a CPU tensor it runs the plain
PyTorch version (``*_kernel_reference``), which computes the same hash with
uint32 arithmetic carried in int64. No path falls back from the kernel to
the plain version. ``corrupt_onehot.launches`` and
``corrupt_probs.launches`` count kernel launches. Neither has a backward:
the output is a constant of the training step (the JAX wrappers end in
``stop_gradient``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.ops import _build

MAX_CLASSES = 32
_LANES = 128  # the TPU kernels' padded class width, kept in the counter
_MASK32 = 0xFFFFFFFF
_TWO_PI = float(np.float32(2.0 * math.pi))  # exactly representable in f32

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
             ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def seed_from_key_data(key_data) -> int:
    """``kd[0] ^ (kd[-1] << 7)`` mod 2^32 of a JAX key's uint32 data: the
    seed ``corrupt_onehot_pallas`` / ``corrupt_probs_pallas`` hand their
    kernels."""
    kd = np.asarray(key_data).astype(np.uint32).reshape(-1)
    return (int(kd[0]) ^ (int(kd[-1]) << 7)) & _MASK32


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """x * k mod 2^32 for x in [0, 2^32) held in int64. The full product can
    reach 2^64 and overflow int64, so k is split into 16-bit halves."""
    lo, hi = k & 0xFFFF, k >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)


def kernel_noise(n: int, n_classes: int, seed: int, device=None) -> torch.Tensor:
    """The kernels' N(0,1) draws for ``n`` pixels x ``n_classes``, (n, C) f32."""
    pix = torch.arange(n, dtype=torch.int64, device=device)
    cls = torch.arange(n_classes, dtype=torch.int64, device=device)
    ctr = (pix[:, None] * _LANES + cls) & _MASK32
    seed = int(seed) & _MASK32
    u1 = _uniform(_fmix32((_mul32(ctr, 0x9E3779B9) + seed) & _MASK32))
    u2 = _uniform(_fmix32((_mul32(ctr, 0x85EBCA77) + (seed ^ 0xDEADBEEF)) & _MASK32))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def _softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with the denominator summed class by
    class, in the kernels' order: at sigma = 0 this makes the result
    bit-equal to the TPU kernel run in interpret mode (a vectorized
    ``sum`` differs by an ulp)."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    s = e[..., 0]
    for c in range(1, int(e.shape[-1])):
        s = s + e[..., c]
    return e / s[..., None]


def corrupt_onehot_kernel_reference(
    labels: torch.Tensor, seed: int, *, n_classes: int, sigma: float
) -> torch.Tensor:
    """Plain PyTorch version of K1: same counter, hash and f32 arithmetic."""
    flat = labels.reshape(-1).to(torch.int64)
    cls = torch.arange(n_classes, device=labels.device)
    onehot = (flat[:, None] == cls).to(torch.float32)
    noise = kernel_noise(flat.numel(), n_classes, seed, labels.device)
    out = _softmax_rows(onehot + float(sigma) * noise)
    return out.reshape(*labels.shape, n_classes)


def corrupt_probs_kernel_reference(probs: torch.Tensor, seed: int, *, sigma: float) -> torch.Tensor:
    """Plain PyTorch version of K2: same counter, hash and f32 arithmetic."""
    c = int(probs.shape[-1])
    flat = probs.reshape(-1, c).to(torch.float32)
    noise = kernel_noise(flat.shape[0], c, seed, probs.device)
    return _softmax_rows(flat + float(sigma) * noise).reshape(probs.shape)


def _check_classes(name: str, c: int) -> None:
    if not 1 <= c <= MAX_CLASSES:
        raise ValueError(f"{name}: {c} classes; the kernel takes 1..{MAX_CLASSES}")


def _launch(entry: str, src: torch.Tensor, n: int, c: int, seed: int, sigma: float):
    fn = getattr(_build.load("corruption"), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    out = torch.empty((n, c), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(src.data_ptr(), n, c, int(seed) & _MASK32, float(sigma), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: kernel launch failed with CUDA error {rc}")
    return out


def corrupt_onehot(labels: torch.Tensor, seed: int, *, n_classes: int, sigma: float) -> torch.Tensor:
    """K1: labels (any shape, integer) -> (*labels.shape, n_classes) f32."""
    _check_classes("corrupt_onehot", n_classes)
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError(f"corrupt_onehot: labels must be integers; got {labels.dtype}")
    if labels.numel() < 1:
        raise ValueError("corrupt_onehot: empty label map")
    if labels.device.type == "cpu":
        return corrupt_onehot_kernel_reference(labels, seed, n_classes=n_classes, sigma=sigma)
    if labels.device.type != "cuda":
        raise ValueError(f"corrupt_onehot: no kernel for device {labels.device}")
    flat = labels.reshape(-1).to(torch.int32).contiguous()
    out = _launch("corrupt_onehot_launch", flat, flat.numel(), n_classes, seed, sigma)
    corrupt_onehot.launches += 1
    return out.reshape(*labels.shape, n_classes)


def corrupt_probs(probs: torch.Tensor, seed: int, *, sigma: float) -> torch.Tensor:
    """K2: probs (..., C), any float dtype -> the same shape in f32."""
    c = int(probs.shape[-1])
    _check_classes("corrupt_probs", c)
    if not probs.dtype.is_floating_point:
        raise TypeError(f"corrupt_probs: probs must be floating point; got {probs.dtype}")
    if probs.numel() < 1:
        raise ValueError("corrupt_probs: empty map")
    if probs.device.type == "cpu":
        return corrupt_probs_kernel_reference(probs, seed, sigma=sigma)
    if probs.device.type != "cuda":
        raise ValueError(f"corrupt_probs: no kernel for device {probs.device}")
    flat = probs.reshape(-1, c).to(torch.float32).contiguous()
    out = _launch("corrupt_probs_launch", flat, flat.shape[0], c, seed, sigma)
    corrupt_probs.launches += 1
    return out.reshape(probs.shape)


corrupt_onehot.launches = 0
corrupt_probs.launches = 0
