"""The throughput probes K4 and K5, with their plain versions.

``fma_chain(x, w, n_fma)`` computes ``acc = x; acc = acc + x * w[i % 8]``
for ``i < n_fma`` in f32, one rounding per step, and returns ``acc`` in x's
dtype. ``pattern_softmax(x, k)`` computes, on (N, R, C, W) maps,
``a = x * k[c]``; ``s = a + a[w-1]/2 + a[w+1]/4 + a[r+1]/8`` (zeros outside
the map, summed in that order); ``s += 0.01 * s[:, :, 3]`` (class 3's value
from before the update, added to every class); then a softmax over C. They
port the Pallas kernels ``fma_kernel`` and ``pattern_kernel`` of
``tools/vpu_probe.py``; ``csrc/vpu_probe.cu`` says what they measure on the
card.

On a CUDA tensor each wrapper launches the hand-written kernel (built at
first use by ``ops/_build.py``) or raises; on a CPU tensor it runs the plain
PyTorch version (``*_reference``). No path falls back from the kernel to
the plain version. ``fma_chain.launches`` and ``pattern_softmax.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from iterative_inference_segm_tpu_torch.ops import _build

MAX_CLASSES = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FMA_ARGTYPES = [_I, _P, _P, _L, _I] + [_F] * 8 + [_P]
_PATTERN_ARGTYPES = [_I, _P, _P, _P] + [_I] * 4 + [_P]


def _weights(w) -> list[float]:
    """The eight weights as host floats (the TPU kernel read its (8, 1) ``w``
    from SMEM; the CUDA kernel takes them by value)."""
    vals = [float(v) for v in torch.as_tensor(w, dtype=torch.float32).reshape(-1).tolist()]
    if len(vals) != 8:
        raise ValueError(f"fma_chain: w must hold 8 weights; got {len(vals)}")
    return vals


def fma_chain_reference(x: torch.Tensor, w: Sequence[float] | torch.Tensor, n_fma: int) -> torch.Tensor:
    """Plain PyTorch version of K4: an ``addcmul`` chain in f32 (one
    rounding a step, as XLA contracts the TPU kernel's multiply-add)."""
    x32 = x.float()
    wt = torch.tensor(_weights(w), dtype=torch.float32, device=x.device)
    acc = x32
    for i in range(n_fma):
        acc = torch.addcmul(acc, x32, wt[i % 8])
    return acc.to(x.dtype)


def pattern_softmax_reference(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5 on (N, R, C, W): the TPU kernel's order of
    operations, its softmax's denominator summed class by class."""
    c = int(x.shape[2])
    a = x.float() * k.reshape(1, 1, c, 1).float()
    zw = torch.zeros_like(a[..., :1])
    left = torch.cat([zw, a[..., :-1]], dim=3)
    right = torch.cat([a[..., 1:], zw], dim=3)
    up = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    s = a + 0.5 * left
    s = s + 0.25 * right
    s = s + 0.125 * up
    s = s + s[:, :, 3:4] * 0.01
    e = torch.exp(s - s.amax(dim=2, keepdim=True))
    den = e[:, :, 0]
    for ci in range(1, c):
        den = den + e[:, :, ci]
    return (e / den[:, :, None]).to(x.dtype)


def _check_dtype(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if x.numel() < 1:
        raise ValueError(f"{name}: empty tensor")


def _device_kind(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type


def _fn(entry: str, argtypes):
    fn = getattr(_build.load("vpu_probe"), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def fma_chain(x: torch.Tensor, w: Sequence[float] | torch.Tensor, n_fma: int) -> torch.Tensor:
    """K4 on any float32/bfloat16 tensor; ``w`` holds 8 weights. Returns a
    contiguous tensor of x's shape and dtype."""
    _check_dtype("fma_chain", x)
    if n_fma < 0:
        raise ValueError(f"fma_chain: n_fma must be >= 0; got {n_fma}")
    if _device_kind("fma_chain", x) == "cpu":
        return fma_chain_reference(x, w, n_fma)
    wv = _weights(w)
    xc = x.contiguous()
    out = torch.empty_like(xc)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn("fma_chain_launch", _FMA_ARGTYPES)(
            _DTYPE_CODE[x.dtype], xc.data_ptr(), out.data_ptr(), xc.numel(), int(n_fma), *wv, stream
        )
    if rc != 0:
        raise RuntimeError(f"fma_chain: kernel launch failed with CUDA error {rc}")
    fma_chain.launches += 1
    return out


def pattern_softmax(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K5 on (N, R, C, W) float32/bfloat16 maps, 4 <= C <= 16 (the pattern
    reads class 3); ``k`` holds C float32 class weights. Returns a
    contiguous tensor of x's shape and dtype."""
    _check_dtype("pattern_softmax", x)
    if x.dim() != 4:
        raise ValueError(f"pattern_softmax: x must be (N, R, C, W); got {tuple(x.shape)}")
    c = int(x.shape[2])
    if not 4 <= c <= MAX_CLASSES:
        raise ValueError(f"pattern_softmax: {c} classes; the kernel takes 4..{MAX_CLASSES}")
    if k.numel() != c or k.dtype != torch.float32 or k.device != x.device:
        raise ValueError(
            f"pattern_softmax: k must hold {c} float32 values on {x.device}; "
            f"got {k.dtype} {tuple(k.shape)} on {k.device}"
        )
    if _device_kind("pattern_softmax", x) == "cpu":
        return pattern_softmax_reference(x, k)
    xc, kc = x.contiguous(), k.reshape(-1).contiguous()
    out = torch.empty_like(xc)
    n, r, _, wd = (int(s) for s in xc.shape)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn("pattern_softmax_launch", _PATTERN_ARGTYPES)(
            _DTYPE_CODE[x.dtype], xc.data_ptr(), kc.data_ptr(), out.data_ptr(), n, r, c, wd, stream
        )
    if rc != 0:
        raise RuntimeError(f"pattern_softmax: kernel launch failed with CUDA error {rc}")
    pattern_softmax.launches += 1
    return out


fma_chain.launches = 0
pattern_softmax.launches = 0
