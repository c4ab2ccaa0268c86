"""Layout bridge between the JAX package's parameters and the port's.

The JAX package keeps conv kernels HWIO and runs transposed convs as
input-dilated convolutions that correlate with the UNFLIPPED kernel
(``iterative_inference_segm_tpu/ops/conv.py::_conv_transpose2d_dilated``).
The port keeps conv kernels OIHW and runs ``F.conv_transpose2d``, whose
weight is (I, O, kh, kw) and is correlated FLIPPED. So:

* conv ``w``: HWIO -> OIHW (transpose only);
* transposed conv ``w`` (every layer whose name starts with ``up``: FCN-8's
  ``upscore*``, the DAE's ``up<i>`` / ``up_stem<j>`` / ``up_stem_dw``):
  HWIO -> IOHW **and** a spatial flip. The bilinear init is symmetric, so a
  missing flip only shows with trained or random weights
  (``tests/test_torch_ops.py`` uses random);
* depthwise ``w`` (the 'sep' tail's ``*_dw`` layers): (kh, kw, C) ->
  (C, 1, kh, kw), flipped too where the layer is transposed;
* biases unchanged.

Input is the JAX tree as numpy-convertible leaves — nested
``{layer: {'w', 'b'}}`` or flat ``{'layer/w': ...}`` as in the flat npz.
This module never imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def is_transposed(layer: str) -> bool:
    return layer.startswith("up")


def is_depthwise(layer: str) -> bool:
    return layer.endswith("_dw")


def unflatten(flat: Mapping[str, object]) -> dict:
    """``{'a/w': x}`` -> ``{'a': {'w': x}}`` (one level, as the param trees)."""
    out: dict = {}
    for key, v in flat.items():
        layer, _, leaf = key.rpartition("/")
        if not layer:
            raise ValueError(f"flat parameter key {key!r} has no layer/ prefix")
        out.setdefault(layer, {})[leaf] = v
    return out


def params_from_jax(
    tree: Mapping, *, device: torch.device | str = "cpu", dtype=torch.float32
) -> dict:
    """JAX-layout tree (nested or flat) -> the port's tree of tensors."""
    if any("/" in k for k in tree):
        tree = unflatten(tree)
    out: dict = {}
    for layer, leaves in tree.items():
        conv = {}
        for leaf, value in leaves.items():
            a = np.asarray(value, dtype=np.float32)
            if leaf == "w":
                if a.ndim != (3 if is_depthwise(layer) else 4):
                    raise ValueError(f"{layer}/w has shape {a.shape}")
                if is_transposed(layer):
                    a = np.flip(a, (0, 1))
                if is_depthwise(layer):
                    a = a.transpose(2, 0, 1)[:, None]
                elif is_transposed(layer):
                    a = a.transpose(2, 3, 0, 1)
                else:
                    a = a.transpose(3, 2, 0, 1)
            conv[leaf] = torch.from_numpy(a.copy()).to(device=device, dtype=dtype)
        out[layer] = conv
    return out


def params_to_jax(params: Mapping) -> dict:
    """The port's tree -> nested JAX-layout numpy tree (float32); the exact
    inverse of ``params_from_jax``."""
    out: dict = {}
    for layer, leaves in params.items():
        conv = {}
        for leaf, t in leaves.items():
            a = t.detach().to(device="cpu", dtype=torch.float32).numpy()
            if leaf == "w":
                if is_depthwise(layer):
                    a = a[:, 0].transpose(1, 2, 0)
                elif is_transposed(layer):
                    a = a.transpose(2, 3, 0, 1)
                else:
                    a = a.transpose(2, 3, 1, 0)
                if is_transposed(layer):
                    a = np.flip(a, (0, 1))
            conv[leaf] = np.ascontiguousarray(a)
        out[layer] = conv
    return out
