"""Checkpoints: flat-npz weights compatible with the JAX package's, and
resumable training state.

The npz half of ``iterative_inference_segm_tpu.utils.checkpoint``. Files hold
the JAX layout (keys like ``conv1_1/w``, HWIO kernels, ``__meta__/`` entries
for architecture flags), so an npz saved by either package loads in the
other. ``save_npz`` / ``load_npz`` take and return the port's parameter trees;
``utils/jax_bridge.py`` converts the layouts. The training-state half
(``save_checkpoint`` / ``restore_checkpoint`` / ``latest_step``) replaces
the JAX package's orbax directories with one ``torch.save`` file per step;
the two formats are not interchangeable.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.utils.jax_bridge import (
    params_from_jax,
    params_to_jax,
    unflatten,
)


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


# Flat-npz entries under this prefix carry architecture metadata (knobs such
# as the DAE encoder style change no parameter shape, so a wrong flag would
# load silently), not weights.
_META_PREFIX = "__meta__/"


def _meta_to_npz(meta: dict) -> dict:
    return {_META_PREFIX + k: np.asarray(v) for k, v in meta.items()}


def _npz_value_to_py(arr: np.ndarray):
    arr = np.asarray(arr)
    if arr.ndim == 0:
        v = arr[()]
        if isinstance(v, (np.str_, str)):
            return str(v)
        if isinstance(v, (np.bool_, bool)):
            return bool(v)
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        return v
    if np.issubdtype(arr.dtype, np.integer):
        return tuple(int(x) for x in arr)
    return tuple(arr.tolist())


def read_npz_meta(path: str | os.PathLike) -> dict:
    """Architecture metadata stored in a flat-npz checkpoint ({} if none)."""
    with np.load(path) as data:
        return {
            k[len(_META_PREFIX):]: _npz_value_to_py(data[k])
            for k in data.files
            if k.startswith(_META_PREFIX)
        }


def _normalize_meta(v):
    return tuple(v) if isinstance(v, (tuple, list)) else v


def check_npz_meta(path: str | os.PathLike, expect: dict, *, context: str = "") -> None:
    """Validate declared architecture flags against a checkpoint's stamped
    metadata. Mismatches raise; keys the checkpoint never stamped warn."""
    stored = read_npz_meta(path)
    missing = [k for k in expect if k not in stored]
    bad = {
        k: (stored[k], expect[k])
        for k in expect
        if k in stored and _normalize_meta(stored[k]) != _normalize_meta(expect[k])
    }
    if bad:
        detail = ", ".join(
            f"{k}: checkpoint={s!r} vs requested={e!r}" for k, (s, e) in bad.items()
        )
        raise ValueError(
            f"{context or path}: architecture flags do not match the checkpoint's "
            f"stamped metadata ({detail}). These knobs change no param shapes, so "
            "loading would succeed silently and serve degraded predictions — "
            "pass the flags the checkpoint was trained with."
        )
    if missing:
        warnings.warn(
            f"{context or path}: checkpoint carries no metadata for "
            f"{sorted(missing)}; cannot verify the declared architecture "
            "(old export?). Proceeding unchecked.",
            stacklevel=2,
        )


def save_npz(path: str | os.PathLike, params: dict, *, meta: dict | None = None) -> None:
    """Write the port's ``params`` as a flat JAX-layout npz (+ ``meta``)."""
    flat = _flatten(params_to_jax(params))
    if meta:
        extra = _meta_to_npz(meta)
        overlap = set(flat) & set(extra)
        if overlap:
            raise ValueError(f"meta keys collide with param keys: {sorted(overlap)}")
        flat.update(extra)
    np.savez(path, **flat)


def load_npz(path: str | os.PathLike, template: dict) -> dict:
    """Load a flat JAX-layout npz into the port's layout. Every layer/leaf of
    ``template`` (a port tree) must be present with the template's shape; the
    result takes the template's dtypes and devices. Extra keys are ignored."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if not k.startswith(_META_PREFIX)}
    tree = unflatten(flat)
    out: dict = {}
    for layer, leaves in template.items():
        if layer not in tree:
            raise KeyError(f"npz missing parameter layer {layer!r}")
        for leaf in leaves:
            if leaf not in tree[layer]:
                raise KeyError(f"npz missing parameter {layer + '/' + leaf!r}")
        got = params_from_jax({layer: {k: tree[layer][k] for k in leaves}})[layer]
        out[layer] = {}
        for leaf, ref in leaves.items():
            if tuple(got[leaf].shape) != tuple(ref.shape):
                raise ValueError(
                    f"shape mismatch for {layer + '/' + leaf!r}: "
                    f"{tuple(got[leaf].shape)} vs {tuple(ref.shape)}"
                )
            out[layer][leaf] = got[leaf].to(device=ref.device, dtype=ref.dtype)
    return out


# Resumable training state (the trainer's params, optimizer state_dict and
# generator state) as one ``torch.save`` file under ``directory/<step>/``.
_STATE_FILE = "state.pt"


def save_checkpoint(directory: str | os.PathLike, step: int, state: dict) -> None:
    """Write ``state`` (tensors, numbers, lists and dicts) at
    ``directory/<step>/state.pt``, synchronously; the file appears whole
    (written beside it, then renamed) or not at all."""
    path = Path(directory) / str(step)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{_STATE_FILE}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path / _STATE_FILE)


def wait_for_checkpoints() -> None:
    """Saving is synchronous here, so nothing is ever pending; kept so the
    trainers read as the JAX package's do."""


def restore_checkpoint(directory: str | os.PathLike, step: int) -> dict:
    """Read back what ``save_checkpoint`` wrote at ``step``, on the CPU."""
    return torch.load(Path(directory) / str(step) / _STATE_FILE, map_location="cpu",
                      weights_only=True)


def latest_step(directory: str | os.PathLike) -> int | None:
    """Highest numbered checkpoint under ``directory`` holding a complete
    state file, or None."""
    d = Path(directory)
    if not d.is_dir():
        return None
    steps = [
        int(p.name) for p in d.iterdir()
        if p.is_dir() and p.name.isdigit() and (p / _STATE_FILE).is_file()
    ]
    return max(steps) if steps else None
