"""ctypes bridge to the native C++ input runtime (``native/input_runtime.cc``).

A jax-free copy of ``iterative_inference_segm_tpu.data.native_loader``: the
packed-dataset writer and a batch iterator whose decode, normalize and
shuffle run in native threads outside the GIL. It loads the same C++ source,
so a file and a seed give the same batches, in the same order, in both
packages.

The library is built differently, by design. The JAX bridge runs ``make -C
native`` (writing ``native/libinput_runtime.so``) and falls back to a stale
library if the rebuild fails. This bridge compiles ``native/input_runtime.cc``
with ``g++`` and the Makefile's flags into the package's git-ignored
``build/``, under a name hashed from the source, the flags and the host CPU
(``ops/_build.build_host``), at first use and never at import. It never
writes ``native/``, and a failed build raises with the compiler's stderr:
there is no stale library to fall back on.

Dataset format "IIST1": fixed-size uint8 records (image HWC + label HW) after
a small header carrying shapes and normalization statistics; see the .cc file
for the layout. ``pack_dataset`` writes it from numpy arrays.
"""

from __future__ import annotations

import ctypes
import os
import struct
from pathlib import Path

import numpy as np

from iterative_inference_segm_tpu_torch.data.config_datasets import DatasetConfig
from iterative_inference_segm_tpu_torch.ops import _build

_MAGIC = b"IIST1\0\0\0"
NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "input_runtime.cc"
_SYMBOLS = ("ir_open", "ir_info", "ir_stats", "ir_start_epoch", "ir_next", "ir_next_raw", "ir_close")

_libs: dict[Path, ctypes.CDLL] = {}


def _load_lib() -> ctypes.CDLL:
    """Build (if needed) and load the runtime for ``NATIVE_SRC``; cached per
    library file, so an edited source loads its own build."""
    path = _build.build_host(NATIVE_SRC, "input_runtime")
    if path in _libs:
        return _libs[path]
    lib = ctypes.CDLL(str(path))
    missing = [sym for sym in _SYMBOLS if not hasattr(lib, sym)]
    if missing:
        raise RuntimeError(f"{path.name} (built from {NATIVE_SRC}) lacks the symbols {missing}")
    lib.ir_open.restype = ctypes.c_void_p
    lib.ir_open.argtypes = [ctypes.c_char_p]
    lib.ir_info.restype = None
    lib.ir_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.ir_stats.restype = None
    lib.ir_stats.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ir_start_epoch.restype = None
    lib.ir_start_epoch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ir_next.restype = ctypes.c_int64
    lib.ir_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ir_next_raw.restype = ctypes.c_int64
    lib.ir_next_raw.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.ir_close.restype = None
    lib.ir_close.argtypes = [ctypes.c_void_p]
    _libs[path] = lib
    return lib


def pack_dataset(
    path: str | os.PathLike,
    images: np.ndarray,
    labels: np.ndarray,
    cfg: DatasetConfig,
) -> None:
    """Write (images uint8/float [0,1] NHWC, labels int BHW) as an IIST1 file."""
    images = np.asarray(images)
    labels = np.asarray(labels)
    if images.ndim != 4 or labels.ndim != 3:
        raise ValueError("expected images (N,H,W,C) and labels (N,H,W)")
    n, h, w, c = images.shape
    if labels.shape != (n, h, w):
        raise ValueError(f"label shape {labels.shape} mismatches images {(n, h, w)}")
    if c > 4:
        raise ValueError("at most 4 channels supported by the packed format")
    if images.dtype != np.uint8:
        images = np.clip(np.asarray(images, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    # Labels outside the in-class range are void markers (losses/metrics treat
    # anything >= n_classes as void). Datasets commonly encode void as -1 or
    # 255; both must land on cfg.void_label, not be clipped onto class 0.
    labels = np.asarray(labels).astype(np.int64)
    labels = np.where(
        (labels < 0) | (labels >= cfg.n_classes), cfg.void_label, labels
    )
    if not 0 <= cfg.void_label <= 255:
        raise ValueError(f"void_label {cfg.void_label} not storable as uint8")
    labels_u8 = labels.astype(np.uint8)

    mean = list(cfg.mean) + [0.0] * (4 - len(cfg.mean))
    std = list(cfg.std) + [1.0] * (4 - len(cfg.std))
    header = _MAGIC + struct.pack("<5I", n, h, w, c, cfg.n_classes)
    header += struct.pack("<4f", *mean) + struct.pack("<4f", *std)
    with open(path, "wb") as f:
        f.write(header)
        for i in range(n):
            f.write(images[i].tobytes())
            f.write(labels_u8[i].tobytes())


class NativeDataset:
    """mmap-backed packed dataset with native threaded batch production."""

    def __init__(self, path: str | os.PathLike):
        self._lib = _load_lib()
        self._handle = self._lib.ir_open(str(path).encode())
        if not self._handle:
            raise FileNotFoundError(f"cannot open packed dataset {path}")
        info = (ctypes.c_int64 * 5)()
        self._lib.ir_info(self._handle, info)
        self.n, self.height, self.width, self.channels, self.n_classes = (
            int(info[0]), int(info[1]), int(info[2]), int(info[3]), int(info[4]),
        )
        mean = (ctypes.c_float * 4)()
        std = (ctypes.c_float * 4)()
        self._lib.ir_stats(self._handle, mean, std)
        #: normalization statistics from the file header (length = channels)
        self.mean = tuple(float(mean[i]) for i in range(self.channels))
        self.std = tuple(float(std[i]) for i in range(self.channels))

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        n_threads: int = 4,
        queue_depth: int = 4,
        raw: bool = False,
    ):
        """Yield (images f32 (B,H,W,C) normalized, labels i32 (B,H,W)) —
        or, with ``raw=True``, the uint8 wire: (images u8, labels u8) exactly
        as stored, 4x fewer bytes over the host->device link; the consumer
        casts the labels to int32 after the copy (``train.loop.to_device``)
        and normalizes on the device with
        ``data.pipeline.normalize_image(x, cfg, input_scale=255.0)`` and the
        file header's statistics.

        Tail batches are zero/void padded to the full batch size; the padded
        samples carry void labels, which the losses and metrics mask.
        """
        self._lib.ir_start_epoch(
            self._handle, batch_size, int(shuffle), seed, int(drop_last),
            n_threads, queue_depth, int(raw),
        )
        if raw:
            img8 = np.empty(
                (batch_size, self.height, self.width, self.channels), np.uint8
            )
            lab8 = np.empty((batch_size, self.height, self.width), np.uint8)
            while True:
                got = self._lib.ir_next_raw(
                    self._handle,
                    img8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    lab8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                )
                if got == -2:
                    raise RuntimeError("epoch was started in f32 mode; iterate the non-raw generator")
                if got < 0:
                    break
                yield img8.copy(), lab8.copy()
            return
        img = np.empty((batch_size, self.height, self.width, self.channels), np.float32)
        lab = np.empty((batch_size, self.height, self.width), np.int32)
        while True:
            got = self._lib.ir_next(
                self._handle,
                img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if got == -2:
                raise RuntimeError("epoch was started in raw mode; iterate with raw=True")
            if got < 0:
                break
            yield img.copy(), lab.copy()

    def close(self) -> None:
        if self._handle:
            self._lib.ir_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # a handle left open by an exception in __init__'s caller
        if getattr(self, "_handle", None):
            self.close()
