"""Serving-facing predictor: weights -> fixed-batch inference on one device.

Port of ``iterative_inference_segm_tpu.inference.predictor``: FCN-8 + the
DAE refinement through either engine. ``engine='general'`` (the default, as
in the JAX package) runs K full-resolution steps of ``inference.iterative.
refinement_scan`` on the FCN's f32 softmax and returns f32 probabilities;
``engine='half'`` runs the pooled-scale engine (``inference.fused.
halfres_refine``, folded tail where legal), whose rectification kernel also
emits the label map. Both serve score and energy modes. A DAE refines when
one is given and ``num_steps > 0`` (the half engine always runs its one
rectification); otherwise the FCN's f32 softmax is served unrefined.
Requests of any size are cut into chunks of ``batch_size``; the last chunk
is zero-padded to the full batch, as the JAX version pads to its one
compiled shape. Runs eagerly under ``torch.inference_mode`` (``torch.
no_grad`` in energy mode, whose steps need autograd).
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID, DatasetConfig
from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image
from iterative_inference_segm_tpu_torch.inference.fused import check_mode, halfres_refine, no_autograd
from iterative_inference_segm_tpu_torch.inference.iterative import refinement_scan
from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8
from iterative_inference_segm_tpu_torch.models.registry import (
    expected_meta,
    init_score_template,
    score_logits_fn,
    validate_arch,
)
from iterative_inference_segm_tpu_torch.utils.checkpoint import check_npz_meta, load_npz


class Predictor:
    def __init__(
        self,
        fcn_params: dict,
        dae_params: dict | None = None,
        *,
        device: torch.device | str,
        dataset: DatasetConfig = CAMVID,
        eps: float = 0.1,
        num_steps: int = 5,
        h_taps: tuple[str, ...] = ("pool4",),
        mode: str = "score",
        engine: str = "general",
        dae_arch: str = "dae",
        batch_size: int = 8,
        compute_dtype=torch.bfloat16,
        normalize: bool = True,
        input_scale: float = 1.0,
        dae_kwargs: Mapping | None = None,
        mesh=None,
        pp_mesh=None,
    ):
        """``device`` is where the params live and every chunk runs (no
        default, and no fallback: a CUDA device without a card raises).
        ``mesh`` and ``pp_mesh`` are not ported yet."""
        if engine not in ("general", "half"):
            raise ValueError(f"unknown engine {engine!r}; expected 'general' or 'half'")
        if mesh is not None or pp_mesh is not None:
            raise NotImplementedError("mesh / pp_mesh serving is not ported yet (ROADMAP.md)")
        self._score_logits = score_logits_fn(dae_arch)  # validates the arch name
        check_mode(mode)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1; got {batch_size}")
        self.cfg = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._fcn = fcn_params
        self._dae = dae_params
        self._eps = eps
        self._num_steps = num_steps
        self._h_taps = tuple(h_taps)
        self._mode = mode
        self._engine = engine
        self._compute_dtype = compute_dtype
        self._normalize = normalize
        self._input_scale = input_scale
        self._dae_kwargs = dict(dae_kwargs or {})
        self._depth = self._dae_kwargs.get("depth", 4)
        self._encoder = self._dae_kwargs.get("encoder", "pool")
        self._refine = dae_params is not None and (num_steps > 0 or engine == "half")

    @classmethod
    def from_npz(
        cls,
        fcn_npz: str | os.PathLike,
        dae_npz: str | os.PathLike | None = None,
        *,
        device: torch.device | str,
        dataset: DatasetConfig = CAMVID,
        fc_channels: int = 4096,
        dae_depth: int = 4,
        dae_stem_pool: int = 0,
        dae_tail: str = "full",
        dae_widths: tuple[int, ...] | None = None,
        dae_encoder: str = "pool",
        dae_arch: str = "dae",
        h_taps: tuple[str, ...] = ("pool4",),
        **kwargs,
    ) -> "Predictor":
        """Load flat-npz exports (JAX layout, from either package). The DAE's
        shape-invisible flags (encoder, depth, stem_pool, tail, widths) are
        checked against the checkpoint's stamped metadata first."""
        validate_arch(dae_arch)
        gen = torch.Generator().manual_seed(0)
        fcn_t = init_fcn8(
            gen, n_classes=dataset.n_classes, in_channels=dataset.in_channels,
            fc_channels=fc_channels, device=device,
        )
        fcn = load_npz(fcn_npz, fcn_t)
        dae = None
        if dae_npz:
            expect = expected_meta(
                dae_arch, depth=dae_depth, stem_pool=dae_stem_pool, tail=dae_tail,
                widths=dae_widths, encoder=dae_encoder,
            )
            check_npz_meta(dae_npz, expect, context=f"Predictor.from_npz({dae_npz})")
            dae_t = init_score_template(
                dae_arch, gen, n_classes=dataset.n_classes, h_taps=tuple(h_taps),
                depth=dae_depth, stem_pool=dae_stem_pool, tail=dae_tail, widths=dae_widths,
                device=device,
            )
            dae = load_npz(dae_npz, dae_t)
        return cls(
            fcn, dae, device=device, dataset=dataset, h_taps=h_taps, dae_arch=dae_arch,
            dae_kwargs={"depth": dae_depth, "encoder": dae_encoder}, **kwargs,
        )

    def _predict(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One fixed-size chunk -> (labels int32, probs at the state dtype)."""
        if self._normalize:
            x = normalize_image(x, self.cfg, input_scale=self._input_scale)
        # bf16 probs only when the half engine refines at bf16; the general
        # engine and an unrefined Predictor start from the f32 softmax
        half = self._refine and self._engine == "half"
        y0, h = fcn8_apply(
            self._fcn, x, return_features=self._h_taps if self._refine else (),
            compute_dtype=self._compute_dtype,
            probs_dtype=self._compute_dtype if half else torch.float32,
        )
        if not self._refine:
            return torch.argmax(y0, dim=-1).to(torch.int32), y0
        if not half:
            y = refinement_scan(
                lambda yy: self._score_logits(
                    self._dae, yy, h, compute_dtype=self._compute_dtype, **self._dae_kwargs
                ),
                y0, eps=self._eps, num_steps=self._num_steps, mode=self._mode,
            )
            return torch.argmax(y, dim=-1).to(torch.int32), y
        y, labels = halfres_refine(
            self._dae, y0, h, (int(x.shape[1]), int(x.shape[2])),
            eps=self._eps, num_steps=self._num_steps, depth=self._depth,
            compute_dtype=self._compute_dtype, encoder=self._encoder, mode=self._mode,
            with_labels=True,
        )
        return labels, y

    def predict(self, images: np.ndarray, *, return_probs: bool = False):
        """images: (N, H, W, C) float in [0, 1] (or byte range with
        ``input_scale=255.0``). Returns (N, H, W) int32 labels [, (N, H, W,
        n_classes) float32 probs], as numpy arrays."""
        images = np.asarray(images, np.float32)
        labels_out, probs_out = [], []
        with no_autograd(self._mode):
            for start in range(0, images.shape[0], self.batch_size):
                chunk = images[start : start + self.batch_size]
                got = chunk.shape[0]
                if got < self.batch_size:
                    pad = np.zeros((self.batch_size - got, *chunk.shape[1:]), np.float32)
                    chunk = np.concatenate([chunk, pad])
                x = torch.from_numpy(chunk).to(self.device)
                labels, probs = self._predict(x)
                labels_out.append(labels[:got].cpu().numpy())
                if return_probs:
                    probs_out.append(probs[:got].float().cpu().numpy())
        labels = np.concatenate(labels_out)
        if return_probs:
            return labels, np.concatenate(probs_out)
        return labels
