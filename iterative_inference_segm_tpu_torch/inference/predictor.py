"""Serving-facing predictor: weights -> fixed-batch inference on one device.

Port of ``iterative_inference_segm_tpu.inference.predictor``: FCN-8 + the
score network's refinement through either engine (``dae_arch`` 'dae',
'mirror' or 'contextmod' on the general engine, 'dae' alone on the half
engine, whose pooled iteration needs the DAE's stem). ``engine='general'`` (the default, as
in the JAX package) runs K full-resolution steps of ``inference.iterative.
logits_refinement_scan`` (score steps through K3) on the FCN's f32 softmax and returns f32 probabilities;
``engine='half'`` runs the pooled-scale engine (``inference.fused.
halfres_refine``, folded tail where legal), whose rectification kernel also
emits the label map. Both serve score and energy modes. A DAE refines when
one is given and ``num_steps > 0`` (the half engine always runs its one
rectification); otherwise the FCN's f32 softmax is served unrefined.
Requests of any size are cut into chunks of ``batch_size``; the last chunk
is zero-padded to the full batch, as the JAX version pads to its one
compiled shape. Runs eagerly under ``torch.inference_mode`` (``torch.
no_grad`` in energy mode, whose steps need autograd).

In a launched group (``parallel.launch``) every rank calls ``predict`` with
the same images. ``mesh`` (a 'data' axis) serves each chunk data-parallel:
each rank runs its shard and the labels and probabilities are gathered, so
every rank returns them whole. ``pp_mesh`` serves through the stage
pipeline (``parallel.pp.make_pp_flagship``; a 'stage' axis of 2 or 3, and
an optional 'data' axis for DP x PP), ``pp_microbatches`` in flight a
chunk.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID, DatasetConfig
from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image
from iterative_inference_segm_tpu_torch.inference.fused import check_mode, halfres_refine, no_autograd
from iterative_inference_segm_tpu_torch.inference.iterative import logits_refinement_scan
from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8
from iterative_inference_segm_tpu_torch.models.registry import (
    expected_meta,
    init_score_template,
    score_kwargs,
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
        pp_microbatches: int = 2,
    ):
        """``device`` is where the params live and every chunk runs (no
        default, and no fallback: a CUDA device without a card raises).
        ``mesh``: data-parallel serving over its 'data' axis (the batch
        must divide by it). ``pp_mesh``: serving through the stage pipeline
        (a DAE required; not with ``mesh``; the batch must divide by
        ``pp_microbatches`` x the 'data' width)."""
        if engine not in ("general", "half"):
            raise ValueError(f"unknown engine {engine!r}; expected 'general' or 'half'")
        self._score_logits = score_logits_fn(dae_arch)  # validates the arch name
        if engine == "half" and dae_arch != "dae":
            raise ValueError("engine='half' serves dae_arch='dae' only")
        check_mode(mode)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1; got {batch_size}")
        refine = dae_params is not None and (num_steps > 0 or engine == "half")
        if pp_mesh is not None:
            if mesh is not None:
                raise ValueError("pass either mesh (DP eval sharding) or pp_mesh (pipeline)")
            if not refine:
                raise ValueError("pp_mesh pipelines the refinement serving path: requires a DAE and "
                                 "num_steps > 0 (or engine='half', which always runs its rectification pass)")
            if pp_microbatches < 1:
                raise ValueError(f"pp_microbatches must be >= 1; got {pp_microbatches}")
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
        self._refine = refine
        self._mesh = mesh
        self._pp = None
        if mesh is not None:
            from iterative_inference_segm_tpu_torch.parallel.mesh import axis_size
            from iterative_inference_segm_tpu_torch.parallel.sharding import batch_sharding, replicate

            n_dp = axis_size(mesh, "data")
            if batch_size % n_dp:
                raise ValueError(f"batch_size {batch_size} not divisible by mesh 'data' size {n_dp}")
            replicate(mesh, fcn_params)
            if dae_params is not None:
                replicate(mesh, dae_params)
            self._x_sharding = batch_sharding(mesh, 4)
        if pp_mesh is not None:
            from iterative_inference_segm_tpu_torch.parallel.mesh import axis_size, has_axis
            from iterative_inference_segm_tpu_torch.parallel.pp import make_pp_flagship

            pp_batch_axis = "data" if has_axis(pp_mesh, "data") else None
            pp_dp = axis_size(pp_mesh, "data") if pp_batch_axis else 1
            if batch_size % (pp_microbatches * pp_dp):
                raise ValueError(f"batch_size {batch_size} not divisible by pp_microbatches "
                                 f"{pp_microbatches} x DP width {pp_dp}")
            self._pp = make_pp_flagship(
                pp_mesh, eps=eps, num_steps=num_steps, h_taps=self._h_taps, depth=self._depth,
                compute_dtype=compute_dtype, encoder=self._encoder, mode=mode, engine=engine,
                dae_arch=dae_arch, batch_axis=pp_batch_axis,
            )
            self._pp_microbatches = pp_microbatches

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
        dae_tied: bool = False,
        h_taps: tuple[str, ...] = ("pool4",),
        **kwargs,
    ) -> "Predictor":
        """Load flat-npz exports (JAX layout, from either package). The score
        network's shape-invisible flags (encoder, depth, stem_pool, tail,
        widths, tied) are checked against the checkpoint's stamped metadata
        first."""
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
                widths=dae_widths, encoder=dae_encoder, tied=dae_tied,
            )
            check_npz_meta(dae_npz, expect, context=f"Predictor.from_npz({dae_npz})")
            dae_t = init_score_template(
                dae_arch, gen, n_classes=dataset.n_classes, h_taps=tuple(h_taps),
                depth=dae_depth, stem_pool=dae_stem_pool, tail=dae_tail, widths=dae_widths,
                tied=dae_tied, device=device,
            )
            dae = load_npz(dae_npz, dae_t)
        return cls(
            fcn, dae, device=device, dataset=dataset, h_taps=h_taps, dae_arch=dae_arch,
            dae_kwargs=score_kwargs(dae_arch, depth=dae_depth, encoder=dae_encoder), **kwargs,
        )

    def _predict(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One fixed-size chunk -> (labels int32, probs), whole on every rank
        under a mesh."""
        if self._pp is not None:
            from iterative_inference_segm_tpu_torch.parallel.pp import merge_microbatches, split_microbatches

            if self._normalize:
                x = normalize_image(x, self.cfg, input_scale=self._input_scale)
            _, yk = self._pp(self._fcn, self._dae, split_microbatches(x, self._pp_microbatches))
            y = merge_microbatches(yk)
            return torch.argmax(y, dim=-1).to(torch.int32), y.float()
        if self._mesh is None:
            return self._predict_local(x)
        from iterative_inference_segm_tpu_torch.parallel.sharding import gather_batch

        labels, probs = self._predict_local(self._x_sharding.local(x))
        return gather_batch(self._mesh, labels), gather_batch(self._mesh, probs)

    def _predict_local(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One chunk on this rank -> (labels int32, probs at the state dtype)."""
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
            y = logits_refinement_scan(
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
