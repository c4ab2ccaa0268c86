"""What decides ``correct``: the served answers against the plain reference.

The sample is drawn from the seed: ``check_calls`` of the window's calls,
kept by reservoir sampling while the window runs, and
``check_images_per_call`` frames of each. Once the window has closed the
reference refines those frames in float32 (``reference.refine``, in blocks
of ``ref_block`` frames) and three numbers are read:

* ``label_gap``: the widest gap, over every sampled pixel, by which the
  reference's probability of the served label lies below its best one;
* ``probs_err``: the largest absolute difference between the refined
  probabilities that a ``return_probs=True`` call outside the window
  served for the first kept call's frames and the reference's;
* ``logp_mae``: the mean absolute difference of the logarithms of those
  probabilities (each clamped to ``LOG_FLOOR``), which weighs the
  refinement's small moves of confident maps as much as the FCN's.

Each number is held to its limit in the configuration file (``limits``).
``numbers`` reads the same three for a stand-in put in the program's place:
``"fp8"``, the control (the reference under ``reference.fp8_e4m3``), or
``"unrefined"``, the reference with every refinement step returning its
state unchanged (the FCN's softmax served as it is).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark import reference

LOG_FLOOR = 1e-6


@dataclass
class Sample:
    """The frames of one kept call and what the program served for them:
    ``labels`` (n, H, W); ``probs`` (n, H, W, classes) or None."""

    frames: np.ndarray
    labels: np.ndarray
    probs: np.ndarray | None = None


class Reservoir:
    """A uniform sample of ``k`` of the calls seen, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.kept = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            r = int(self.rng.integers(0, self.seen + 1))
            if r < self.k:
                self.kept[r] = item
        self.seen += 1


def _reference_probs(fcn, dae, config, frames: np.ndarray, device, block: int, stand_in=None) -> torch.Tensor:
    out = []
    with torch.no_grad():
        for a in range(0, len(frames), block):
            x = torch.from_numpy(frames[a: a + block]).to(device)
            if stand_in == "unrefined":
                out.append(reference.fcn8(fcn, x, config)[0].permute(0, 2, 3, 1))
            else:
                quant = reference.fp8_e4m3 if stand_in == "fp8" else None
                out.append(reference.refine(fcn, dae, x, config, quant))
    return torch.cat(out)


def numbers(fcn, dae, config, samples: list[Sample], device, block: int, stand_in: str | None = None) -> dict:
    """The three numbers over ``samples``; with ``stand_in`` ("fp8" or
    "unrefined") those of that stand-in in the program's place (its
    argmax as the served labels, its probabilities as the served ones)."""
    if stand_in not in (None, "fp8", "unrefined"):
        raise ValueError(f"unknown stand-in {stand_in!r}")
    reference.exact_f32()
    gap, probs_err, logp_mae = 0.0, None, None
    for s in samples:
        ref = _reference_probs(fcn, dae, config, s.frames, device, block)
        if stand_in is not None:
            other = _reference_probs(fcn, dae, config, s.frames, device, block, stand_in)
            labels, probs = other.argmax(-1), other
        else:
            labels = torch.from_numpy(s.labels).to(device).long()
            probs = None if s.probs is None else torch.from_numpy(s.probs).to(device)
        best = ref.max(dim=-1).values
        served = ref.gather(-1, labels[..., None])[..., 0]
        gap = max(gap, float((best - served).max()))
        if probs is not None and probs_err is None:
            probs = probs.float()
            probs_err = float((probs - ref).abs().max())
            logp_mae = float((probs.clamp(min=LOG_FLOOR).log() - ref.clamp(min=LOG_FLOOR).log()).abs().mean())
    out = {"label_gap": gap}
    if probs_err is not None:
        out.update(probs_err=probs_err, logp_mae=logp_mae)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number beside its limit; correct when every one is
    present, finite and within it."""
    shown, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        shown[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and bool(np.isfinite(v)) and v <= limit
    return ok, shown
