"""Faults planted in the port's served path, for showing that ``correct``
comes out false when the timed path is broken underneath.

* ``unchanged_step``: every refinement step returns its state unchanged
  (the tail kernel's call hands back its input, the labels its argmax);
* ``half_batch``: half of the batch left out, the other half served the
  first half's answers;
* ``altered_answer``: the first frame of each call served labels moved to
  another class.

The exchange between chips has no fault to plant: every cell runs on one
card. ``plant(name)`` is a context manager; the CPU tests and
``calibrate.py --fault`` use it.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

NAMES = ("unchanged_step", "half_batch", "altered_answer")


def _tail(u, y, eps, *, v=None, w=None, b=None, with_labels=False):
    return (y, torch.argmax(y, dim=-1).to(torch.int32)) if with_labels else y


@contextlib.contextmanager
def plant(name: str):
    from iterative_inference_segm_tpu_torch.inference import fused, iterative
    from iterative_inference_segm_tpu_torch.inference.predictor import Predictor

    served = Predictor._predict

    def first_half(self, x):
        n = x.shape[0] // 2
        labels, probs = served(self, x[:n])
        return torch.cat([labels, labels[: x.shape[0] - n]]), torch.cat([probs, probs[: x.shape[0] - n]])

    def altered(self, x):
        labels, probs = served(self, x)
        labels = labels.clone()
        labels[0] = (labels[0] + 5) % probs.shape[-1]
        return labels, probs

    if name == "unchanged_step":
        with mock.patch.object(fused, "refine_tail", _tail), mock.patch.object(iterative, "refine_tail", _tail):
            yield
    elif name == "half_batch":
        with mock.patch.object(Predictor, "_predict", first_half):
            yield
    elif name == "altered_answer":
        with mock.patch.object(Predictor, "_predict", altered):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}; known: {NAMES}")
