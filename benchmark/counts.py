"""Operations and bytes, counted from the configuration's shapes, and the
table of peaks they are held against.

``model_flops_per_image`` counts the frozen reference (``reference.py``)
at batch 1 on the meta device with ``torch.utils.flop_counter.
FlopCounterMode``: the convolutions, transposed convolutions and matmuls
of the model's math, whatever the port does to compute it.
``refine_tail_launches`` gives each launch of the port's tail kernel K3
(``refine_tail``) in one call of ``Predictor.predict``, in order, with the
bytes it must move (each operand read once, each result written once, at
the configuration's dtypes) and its operations.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def peaks(device_kind: str) -> dict | None:
    """The published peaks of the card named ``device_kind`` (None for a
    card the table does not hold)."""
    for key, row in json.loads(PEAKS_FILE.read_text())["cards"].items():
        if key in device_kind:
            return row
    return None


def model_flops_per_image(config: dict) -> float:
    """Operations of one image through FCN-8 and the refinement, as the
    reference computes them."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import reference
    from benchmark.weights import make_params

    ds = config["dataset"]
    fcn, dae = make_params(config, 0, "meta")
    frames = torch.empty((1, ds["height"], ds["width"], ds["in_channels"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        reference.refine(fcn, dae, frames, config)
    return float(counter.get_total_flops())


def tail_launch(px: int, c: int, *, u: int, y: int, v: int = 0, labels: bool = False, bias: bool = False) -> dict:
    """Bytes and operations of one K3 launch over ``px`` pixels of ``c``
    classes: ``u`` (cropped to the output), ``v`` (0: absent) and ``y`` read
    at those element sizes, ``y'`` written at ``y``'s, int32 labels
    written when asked. Operations a class element: the adds of u, v (and
    the bias), max, subtract, exp, sum, divide, the blend's two multiplies
    and add."""
    nbytes = px * c * (u + v + 2 * y) + (4 * px if labels else 0)
    return {"bytes": nbytes, "flops": px * c * (8 + (v > 0) + bias)}


def refine_tail_launches(config: dict, batch: int) -> list[dict]:
    """The K3 launches of one ``predict`` call of ``batch`` frames."""
    ds, k = config["dataset"], config["num_steps"]
    c, h, w = ds["n_classes"], ds["height"], ds["width"]
    cs, ss = DTYPE_BYTES[config["compute_dtype"]], DTYPE_BYTES[config["state_dtype"]]
    if config["engine"] == "general":
        return [tail_launch(batch * h * w, c, u=cs, y=ss)] * k
    if config["engine"] == "half":
        step = tail_launch(batch * (h // 2) * (w // 2), c, u=cs, v=ss, y=ss)
        return [step] * k + [tail_launch(batch * h * w, c, u=ss, v=ss, y=ss, labels=True)]
    raise ValueError(f"unknown engine {config['engine']!r}")
