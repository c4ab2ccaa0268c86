"""Experiment naming + metric logging.

Port of ``iterative_inference_segm_tpu.utils.experiment`` (pure Python): the
run directory is a pure function of the hyperparameters, and metrics go to
an append-only JSONL log that a resumed run reads back.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path


def build_experiment_name(prefix: str, **hparams) -> str:
    """Deterministic experiment name from sorted hyperparameters."""
    parts = [prefix]
    for k in sorted(hparams):
        v = hparams[k]
        if isinstance(v, float):
            v = f"{v:g}"
        elif isinstance(v, (list, tuple)):
            v = "-".join(str(x) for x in v)
        parts.append(f"{k}={v}")
    return "_".join(parts)


class MetricLogger:
    """Append-only JSONL metrics log with wall-clock stamps."""

    def __init__(self, directory: str | os.PathLike, filename: str = "metrics.jsonl"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / filename

    def log(self, step: int, **metrics) -> dict:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def read(self) -> list[dict]:
        if not self.path.exists():
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
