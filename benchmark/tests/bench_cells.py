"""Shared pieces of the benchmark's CPU tests: a cell cut to a tiny size."""

import copy
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TINY = {"height": 64, "width": 96}


def tiny(cell, fc_channels: int = 32, batch: int = 2):
    """``cell`` at 64x96 frames, fc ``fc_channels``, ``batch`` frames a
    call, every frame of a kept call checked; limits as configured."""
    cell = copy.deepcopy(cell)
    cell.config["dataset"].update(TINY)
    cell.config["fcn"]["fc_channels"] = fc_channels
    cell.traffic.update(batch=batch, check_images_per_call=batch, ref_block=batch, warmup_calls=1)
    return cell


def load(name: str):
    """The cell ``name`` of the repository's BENCHMARK.json."""
    from benchmark import harness

    return harness.load_cell(ROOT, name)
