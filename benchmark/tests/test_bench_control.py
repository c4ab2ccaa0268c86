"""The control comes out not correct: the plain reference computed in float8
e4m3 (the precision below the configurations' bfloat16) in the program's
place, at the configurations' full size, on one frame on the CPU. The
readings it was set against on the card are in PERF.md."""

import json

import numpy as np
import pytest
import torch

from benchmark import check, weights
from benchmark.tests.bench_cells import ROOT


@pytest.mark.parametrize("name", ["fcn8_dae_half_camvid", "fcn8_dae_general_camvid"])
def test_control_fails_the_limits(name):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    fcn, dae = weights.make_params(cfg, 7, "cpu")
    frames = weights.make_frames(1, 1, cfg, 7, "cpu")[0]
    sample = check.Sample(frames, np.zeros(frames.shape[:3], np.int32))
    values = check.numbers(fcn, dae, cfg, [sample], "cpu", 1, stand_in="fp8")
    ok, shown = check.judge(values, cfg["limits"])
    assert not ok, shown
