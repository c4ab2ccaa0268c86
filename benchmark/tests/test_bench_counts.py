"""The operation and byte counts against hand counts."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, reference
from benchmark.tests.bench_cells import ROOT
from benchmark.weights import make_params


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_one_conv():
    x = torch.empty((1, 64, 45, 60), device="meta")
    p = {"w": torch.empty((128, 64, 3, 3), device="meta"), "b": torch.empty(128, device="meta")}
    with FlopCounterMode(display=False) as fc:
        reference.conv(x, p)
    assert fc.get_total_flops() == 2 * 45 * 60 * 128 * 64 * 9


def test_one_transposed_conv():
    x = torch.empty((1, 11, 45, 60), device="meta")
    with FlopCounterMode(display=False) as fc:
        y = reference.up(x, torch.empty((11, 11, 16, 16), device="meta"), 8)
    assert tuple(y.shape) == (1, 11, 360, 480)
    assert fc.get_total_flops() == 2 * 45 * 60 * 11 * 11 * 16 * 16  # each input pixel scattered once


def test_fcn8_by_hand():
    """FCN-8 at 360x480: every layer's multiply-adds, twice."""
    def conv(h, w, cin, cout, k):
        return 2 * h * w * cin * cout * k * k

    vgg = [(360, 480, [(3, 64), (64, 64)]), (180, 240, [(64, 128), (128, 128)]),
           (90, 120, [(128, 256), (256, 256), (256, 256)]), (45, 60, [(256, 512), (512, 512), (512, 512)]),
           (23, 30, [(512, 512)] * 3)]
    hand = sum(conv(h, w, a, b, 3) for h, w, layers in vgg for a, b in layers)
    hand += conv(12, 15, 512, 4096, 7) + conv(12, 15, 4096, 4096, 1) + conv(12, 15, 4096, 11, 1)
    hand += conv(12, 15, 11, 11, 4) + conv(23, 30, 512, 11, 1) + conv(23, 30, 11, 11, 4)
    hand += conv(45, 60, 256, 11, 1) + conv(45, 60, 11, 11, 16)
    cfg = _config("fcn8_dae_half_camvid")
    fcn, _ = make_params(cfg, 0, "meta")
    with FlopCounterMode(display=False) as fc:
        reference.fcn8(fcn, torch.empty((1, 360, 480, 3), device="meta"), cfg)
    assert fc.get_total_flops() == hand
    assert abs(hand / 149.2e9 - 1) < 0.005  # the port's own count of the forward (PERF.md)


@pytest.mark.parametrize("name", ["fcn8_dae_half_camvid", "fcn8_dae_general_camvid"])
def test_model_flops_exceed_the_fcn(name):
    cfg = _config(name)
    total = counts.model_flops_per_image(cfg)
    assert 150e9 < total < 260e9


def test_one_tail_launch():
    # the half engine's rectification at batch 128: u, v, y read and y' written
    # in bf16, int32 labels written
    px = 128 * 360 * 480
    n = counts.tail_launch(px, 11, u=2, v=2, y=2, labels=True)
    assert n == {"bytes": px * 11 * 8 + px * 4, "flops": px * 11 * 9}


def test_tail_launches_per_call():
    half = counts.refine_tail_launches(_config("fcn8_dae_half_camvid"), 128)
    assert len(half) == 6 and half[0]["bytes"] == 128 * 180 * 240 * 11 * 8
    general = counts.refine_tail_launches(_config("fcn8_dae_general_camvid"), 128)
    assert len(general) == 5 and general[0] == {"bytes": 128 * 360 * 480 * 11 * 10, "flops": 128 * 360 * 480 * 11 * 8}


def test_peaks():
    assert counts.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert counts.peaks("cpu") is None
