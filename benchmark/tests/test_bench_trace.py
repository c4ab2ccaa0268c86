"""The trace's reduction and the per-layer readers, on hand-made events."""

import json
import types

from benchmark import harness, trace
from benchmark.tests.bench_cells import ROOT

# two calls of 100 ns; kernels overlap in the first; a copy in each
DEVICE = [(10, 40, "Memcpy HtoD (Pageable -> Device)"), (30, 60, "k_a"), (50, 70, "void refine_tail_kernel<x>"),
          (120, 150, "Memcpy DtoH (Device -> Pageable)"), (160, 180, "void refine_tail_kernel<x>"),
          (-10, -5, "before the window")]
CALLS = [(0, 100), (100, 200)]
HOST = [(0, 100, "outer"), (72, 95, "aten::copy_"), (150, 160, "cudaMemcpyAsync")]


def test_union_gaps_and_attribution():
    t = trace.Trace(DEVICE, CALLS, sorted(HOST))
    assert trace.busy_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert t.window_ns == 200 and t.busy_ns == 60 + 30 + 20
    assert t.busy_within(0, 100) == 60 and t.busy_within(100, 200) == 50
    assert t.gaps() == [(0, 10), (70, 120), (150, 160), (180, 200)]
    assert t.host_at(80) == "aten::copy_" and t.host_at(155) == "cudaMemcpyAsync"
    assert t.host_at(190) == "predict: host code outside torch operations"
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["void refine_tail_kernel<x>", 40e-9]
    assert dict(bd["idle_gaps"])["outer"] == 10e-9


def _run(t, config):
    cell = types.SimpleNamespace(config=config, traffic={"batch": 1})
    return harness.Run(cell, 1.0, len(t.calls), 2e-7, [1e-7, 1e-7], 0, "NVIDIA H100 80GB HBM3", trace=t)


def test_readers():
    config = json.loads((ROOT / "benchmark" / "configs" / "fcn8_dae_general_camvid.json").read_text())
    config = dict(config, num_steps=1)
    t = trace.Trace(DEVICE, CALLS, sorted(HOST))
    run = _run(t, config)
    entries = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    read = {m: harness.load_metric(ROOT, entries[m]).read for m in
            ("host_ms_per_call", "copy_ms_per_call", "device_idle_pct", "refine_tail_roofline_pct")}
    assert read["host_ms_per_call"](run) == ((100 - 60) + (100 - 50)) / 2 / 1e6
    assert read["copy_ms_per_call"](run) == 60 / 2 / 1e6
    assert abs(read["device_idle_pct"](run) - 45.0) < 1e-9
    assert read["refine_tail_roofline_pct"](run) > 0  # one launch a call, as the configuration says
    assert read["refine_tail_roofline_pct"](_run(t, dict(config, num_steps=2))) is None  # launches do not match
