"""The reader of ``pin_alloc_per_call`` on hand-made events: the port's
``predict.pin_alloc`` spans inside the window, over the calls; 0.0 where a
trace holds none, None where there is no trace."""

import json
import types

from benchmark import harness, trace
from benchmark.tests.bench_cells import ROOT

CALLS = [(0, 100), (100, 200), (200, 300), (300, 400)]


def _read(host):
    entry = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}["pin_alloc_per_call"]
    assert entry["unit"] == "count" and entry["moves"] == "images_per_s" and entry["layer"] == "serving entry"
    t = trace.Trace([(10, 40, "k_a")], CALLS, sorted(host))
    cell = types.SimpleNamespace(config={}, traffic={"batch": 1})
    run = harness.Run(cell, 1.0, len(CALLS), 4e-7, [1e-7] * len(CALLS), 0, "NVIDIA H100 80GB HBM3", trace=t)
    return harness.load_metric(ROOT, entry).read(run)


def test_counts_the_window_spans_per_call():
    host = [(5, 8, "predict.pin_alloc"), (20, 30, "predict.pin_alloc"), (150, 160, "predict.pin_alloc"),
            (-50, -10, "predict.pin_alloc"), (20, 30, "predict.stage_in")]  # the span before the window left out
    assert _read(host) == 3 / 4


def test_reads_zero_with_none_and_nothing_without_a_trace():
    assert _read([(20, 30, "predict.stage_in")]) == 0.0
    entry = {"name": "pin_alloc_per_call", "unit": "count", "better": "lower", "source": "device_trace"}
    assert harness.load_metric(ROOT, entry).read(types.SimpleNamespace(trace=None)) is None
