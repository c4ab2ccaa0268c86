"""The span readers on hand-made events: a span's time less the device-busy
time inside it, summed over the window's spans of that name and divided by
the calls; None where the trace holds no such span."""

import json
import types

from benchmark import harness, spans, trace
from benchmark.tests.bench_cells import ROOT

# two calls of 100 ns; the device busy 10-40, 50-70 and 120-150
DEVICE = [(10, 40, "Memcpy HtoD (Pageable -> Device)"), (50, 70, "k_a"), (120, 150, "Memcpy DtoH (Device -> Pageable)")]
CALLS = [(0, 100), (100, 200)]
HOST = [(5, 45, "predict.stage_in"), (20, 30, "aten::copy_"), (45, 100, "predict.gather"),
        (105, 125, "predict.stage_in"), (130, 190, "predict.gather"), (-50, -10, "predict.gather")]
SPANS = {"stage_in_host_ms_per_call": "predict.stage_in", "fcn_host_ms_per_call": "predict.fcn8",
         "refine_host_ms_per_call": "predict.refine", "stage_out_host_ms_per_call": "predict.stage_out",
         "gather_host_ms_per_call": "predict.gather"}


def _run(host, calls=CALLS):
    t = trace.Trace(DEVICE, calls, sorted(host))
    cell = types.SimpleNamespace(config={}, traffic={"batch": 1})
    return harness.Run(cell, 1.0, len(calls), 2e-7, [1e-7] * len(calls), 0, "NVIDIA H100 80GB HBM3", trace=t)


def test_span_less_busy_within_over_calls():
    run = _run(HOST)
    # stage_in: (40 - 30) + (20 - 5); gather: (55 - 20) + (60 - 20), the span before the window left out
    assert spans.host_ms_per_call(run, "predict.stage_in") == (10 + 15) / 2 / 1e6
    assert spans.host_ms_per_call(run, "predict.gather") == (35 + 40) / 2 / 1e6
    assert spans.host_ms_per_call(run, "aten::copy_") == 0.0  # inside a copy: all busy
    assert spans.host_ms_per_call(run, "predict.refine") is None
    assert spans.host_ms_per_call(types.SimpleNamespace(trace=None), "predict.gather") is None
    # the same spans over four calls: half a call's share each
    four = _run(HOST, CALLS + [(200, 250), (250, 300)])
    assert spans.host_ms_per_call(four, "predict.gather") == (35 + 40) / 4 / 1e6


def test_each_reader_reads_its_span():
    entries = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for metric, name in SPANS.items():
        read = harness.load_metric(ROOT, entries[metric]).read
        assert read(_run([])) is None  # a program without the spans: nothing to read
        assert read(_run([(60, 90, name)])) == (30 - 10) / 2 / 1e6
        assert entries[metric]["moves"] == "images_per_s" and entries[metric]["unit"] == "ms"
