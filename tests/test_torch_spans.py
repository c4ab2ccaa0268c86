"""The port's spans on the CPU: ``utils.profiling.span`` records a
``cpu_op`` only under a profiler; ``Predictor.predict`` records its five
stages in order, disjoint and inside the call, without changing its labels,
and ``predict.pin_alloc`` once for each host buffer it allocates; and the
benchmark's five span metrics read them from ``benchmark.trace``.
Small shapes: C = 5, 48x64, fc 16, DAE widths (8, 16, 32)."""

import json
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmark import harness  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.models.registry import init_score_template  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import profiling  # noqa: E402
from torch_port_helpers import HW, TINY_T  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
C = TINY_T.n_classes
STAGES = ("predict.stage_in", "predict.fcn8", "predict.refine", "predict.stage_out")
METRICS = ("stage_in_host_ms_per_call", "fcn_host_ms_per_call", "refine_host_ms_per_call",
           "stage_out_host_ms_per_call", "gather_host_ms_per_call")


def test_span_is_a_cpu_op_recorded_only_under_a_profiler(tmp_path):
    with profiling.span("spans.off"):  # entered with no profiler: records nothing
        with profiling.trace(str(tmp_path)):
            with profiling.span("spans.on"):
                torch.ones((4, 4)) + 1
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    cats = {e.get("cat") for e in events if e.get("name") == "spans.on"}
    assert cats == {"cpu_op"}  # not a user annotation, which the profiler mirrors onto the device
    assert not [e for e in events if e.get("name") == "spans.off"]


def _predictor(engine):
    gen = torch.Generator().manual_seed(0)
    fcn = init_fcn8(gen, n_classes=C, fc_channels=16)
    dae = init_score_template("dae", gen, n_classes=C, depth=3, stem_pool=1, widths=(8, 16, 32))
    return Predictor(fcn, dae, device="cpu", dataset=TINY_T, engine=engine, num_steps=2, batch_size=2,
                     compute_dtype=torch.float32, dae_kwargs={"depth": 3})


@pytest.fixture(scope="module", params=["half", "general"])
def traced(request):
    """One call of 5 frames at batch 2 (3 chunks, the last one padded)
    inside the benchmark's call span under a CPU profiler, and the labels
    of the same call unprofiled."""
    predictor = _predictor(request.param)
    images = np.random.default_rng(4).random((5, *HW, 3), dtype=np.float32)
    plain = predictor.predict(images)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(btrace.CALL_SPAN):
            labels = predictor.predict(images)
    return prof, labels, plain


def test_predict_records_its_stages_in_order(traced):
    prof, labels, plain = traced
    np.testing.assert_array_equal(labels, plain)
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    (call_a, call_b, _, thread), = [e for e in events if e[2] == btrace.CALL_SPAN]
    spans = sorted(e for e in events if e[2] in (*STAGES, "predict.gather") and e[3] == thread)
    assert [n for _, _, n, _ in spans] == ["predict.stage_in", *STAGES * 3, "predict.gather"]
    assert call_a <= spans[0][0] and spans[-1][1] <= call_b
    assert all(b <= a2 for (_, b, _, _), (a2, _, _, _) in zip(spans, spans[1:]))  # disjoint


def test_span_metrics_read_the_trace(traced):
    t = btrace.from_profiler(traced[0])
    cell = types.SimpleNamespace(config={}, traffic={"batch": 5})
    run = harness.Run(cell, 0.0, len(t.calls), 1.0, [1.0], 0, "cpu", trace=t)
    entries = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    read = {m: harness.load_metric(ROOT, entries[m]).read(run) for m in (*METRICS, "host_ms_per_call")}
    assert read.pop("host_ms_per_call") is None  # no device event on the CPU
    assert all(v is not None and v > 0 for v in read.values()), read
    call_ms = sum(b - a for a, b in t.calls) / len(t.calls) / 1e6
    assert sum(read.values()) <= call_ms


def _pin_allocs(predictor, calls):
    """The ``predict.pin_alloc`` events inside each of ``calls`` (thunks
    that call ``predictor.predict``), run in one CPU profiler session."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for call in calls:
            with torch.profiler.record_function(btrace.CALL_SPAN):
                call()
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()]
    windows = sorted((a, b) for a, b, n in events if n == btrace.CALL_SPAN)
    allocs = [a for a, _, n in events if n == "predict.pin_alloc"]
    assert all(any(lo <= a <= hi for lo, hi in windows) for a in allocs)
    return [sum(lo <= a <= hi for a in allocs) for lo, hi in windows]


def test_pin_alloc_once_per_miss_never_on_a_hit():
    predictor = _predictor("half")
    rng = np.random.default_rng(5)
    four, three = rng.random((4, *HW, 3), dtype=np.float32), rng.random((3, *HW, 3), dtype=np.float32)
    held = []
    counts = _pin_allocs(predictor, [
        lambda: predictor.predict(four),  # the staging buffer and the first output slot
        lambda: predictor.predict(four),  # the first slot again: its array is gone
        lambda: held.append(predictor.predict(four)),  # a hit, then held
        lambda: predictor.predict(four),  # the held slot is skipped: a second one
        lambda: predictor.predict(three),  # another shape: a third slot
        lambda: predictor.predict(three),  # the third slot again
    ])
    assert counts == [2, 0, 0, 1, 1, 0]
