"""One cell run as the driver runs it, on the card (marker ``cuda``; skips
without one). Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.tests.bench_cells import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "half_b32", "--seed",
                          str(2**31 + 77 + trace), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer" if trace else "end_to_end"] if "half_b32" in m.get("workloads", ["half_b32"])}
    assert set(result["metrics"]) == want
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"] and len(result["breakdown"]["device_ops"]) <= 10
