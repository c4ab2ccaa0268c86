"""The harness is driven by data: a cell, a configuration and a metric added
as new files (and entries in BENCHMARK.json) are found by name and run, with
no edit to any file of the harness; and BENCHMARK.json keeps to the shape the
benchmark's contract sets."""

import json
import re
import shutil
import time

import pytest

from benchmark import harness
from benchmark.tests.bench_cells import ROOT, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_new_cell_configuration_and_metric_as_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())

    cfg = json.loads((ROOT / "benchmark" / "configs" / "fcn8_dae_general_camvid.json").read_text())
    cfg["dataset"].update(TINY)
    cfg["fcn"]["fc_channels"] = 16
    cfg["num_steps"] = 2
    (tmp_path / "benchmark" / "configs" / "tiny_general.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "closed_b3.json").write_text(json.dumps(
        {"batch": 3, "pool_batches": 2, "warmup_calls": 1, "check_calls": 1, "check_images_per_call": 3,
         "ref_block": 3}))
    (tmp_path / "benchmark" / "metrics" / "calls_done.py").write_text(
        'def read(run):\n    return run.calls\n')
    bench["configs"].append({"name": "tiny_general", "source": "https://arxiv.org/abs/1705.07450",
                             "file": "benchmark/configs/tiny_general.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_b3", "config": "tiny_general", "traffic": "closed_b3", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": ["tiny_b3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(tmp_path, "tiny_b3")
    assert cell.config["num_steps"] == 2 and cell.traffic["batch"] == 3
    assert [m.name for m in cell.end_to_end][-1] == "calls_done"
    assert "calls_done" not in [m.name for m in harness.load_cell(tmp_path, "half_b32").end_to_end]
    out = harness.run_cell(cell, seed=2**32 + 9, seconds=0.5, trace=False, device="cpu", t0=time.perf_counter())
    assert out["correct"], out["check"]
    assert out["metrics"]["calls_done"] == {"value": float(out["attempted"]), "unit": "calls"}
    assert list(out)[-1] == "check"


def test_unknown_cell_and_metric_raise(tmp_path):
    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        harness.load_metric(ROOT, {"name": "no_such_metric", "unit": "s", "better": "lower",
                                   "source": "host_clock"})


def test_every_metric_of_benchmark_json_has_a_reader():
    bench = _bench()
    for kind in ("end_to_end", "per_layer"):
        for entry in bench[kind]:
            m = harness.load_metric(ROOT, entry)
            assert (m.name, m.unit, m.better, m.source) == (entry["name"], entry["unit"], entry["better"],
                                                            entry["source"])
            assert callable(m.read)


def test_benchmark_json_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1].startswith("benchmark/")
    assert 1 <= bench["run_seconds"] <= 51
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/") and c["reduced"] == []
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(bench)) < 64 * 1024
