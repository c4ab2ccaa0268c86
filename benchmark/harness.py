"""One run of one cell: set-up, the measured window, the check, the result.

A cell is named in ``BENCHMARK.json``; it pairs a configuration (the file
its ``configs`` entry names) with a traffic mix (``benchmark/traffic/
<traffic>.json``). Each metric is a reader in ``benchmark/metrics/
<name>.py``. All three are found by name under the checkout's root, so a
new cell, configuration or metric is new files alone.

The window drives ``Predictor.predict`` of the port in a closed loop with
one client: each call hands ``batch`` host frames (float32 in [0, 1]) from
a pool of ``pool_batches`` distinct batches made from the seed, and gets
the labels back as a numpy array. Set-up makes the weights and the frames,
builds the ``Predictor`` and runs ``warmup_calls`` calls; the window then
runs whole calls until ``seconds`` have passed. With ``trace`` the window
runs under ``torch.profiler`` and the per-layer metrics are read from it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from benchmark import check, weights
from benchmark.trace import CALL_SPAN, Trace, from_profiler

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "iterative_inference_segm_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    read: object  # Run -> float | None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]


@dataclass
class Run:
    """What the readers read."""

    cell: Cell
    setup_s: float
    calls: int
    window_s: float
    latencies_s: list[float]
    window_peak_bytes: int
    device_kind: str
    trace: Trace | None = None

    @property
    def batch(self) -> int:
        return int(self.cell.traffic["batch"])


def forbidden_modules(names) -> list[str]:
    """The module names whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_metric(root: Path, entry: dict) -> Metric:
    """The metric of a ``BENCHMARK.json`` entry: its unit, direction and
    source from the entry, its reader ``read(run)`` from
    ``benchmark/metrics/<name>.py``."""
    name = entry["name"]
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return Metric(name, entry["unit"], entry["better"], entry["source"], mod.read)


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and metrics."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())

    def metrics(kind):
        return [load_metric(root, m) for m in bench[kind] if name in m.get("workloads", [name])]

    return Cell(name, int(w["chips"]), config, traffic, metrics("end_to_end"), metrics("per_layer"))


def require_devices(chips: int) -> str | None:
    """None when this machine has ``chips`` CUDA cards, else why not."""
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} CUDA devices; this machine has {torch.cuda.device_count()}"
    return None


def card_stamp() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def build_predictor(config: dict, fcn: dict, dae: dict, batch: int, device):
    """The port's ``Predictor`` for the configuration."""
    from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
    from iterative_inference_segm_tpu_torch.inference.predictor import Predictor

    ds, spec = config["dataset"], config["dae"]
    dataset = dataclasses.replace(
        CAMVID, n_classes=ds["n_classes"], void_label=ds["n_classes"], height=ds["height"],
        width=ds["width"], in_channels=ds["in_channels"], mean=tuple(ds["mean"]), std=tuple(ds["std"]))
    return Predictor(
        fcn, dae, device=device, dataset=dataset, eps=config["eps"], num_steps=config["num_steps"],
        h_taps=tuple(spec["h_taps"]), mode=config["mode"], engine=config["engine"], dae_arch="dae",
        batch_size=batch, compute_dtype=DTYPES[config["compute_dtype"]],
        dae_kwargs={"depth": spec["depth"], "encoder": spec["encoder"]},
    )


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def set_up(cell: Cell, seed: int, device, since: float | None = None):
    """The weights, the pool of frames and the warmed ``Predictor`` of one
    seed: ``(fcn, dae, pool, predictor)``. With ``since`` (a time on
    ``time.perf_counter``) each step's seconds go to standard error."""
    cfg, tr = cell.config, cell.traffic
    at = time.perf_counter() if since is None else since
    log = _log if since is not None else (lambda what, t: time.perf_counter())
    at = log("set-up: the interpreter and the imports", at)
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    at = log("set-up: the CUDA context", at)
    fcn, dae = weights.make_params(cfg, seed, device)
    pool = weights.make_frames(int(tr["pool_batches"]), int(tr["batch"]), cfg, seed, device)
    _sync(device)
    at = log("set-up: weights and frames", at)
    predictor = build_predictor(cfg, fcn, dae, int(tr["batch"]), device)
    _sync(device)
    at = log("set-up: the Predictor", at)
    for i in range(int(tr["warmup_calls"])):
        predictor.predict(pool[i % len(pool)])
        _sync(device)
        at = log(f"set-up: warm-up call {i + 1}", at)
    return fcn, dae, pool, predictor


def serve(cell: Cell, predictor, pool, rng, *, seconds: float | None = None, calls: int | None = None,
          span=contextlib.nullcontext):
    """Whole calls in a closed loop until ``seconds`` have passed (or
    ``calls`` are done). Returns ``(latencies, failed, kept, window_s)``:
    ``kept`` the reservoir of (pool index, labels) that the check
    samples."""
    batch, ds = int(cell.traffic["batch"]), cell.config["dataset"]
    expect = (batch, ds["height"], ds["width"])
    kept = check.Reservoir(int(cell.traffic["check_calls"]), rng)
    latencies, failed = [], 0
    start = time.perf_counter()
    while True:
        j = len(latencies) % len(pool)
        a = time.perf_counter()
        with span():
            labels = predictor.predict(pool[j])
        b = time.perf_counter()
        latencies.append(b - a)
        if labels.shape != expect or labels.dtype != np.int32:
            failed += 1
        kept.offer((j, labels))
        if (b - start >= seconds) if calls is None else len(latencies) >= calls:
            break
    return latencies, failed, kept, time.perf_counter() - start


def samples_of(cell: Cell, predictor, pool, rng, kept) -> list[check.Sample]:
    """``check_images_per_call`` frames of each kept call, drawn from
    ``rng``, with the labels served for them; for the first kept call also
    the refined probabilities of a ``return_probs=True`` call of the same
    frames."""
    tr, out = cell.traffic, []
    for n, (j, labels) in enumerate(kept.kept):
        idx = np.sort(rng.choice(int(tr["batch"]), size=int(tr["check_images_per_call"]), replace=False))
        probs = predictor.predict(pool[j], return_probs=True)[1][idx] if n == 0 else None
        out.append(check.Sample(pool[j][idx], labels[idx], probs))
    return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _log(what: str, since: float) -> float:
    now = time.perf_counter()
    print(f"[bench] {what}: {now - since:.3f} s", file=sys.stderr, flush=True)
    return now


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run; returns the result line's object (``correct`` ... ``check``
    last). ``t0`` is the process's start on ``time.perf_counter``. Each
    phase's seconds go to standard error."""
    device = torch.device(device)
    fcn, dae, pool, predictor = set_up(cell, seed, device, since=t0)
    setup_s = time.perf_counter() - t0
    at = _log("set-up", t0)
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    rng = np.random.default_rng(weights.sub_seed(seed, "sample"))
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        at = _log("profiler start", at)
    span = (lambda: torch.profiler.record_function(CALL_SPAN)) if trace else contextlib.nullcontext
    try:
        latencies, failed, kept, window_s = serve(cell, predictor, pool, rng, seconds=seconds, span=span)
    finally:
        if prof is not None:
            with warnings.catch_warnings():  # "clears events at the end of each cycle": one cycle here
                warnings.simplefilter("ignore", UserWarning)
                prof.__exit__(None, None, None)
    window_peak = _peak(device)
    at = _log(f"window of {len(latencies)} calls (and the profiler's stop)", at)
    q = np.percentile(np.array(latencies) * 1e3, [0, 25, 50, 75, 90, 100])
    print("[bench] call ms: least %.2f, quartiles %.2f %.2f %.2f, p90 %.2f, most %.2f" % tuple(q), file=sys.stderr)

    # outside the window
    samples = samples_of(cell, predictor, pool, rng, kept)
    del predictor, kept
    free(device)

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(cell, setup_s, len(latencies), window_s, latencies, window_peak, kind,
              trace=from_profiler(prof) if prof is not None else None)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    at = _log("the sample's probabilities, the trace and the metrics", at)

    values = check.numbers(fcn, dae, cell.config, samples, device, int(cell.traffic["ref_block"]))
    _log("the reference's check", at)
    ok, shown = check.judge(values, cell.config["limits"])
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": bool(ok and failed == 0), "attempted": len(latencies), "failed": failed,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_ns / 1e9
        dev["window_s"] = run.trace.window_ns / 1e9
        out["breakdown"] = run.trace.breakdown()
    out["card"] = card_stamp() if device.type == "cuda" else "cpu"
    out["check"] = shown
    return out
