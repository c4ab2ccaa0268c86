"""Profiling and throughput instrumentation.

The port of ``iterative_inference_segm_tpu.utils.profiling``: ``trace``
captures a ``torch.profiler`` trace (CPU, and CUDA where there is a card)
around a region and writes it into ``logdir`` as a Chrome trace;
``ThroughputMeter`` times items/s between two synchronization points.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str, *, enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the block into
    ``logdir/trace.json`` (chrome://tracing, Perfetto).

    Usage::
        with profiling.trace("/tmp/trace"):
            run_steps()
    """
    if not enabled:
        yield
        return
    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(logdir) / TRACE_FILE))


def _leaves(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x


def sync(x) -> None:
    """Wait for the work that produces ``x`` (a tensor or a tree of them):
    ``torch.cuda.synchronize`` on each CUDA device among its leaves; a
    no-op on the CPU, where the work is done when the call returns."""
    devices = {t.device for t in _leaves(x) if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class ThroughputMeter:
    """Streaming items/sec with device synchronization at measure points."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._items = 0
        self._t0 = None

    def start(self, sync_on=None) -> None:
        if sync_on is not None:
            sync(sync_on)
        self._t0 = time.perf_counter()
        self._items = 0

    def add(self, n: int) -> None:
        self._items += n

    def stop(self, sync_on=None) -> float:
        """Returns items/sec since start()."""
        if sync_on is not None:
            sync(sync_on)
        dt = time.perf_counter() - self._t0
        return self._items / dt if dt > 0 else float("inf")
