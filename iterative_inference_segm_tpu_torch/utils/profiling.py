"""Profiling instrumentation.

``trace`` captures a ``torch.profiler`` trace (CPU, and CUDA where there is
a card) around a region and writes it into ``logdir`` as a Chrome trace.

``span`` marks a named host range inside the program. It is recorded only
while a ``torch.profiler`` session is active, as a ``cpu_op`` on the
profiler's clock beside the device's events; with no session it records
nothing. A ``cpu_op`` stays on the host's timeline: the profiler mirrors
only ``record_function``'s user annotations onto the device's, where a span
would read as device time. The spans, all in ``inference/predictor.py``
``Predictor.predict``, siblings within a call, and the benchmark's metric
each feeds (``benchmark/metrics/<metric>.py``: the span's time less the
device-busy time inside it, a call):

- ``predict.stage_in``: the request's conversion to float32, then per
  chunk the slice, the copy into the staging buffer (zero padding) and the
  launch of its copy to the device -> ``stage_in_host_ms_per_call``;
- ``predict.fcn8``: per chunk, the normalization and FCN-8 ->
  ``fcn_host_ms_per_call``;
- ``predict.refine``: per chunk, the refinement engine and its label step
  -> ``refine_host_ms_per_call``;
- ``predict.stage_out``: per chunk, the launch of the labels' copy into the
  array returned (on the first chunk, taking that array from the output
  ring; probabilities are copied in full) -> ``stage_out_host_ms_per_call``;
- ``predict.gather``: the one wait for the last copy, before the array is
  handed over -> ``gather_host_ms_per_call``.

Nested in ``stage_in`` or ``stage_out``, ``predict.pin_alloc`` wraps each
allocation of a host buffer the ``Predictor`` keeps (page-locked on a
card): the staging buffer, made once for a shape, and a miss of the output
ring. It is never recorded on a hit, so its count a call,
``pin_alloc_per_call``, is the ring's miss rate once the staging buffer is
made.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

TRACE_FILE = "trace.json"
_OFF = contextlib.nullcontext()


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


def span(name: str):
    """A context manager that records the block as the host range ``name``
    (a ``cpu_op``) while a profiler session is active, and does nothing
    otherwise.

    Usage::
        with profiling.span("predict.gather"):
            done.synchronize()
    """
    return _RecordFunctionFast(name) if _autograd_profiler._is_profiler_enabled else _OFF
