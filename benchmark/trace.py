"""The traced window: ``torch.profiler`` over the calls, reduced to the
intervals the per-layer metrics read.

Each ``predict`` call runs inside ``record_function(CALL_SPAN)``, the
benchmark's own span, so the calls and the device's operations share the
profiler's clock. ``Trace`` keeps the device operations (kernels, copies,
memsets) and the host operations of the calling thread, all clipped to the
window from the first call's start to the last call's end.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

CALL_SPAN = "bench.predict"
TOP = 10
NAME_CHARS = 160


def busy_us(intervals) -> float:
    """The length of the union of (start, end) intervals: the time the
    device ran at least one operation (operations on concurrent streams
    overlap, and their durations then sum past it). A copy of the port's
    ``tools/profile_general.busy_us``."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    """Times in nanoseconds on the profiler's clock. ``device``: (start,
    end, name) of every device operation; ``calls``: (start, end) of every
    call span; ``host``: (start, end, name) of the host operations on the
    calls' thread, sorted by start."""

    device: list[tuple[int, int, str]]
    calls: list[tuple[int, int]]
    host: list[tuple[int, int, str]] = field(default_factory=list)

    def __post_init__(self):
        self.calls = sorted(self.calls)
        if not self.calls:
            raise ValueError("the trace holds no call span")
        lo, hi = self.calls[0][0], self.calls[-1][1]
        self.device = sorted((max(a, lo), min(b, hi), n) for a, b, n in self.device if b > lo and a < hi)
        self.busy = merged((a, b) for a, b, _ in self.device)
        self._busy_starts = [a for a, _ in self.busy]
        self._host_starts = [a for a, _, _ in self.host]

    @property
    def window_ns(self) -> int:
        return self.calls[-1][1] - self.calls[0][0]

    @property
    def busy_ns(self) -> float:
        return busy_us((a, b) for a, b, _ in self.device)

    def busy_within(self, lo: float, hi: float) -> float:
        """Device-busy nanoseconds inside [lo, hi]."""
        i = max(bisect.bisect_right(self._busy_starts, lo) - 1, 0)
        total = 0.0
        while i < len(self.busy) and self.busy[i][0] < hi:
            a, b = self.busy[i]
            total += max(0.0, min(b, hi) - max(a, lo))
            i += 1
        return total

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the window."""
        out, at = [], self.calls[0][0]
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.calls[-1][1] > at:
            out.append((at, self.calls[-1][1]))
        return out

    def host_at(self, t: float) -> str:
        """What the calling thread did at ``t``: the innermost host
        operation running then, else whether a call was."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - 20000, -1), -1):
            a, b, name = self.host[j]
            if b >= t:
                return name
        k = bisect.bisect_right(self.calls, (t, float("inf"))) - 1
        if k >= 0 and self.calls[k][1] >= t:
            return "predict: host code outside torch operations"
        return "harness: between calls"

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each in seconds, at most ``TOP`` a list."""
        ops: dict[str, float] = defaultdict(float)
        for a, b, name in self.device:
            ops[name[:NAME_CHARS]] += (b - a) / 1e9
        idle: dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            idle[self.host_at((a + b) / 2)[:NAME_CHARS]] += (b - a) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def from_profiler(prof) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``, read from its
    raw events (no per-event Python objects of the profiler's own)."""
    from torch.autograd import DeviceType

    device, calls, host = [], [], []
    rows = ((e.name(), e.device_type(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events())
    call_thread = None
    for name, kind, a, b, tid in rows:
        if kind == DeviceType.CUDA:
            if name != CALL_SPAN:  # the span's own mirror on the device's timeline
                device.append((a, b, name))
        elif name == CALL_SPAN:
            calls.append((a, b))
            call_thread = tid
        else:
            host.append((a, b, name, tid))
    host = sorted((a, b, n) for a, b, n, t in host if t == call_thread)
    return Trace(device, calls, host)
