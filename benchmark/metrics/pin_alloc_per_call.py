"""Serving entry: the allocations of page-locked host memory a ``predict``
call makes (the port's ``predict.pin_alloc`` spans: the frames' staging
buffer, and a miss of the labels' ring), counted inside the traced window
over the traced calls. 0.0 where the trace holds none."""


def read(run):
    t = run.trace
    if t is None:
        return None
    lo, hi = t.calls[0][0], t.calls[-1][1]
    n = sum(1 for a, b, name in t.host if name == "predict.pin_alloc" and lo <= a and b <= hi)
    return n / len(t.calls)
