"""Serving entry: the host's time a ``predict`` call, in ms. For each call,
the benchmark's span around it less the device-busy time inside it (the
union of kernel and copy intervals), averaged over the traced calls."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    host_ns = sum((b - a) - t.busy_within(a, b) for a, b in t.calls)
    return host_ns / 1e6 / len(t.calls)
