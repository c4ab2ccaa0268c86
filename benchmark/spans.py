"""The port's own spans in the traced window: the host's time a ``predict``
call spent in one of them, by the rule ``host_ms_per_call`` applies to the
whole call."""


def host_ms_per_call(run, name: str):
    """The sum, over the window's host events named ``name``, of the span's
    duration less the device-busy time inside it, over the traced calls, in
    ms; None when the trace holds no such span."""
    t = run.trace
    if t is None:
        return None
    lo, hi = t.calls[0][0], t.calls[-1][1]
    spans = [(a, b) for a, b, n in t.host if n == name and lo <= a and b <= hi]
    if not spans:
        return None
    host_ns = sum((b - a) - t.busy_within(a, b) for a, b in spans)
    return host_ns / 1e6 / len(t.calls)
