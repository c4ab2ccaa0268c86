"""Serving entry: device time of the host-to-device and device-to-host
copies a ``predict`` call, in ms."""


def read(run):
    t = run.trace
    if t is None:
        return None
    ns = sum(b - a for a, b, name in t.device if name.startswith(("Memcpy HtoD", "Memcpy DtoH")))
    return ns / 1e6 / len(t.calls) if ns else None
