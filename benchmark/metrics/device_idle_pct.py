"""Device: the share of the traced window in which no operation ran on the
card (1 - the union of device intervals / the window), in %."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_ns / t.window_ns)
