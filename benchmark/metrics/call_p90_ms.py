"""The 90th percentile of the wall time of every ``predict`` call in the
window (``statistics.quantiles``, inclusive), by the host's clock."""

import statistics


def read(run):
    if len(run.latencies_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.latencies_s, n=10, method="inclusive")[8]
