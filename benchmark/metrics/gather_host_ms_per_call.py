"""Serving entry: the host's time a ``predict`` call in the port's
``predict.gather`` span (the concatenation of the chunks' labels), less the
device-busy time inside it, in ms."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_call(run, "predict.gather")
