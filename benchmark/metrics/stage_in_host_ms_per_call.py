"""Serving entry: the host's time a ``predict`` call in the port's
``predict.stage_in`` spans (the request's conversion, then per chunk the
padding and the copy to the device), less the device-busy time inside
them, in ms."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_call(run, "predict.stage_in")
