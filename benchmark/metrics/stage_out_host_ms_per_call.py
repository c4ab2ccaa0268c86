"""Serving entry: the host's time a ``predict`` call in the port's
``predict.stage_out`` spans (per chunk, the wait for the device and the copy
of the labels to the host), less the device-busy time inside them, in ms."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_call(run, "predict.stage_out")
