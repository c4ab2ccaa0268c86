"""Models: the host's time a ``predict`` call in the port's ``predict.fcn8``
spans (per chunk, the normalization and FCN-8), less the device-busy time
inside them, in ms."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_call(run, "predict.fcn8")
