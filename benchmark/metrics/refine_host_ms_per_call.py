"""Engine: the host's time a ``predict`` call in the port's
``predict.refine`` spans (per chunk, the refinement engine and its label
step), less the device-busy time inside them, in ms."""

from benchmark import spans


def read(run):
    return spans.host_ms_per_call(run, "predict.refine")
