"""Seconds from the process's start to the window's: imports, the CUDA
context, the weights and frames made on the card, the ``Predictor``, the
tail kernel's build or load, and the warm-up calls."""


def read(run):
    return run.setup_s
