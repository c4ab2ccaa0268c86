"""The most device memory the program held during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
