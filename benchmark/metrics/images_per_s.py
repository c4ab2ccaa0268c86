"""Images completed over the window's whole time, by the host's clock."""


def read(run):
    return run.calls * run.batch / run.window_s
