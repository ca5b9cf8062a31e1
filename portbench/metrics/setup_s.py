"""Process start to the window's start: imports, loading the release,
the inputs, the warm-up and the first batch or steps (host clock)."""


def read(run):
    return run.setup_s
