"""Real (unpadded) frames transcribed over the window: from its start to
the end of the last batch that returned in it (host clock)."""


def read(run):
    w = run.window
    return w["frames"] / w["seconds"] if w["units"] else None
