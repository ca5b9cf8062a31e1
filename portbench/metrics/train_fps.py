"""Real (unpadded) frames trained over the window: from its start to the
completion of the last step done in it (host clock)."""


def read(run):
    w = run.window
    return w["frames"] / w["seconds"] if w["units"] else None
