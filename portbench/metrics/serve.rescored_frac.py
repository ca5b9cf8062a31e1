"""Clips the cascade's triggers sent to the joint beam, over all clips of
the traced window's batches (the clips decoded by shot are not counted)."""


def read(run):
    w = run.window
    return w["rescored"] / w["clips"] if w["clips"] else None
