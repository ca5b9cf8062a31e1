"""Clips decoded by shot (an invalid frame inside their length), over all
clips of the traced window's batches."""


def read(run):
    w = run.window
    return w["segmented"] / w["clips"] if w["clips"] else None
