"""Frozen copy of the program's character vocabulary (``text.Vocab``) and
of the label arithmetic of ``data/dataset.BucketedDataset.make_batch``:
ids, the sos/eos-framed attention targets and the CTC labels cut to what
a clip's frames can align."""

from __future__ import annotations

import numpy as np

TOKENS = ("<b>", "<s>", "</s>") + tuple(" '" + "abcdefghijklmnopqrstuvwxyz")
BLANK, SOS, EOS, PAD = 0, 1, 2, 0
V = len(TOKENS)
_INDEX = {t: i for i, t in enumerate(TOKENS)}


def encode(text: str) -> np.ndarray:
    return np.asarray([_INDEX[c] for c in text], np.int32)


def decode(ids) -> str:
    """Ids -> string: specials dropped, stopping at eos."""
    out = []
    for i in np.asarray(ids).tolist():
        if i == EOS:
            break
        if i > EOS:
            out.append(TOKENS[i])
    return "".join(out)


def labels(text: str, frames: int, max_chars: int):
    """(target [max_chars] sos + ids + eos padded, target length, CTC ids)
    of a clip of ``frames`` frames, as ``make_batch`` builds them: at most
    ``max_chars - 2`` ids and at most ``max((frames - 1) // 2, 1)``."""
    ids = encode(text)[:max_chars - 2]
    ids = ids[:max((frames - 1) // 2, 1)]
    framed = np.concatenate([[SOS], ids, [EOS]]).astype(np.int32)
    target = np.full((max_chars,), PAD, np.int32)
    target[:len(framed)] = framed
    return target, len(framed), ids
