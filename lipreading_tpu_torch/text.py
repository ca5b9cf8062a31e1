"""Character vocabulary and text normalization.

A copy of ``lipreading_tpu/text.py`` (``Vocab``, ``normalize_text``): the
transcripts of both packages come from the same ids. One vocabulary serves
both decoding paths:

* CTC path: id 0 is the CTC blank; <sos>/<eos> are never emitted.
* Attention/seq2seq path: <sos>/<eos> frame the target, id 0 doubles as pad.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

BLANK = "<b>"   # CTC blank / sequence pad (id 0)
SOS = "<s>"     # start-of-sequence (attention decoder input framing)
EOS = "</s>"    # end-of-sequence

_SPECIALS = (BLANK, SOS, EOS)
_CHARS = tuple(" '" + "abcdefghijklmnopqrstuvwxyz")

_KEEP_RE = re.compile(r"[^a-z' ]+")
_WS_RE = re.compile(r"\s+")


def normalize_text(s: str) -> str:
    """Lowercase, strip everything but [a-z' ], collapse whitespace."""
    s = s.lower()
    s = _KEEP_RE.sub(" ", s)
    s = _WS_RE.sub(" ", s).strip()
    return s


@dataclass(frozen=True)
class Vocab:
    """Character vocabulary shared by the CTC and attention decoders."""

    tokens: tuple[str, ...] = field(default=_SPECIALS + _CHARS)

    @property
    def size(self) -> int:
        return len(self.tokens)

    @property
    def blank_id(self) -> int:
        return 0

    @property
    def sos_id(self) -> int:
        return 1

    @property
    def eos_id(self) -> int:
        return 2

    @property
    def pad_id(self) -> int:
        return 0

    def _index(self) -> dict[str, int]:
        return {t: i for i, t in enumerate(self.tokens)}

    def encode(self, text: str) -> np.ndarray:
        """Normalized text -> int32 ids (no sos/eos framing)."""
        idx = self._index()
        text = normalize_text(text)
        return np.asarray([idx[c] for c in text], dtype=np.int32)

    def encode_target(self, text: str, max_len: int) -> tuple[np.ndarray, int]:
        """Text -> [sos, chars..., eos] padded with pad_id to ``max_len``.

        Returns (ids[max_len], true_length_including_sos_eos).
        """
        ids = self.encode(text)
        framed = np.concatenate(
            [[self.sos_id], ids, [self.eos_id]]
        ).astype(np.int32)
        n = len(framed)
        if n > max_len:
            raise ValueError(f"target length {n} exceeds max_len {max_len}")
        out = np.full((max_len,), self.pad_id, dtype=np.int32)
        out[:n] = framed
        return out, n

    def decode(self, ids, strip_special: bool = True) -> str:
        """Int ids -> string, dropping specials (blank/sos/eos/pad)."""
        out = []
        for i in np.asarray(ids).tolist():
            t = self.tokens[int(i)]
            if strip_special and t in _SPECIALS:
                if t == EOS:
                    break
                continue
            out.append(t)
        return "".join(out)

    def decode_ctc_greedy(self, ids) -> str:
        """Collapse repeats then remove blanks (standard CTC best path)."""
        ids = np.asarray(ids).tolist()
        out = []
        prev = None
        for i in ids:
            if i != prev and i != self.blank_id:
                out.append(self.tokens[int(i)])
            prev = i
        return "".join(t for t in out if t not in _SPECIALS)


DEFAULT_VOCAB = Vocab()
