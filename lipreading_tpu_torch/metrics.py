"""Character and word error rates (Levenshtein edit distance), as in
``lipreading_tpu/metrics.py``."""

from __future__ import annotations


def edit_distance(a, b) -> int:
    """Levenshtein distance between two sequences (classic two-row DP)."""
    a = list(a)
    b = list(b)
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, start=1):
            cur[j] = min(
                prev[j] + 1,                      # deletion
                cur[j - 1] + 1,                   # insertion
                prev[j - 1] + (ca != cb),         # substitution/match
            )
        prev = cur
    return int(prev[-1])


def cer(hyp: str, ref: str) -> float:
    """Character error rate: edits / len(ref); an empty ref gives 0 for an
    empty hyp, else 1."""
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(list(hyp), list(ref)) / len(ref)


def wer(hyp: str, ref: str) -> float:
    """Word error rate over whitespace-split words; an empty ref gives 0 for
    an empty hyp, else 1."""
    rw = ref.split()
    hw = hyp.split()
    if not rw:
        return 0.0 if not hw else 1.0
    return edit_distance(hw, rw) / len(rw)


def corpus_cer(hyps: list[str], refs: list[str]) -> float:
    """Corpus-level CER: total edits / total ref chars."""
    edits = sum(edit_distance(list(h), list(r)) for h, r in zip(hyps, refs))
    chars = sum(len(r) for r in refs)
    return edits / max(chars, 1)


def corpus_wer(hyps: list[str], refs: list[str]) -> float:
    """Corpus-level WER: total word edits / total ref words."""
    edits = sum(edit_distance(h.split(), r.split())
                for h, r in zip(hyps, refs))
    words = sum(len(r.split()) for r in refs)
    return edits / max(words, 1)
