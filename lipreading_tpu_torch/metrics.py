"""Character error rate (Levenshtein edit distance), as in
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


def corpus_cer(hyps: list[str], refs: list[str]) -> float:
    """Corpus-level CER: total edits / total ref chars."""
    edits = sum(edit_distance(list(h), list(r)) for h, r in zip(hyps, refs))
    chars = sum(len(r) for r in refs)
    return edits / max(chars, 1)
