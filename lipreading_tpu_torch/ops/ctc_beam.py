"""CTC prefix beam search on the host, in numpy: a copy of
``lipreading_tpu/ops/ctc_beam.py``. It is the test oracle of
``ops/joint_decode.ctc_prefix_beam_device``; nothing on the serving path
calls it. (Ref: the "Deep Lip Reading" CTC + beam-search decode path,
PAPERS.md 1806.06053; the reference runs its beam loop in Python, SURVEY.md
§4.3.)

Standard prefix beam search with blank/non-blank probability split and
prefix merging (Hannun et al.). The per-utterance loop runs on the host over
log-posteriors computed on the device (the encoder and softmax are the
expensive part; the beam bookkeeping is O(T * W * V) numpy).
Vectorized over candidate expansions within each step.
"""

from __future__ import annotations

import numpy as np

NEG_INF = -np.inf


def _logaddexp(a, b):
    return np.logaddexp(a, b)


def ctc_prefix_beam_search(
    log_probs: np.ndarray,
    beam_width: int = 8,
    blank: int = 0,
    prune_topk: int = 16,
) -> tuple[list[int], float]:
    """[T, V] log-posteriors -> (best label sequence, log-prob).

    ``prune_topk`` limits per-step candidate symbols (standard vocabulary
    pruning; vocab here is ~31 so this is nearly exact).
    """
    T, V = log_probs.shape
    # beams: dict prefix(tuple) -> (logp_blank, logp_nonblank)
    beams: dict[tuple, tuple[float, float]] = {(): (0.0, NEG_INF)}

    for t in range(T):
        lp = log_probs[t]
        cand = np.argsort(lp)[-prune_topk:]
        new: dict[tuple, list[float]] = {}

        def acc(prefix, pb, pnb):
            old = new.get(prefix)
            if old is None:
                new[prefix] = [pb, pnb]
            else:
                old[0] = _logaddexp(old[0], pb)
                old[1] = _logaddexp(old[1], pnb)

        for prefix, (pb, pnb) in beams.items():
            total = _logaddexp(pb, pnb)
            # blank: prefix unchanged
            acc(prefix, total + lp[blank], NEG_INF)
            last = prefix[-1] if prefix else None
            for c in cand:
                c = int(c)
                if c == blank:
                    continue
                p_c = lp[c]
                if c == last:
                    # repeat symbol: extends only from blank-terminated paths;
                    # non-blank-terminated collapses into the same prefix
                    acc(prefix, NEG_INF, pnb + p_c)
                    acc(prefix + (c,), NEG_INF, pb + p_c)
                else:
                    acc(prefix + (c,), NEG_INF, total + p_c)

        # prune to beam width
        scored = sorted(
            new.items(),
            key=lambda kv: -_logaddexp(kv[1][0], kv[1][1]),
        )[:beam_width]
        beams = {k: (v[0], v[1]) for k, v in scored}

    best_prefix, (pb, pnb) = max(
        beams.items(), key=lambda kv: _logaddexp(kv[1][0], kv[1][1])
    )
    return list(best_prefix), float(_logaddexp(pb, pnb))


def ctc_beam_decode_batch(
    log_probs: np.ndarray,
    lengths: np.ndarray,
    beam_width: int = 8,
    blank: int = 0,
) -> list[list[int]]:
    """[B, T, V] + [B] -> list of label sequences."""
    out = []
    for b in range(log_probs.shape[0]):
        ids, _ = ctc_prefix_beam_search(
            log_probs[b, : int(lengths[b])], beam_width, blank
        )
        out.append(ids)
    return out


def ctc_brute_force_best(
    log_probs: np.ndarray, blank: int = 0
) -> tuple[list[int], float]:
    """Exact max-probability labeling by path enumeration (tests only; tiny
    T/V). Sums path probabilities per collapsed labeling."""
    import itertools

    T, V = log_probs.shape
    totals: dict[tuple, float] = {}
    for path in itertools.product(range(V), repeat=T):
        lp = sum(log_probs[t, path[t]] for t in range(T))
        # collapse
        lab = []
        prev = None
        for s in path:
            if s != prev and s != blank:
                lab.append(s)
            prev = s
        key = tuple(lab)
        totals[key] = np.logaddexp(totals.get(key, NEG_INF), lp)
    best = max(totals.items(), key=lambda kv: kv[1])
    return list(best[0]), float(best[1])
