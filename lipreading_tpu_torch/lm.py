"""Character n-gram language model for shallow fusion in the beam.

A copy of ``lipreading_tpu/lm.py``: ``train_char_lm``, ``save_lm``,
``load_lm``, ``lm_perplexity`` and ``lm_nll_per_char`` are the same numpy
code; ``initial_context`` and ``advance_context`` build and step the beam's
rolling context index as torch tensors on an explicit device.

An order-N char model is densified into a single [V^(N-1), V] log-probability
table (add-k smoothed backoff folded in at build time), so in-beam fusion is
one table row lookup per step: the beam state carries a rolling context
index, no trie walks, no host round trips. At V=31, order=4 the table is
31^3 x 31 float32 (3.7 MB) and the context index fits in int32.

    score += lm_weight * lm_table[ctx, c]
    ctx' = (ctx * V + c) mod V^(N-1)

Vocabulary: the shared Vocab (text.py); <s> frames the context at start,
</s> is a predicted event (so the LM also scores sequence end).
"""

from __future__ import annotations

import numpy as np
import torch

from lipreading_tpu_torch.text import Vocab


def train_char_lm(
    texts: list[str],
    order: int = 4,
    add_k: float = 0.1,
    backoff: float = 0.4,
    vocab: Vocab | None = None,
) -> np.ndarray:
    """Texts -> dense [V^(order-1), V] log-prob table.

    Interpolated add-k smoothing: P(c|ctx) mixes the order-N estimate with
    the (order-1) estimate recursively (weight ``backoff``), all folded into
    the dense table at build time.
    """
    vocab = vocab or Vocab()
    V = vocab.size
    n_ctx = order - 1

    # collect counts for all orders 1..order
    counts: list[dict] = [dict() for _ in range(order + 1)]
    for text in texts:
        ids = [vocab.sos_id] * n_ctx + list(vocab.encode(text)) + [vocab.eos_id]
        for i in range(n_ctx, len(ids)):
            for k in range(1, order + 1):
                key = tuple(ids[i - k + 1:i + 1])
                counts[k][key] = counts[k].get(key, 0) + 1

    # unigram distribution (smoothed)
    uni = np.full((V,), add_k)
    for (c,), n in counts[1].items():
        uni[c] += n
    uni = uni / uni.sum()

    def prob(ctx: tuple, c: int) -> float:
        """Interpolated P(c | ctx) via recursive backoff."""
        if not ctx:
            return uni[c]
        num = counts[len(ctx) + 1].get(ctx + (c,), 0) + add_k
        den = counts[len(ctx)].get(ctx, 0) + add_k * V
        return (1 - backoff) * (num / den) + backoff * prob(ctx[1:], c)

    # densify every context that ever occurred; unseen contexts get the
    # backed-off distribution of their longest seen suffix
    table = np.tile(np.log(uni)[None, :], (V ** n_ctx, 1)).astype(np.float32)

    def ctx_index(ctx: tuple) -> int:
        idx = 0
        for t in ctx:
            idx = idx * V + int(t)
        return idx

    seen_ctx = set(counts[n_ctx].keys()) if n_ctx > 0 else set()
    # also contexts seen only as shorter suffixes: fill via full enumeration
    # of observed (order-1)-grams plus their smoothed rows
    for ctx in seen_ctx:
        row = np.asarray([prob(ctx, c) for c in range(V)])
        table[ctx_index(ctx)] = np.log(np.maximum(row / row.sum(), 1e-12))
    return table


def save_lm(table: np.ndarray, path: str, order: int = 4) -> None:
    np.savez_compressed(path, table=table, order=np.asarray(order))


def load_lm(path: str) -> tuple[np.ndarray, int]:
    z = np.load(path)
    return z["table"], int(z["order"])


def initial_context(batch: int, order: int, vocab: Vocab | None = None,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """[B] int32 rolling context indices for <s>-framed sequence starts."""
    vocab = vocab or Vocab()
    V = vocab.size
    idx = 0
    for _ in range(order - 1):
        idx = idx * V + vocab.sos_id
    return torch.full((batch,), idx, dtype=torch.int32, device=device)


def advance_context(ctx: torch.Tensor, token: torch.Tensor, order: int,
                    vocab_size: int) -> torch.Tensor:
    """(ctx * V + token) mod V^(order-1), vectorized; int32 like ``ctx``."""
    mod = vocab_size ** (order - 1)
    return (ctx * vocab_size + token.to(torch.int32)) % mod


def lm_perplexity(table: np.ndarray, order: int, texts: list[str],
                  vocab: Vocab | None = None) -> float:
    """Per-char perplexity of the dense LM on held-out texts."""
    vocab = vocab or Vocab()
    V = vocab.size
    total, n = 0.0, 0
    for text in texts:
        ids = [vocab.sos_id] * (order - 1) + list(vocab.encode(text)) \
            + [vocab.eos_id]
        ctx = 0
        for t in ids[: order - 1]:
            ctx = ctx * V + t
        mod = V ** (order - 1)
        for c in ids[order - 1:]:
            total += float(table[ctx, c])
            n += 1
            ctx = (ctx * V + c) % mod
    return float(np.exp(-total / max(n, 1)))


def lm_nll_per_char(table: np.ndarray, order: int, text: str,
                    vocab: Vocab | None = None) -> float:
    """Per-char negative log-likelihood of ONE string under the dense LM.

    Host-side scorer for the cascade decoder's LM trigger
    (infer.transcribe_cascade): a greedy transcript with high NLL (non-word
    character sequences) is exactly the case where beam + LM fusion changes
    the decode, which frame-level CTC margins cannot predict."""
    vocab = vocab or Vocab()
    V = vocab.size
    ids = [vocab.sos_id] * (order - 1) + list(vocab.encode(text)) \
        + [vocab.eos_id]
    ctx = 0
    for t in ids[: order - 1]:
        ctx = ctx * V + t
    mod = V ** (order - 1)
    total, n = 0.0, 0
    for c in ids[order - 1:]:
        total += float(table[ctx, c])
        n += 1
        ctx = (ctx * V + c) % mod
    return -total / max(n, 1)
