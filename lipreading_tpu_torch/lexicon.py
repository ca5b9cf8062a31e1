"""Lexicon-constrained decoding: a word trie densified into DFA tables.

A copy of ``lipreading_tpu/lexicon.py`` (``build_lexicon``,
``fixture_lexicon`` over the port's ``fixtures.LEXICON``), with ``to_torch``
in place of ``to_jax``.

Ref design space: "Deep Lip Reading" decodes its beam against an external
language model / word lexicon (PAPERS.md 1806.06053). TPU shape: the
lexicon's char trie becomes two dense arrays —

    next_state [S, V] int32   trie transition (-1 = illegal)
    bonus      [S, V] float32 additive log-score (0 legal letter;
                              word log-prob on boundary; -inf illegal)

so in-beam constraint + word-LM rescoring is ONE gather row per step, the
same pattern as the char-LM fusion (lm.py): the beam carries a rolling DFA
state, no trie walks, no host round trips.

Semantics per state s and emitted char c:
* letter: follow the trie edge (illegal kills the hypothesis);
* space: legal only when s completes a word; adds log P(word); returns to
  the root (next word starts);
* eos: legal when s completes a word (adds log P(word)) or at the root
  (empty/final-word-less transcript, bonus 0);
* blank/sos never reach the lexicon (the beam masks them already).
"""

from __future__ import annotations

import numpy as np
import torch

from lipreading_tpu_torch.fixtures import LEXICON
from lipreading_tpu_torch.text import Vocab

NEG_INF = -1e30


def build_lexicon(words: list[str], counts: dict[str, int] | None = None,
                  vocab: Vocab | None = None) -> dict[str, np.ndarray]:
    """Word list (+ optional counts for the word LM) -> dense DFA tables.

    Returns {"next_state": [S, V] int32, "bonus": [S, V] float32} with
    state 0 = root.
    """
    vocab = vocab or Vocab()
    V = vocab.size
    space = vocab.tokens.index(" ")   # encode() strips a lone space
    eos = vocab.eos_id

    # trie build (host, tiny)
    children: list[dict[int, int]] = [{}]
    word_logp: list[float] = [NEG_INF]
    total = sum((counts or {}).get(w, 1) for w in words)
    for w in words:
        ids = vocab.encode(w)
        s = 0
        for c in ids:
            c = int(c)
            if c not in children[s]:
                children.append({})
                word_logp.append(NEG_INF)
                children[s][c] = len(children) - 1
            s = children[s][c]
        p = (counts or {}).get(w, 1) / total
        word_logp[s] = float(np.log(p))

    S = len(children)
    nxt = np.full((S, V), -1, np.int32)
    bonus = np.full((S, V), NEG_INF, np.float32)
    for s, ch in enumerate(children):
        for c, t in ch.items():
            nxt[s, c] = t
            bonus[s, c] = 0.0
        if word_logp[s] > NEG_INF / 2:
            nxt[s, space] = 0                      # word boundary -> root
            bonus[s, space] = word_logp[s]
            nxt[s, eos] = s                        # finish after a word
            bonus[s, eos] = word_logp[s]
    nxt[0, eos] = 0                                # empty transcript is legal
    bonus[0, eos] = 0.0
    return {"next_state": nxt, "bonus": bonus}


def fixture_lexicon(vocab: Vocab | None = None) -> dict[str, np.ndarray]:
    """The fixture corpus lexicon (fixtures.LEXICON) as DFA tables."""
    return build_lexicon(list(LEXICON), vocab=vocab)


def to_torch(lex: dict[str, np.ndarray],
             device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """The DFA tables as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in lex.items()}
