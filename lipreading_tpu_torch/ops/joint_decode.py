"""Joint CTC/attention one-pass beam search (counterpart of
``lipreading_tpu/ops/joint_decode.py``; Watanabe et al., "Hybrid
CTC/Attention Architecture for End-to-End Speech Recognition").

Every beam expansion is scored with ``ctc_weight * ctc_prefix + (1 -
ctc_weight) * attention``: the frame-synchronous CTC lattice cannot loop, so
it vetoes the label-synchronous decoder's loops on out-of-distribution
lengths. Optional shallow fusion adds ``lm_weight`` times the char LM's row
(``lm.py``), and the lexicon DFA (``lexicon.py``) masks expansions off the
word list.

The beam folds its W beams into the batch ([B*W] states) like
``ops/decode.beam_search``, with extra per-beam CTC prefix state (the r_n /
r_b forward arrays over the T frames). Per step the prefix scores psi of
ALL vocabulary extensions come from one masked logsumexp over the emission
array; only the W selected tokens get their successor lattices rebuilt, by
two log-semiring scans over [T, B*W].

Math (log domain; g = current prefix, h = g + c, c != blank):
    phi_t(g, c)  = logaddexp(r_b_t(g), [c != last(g)] r_n_t(g))
    r_n_t(h)     = logaddexp(r_n_{t-1}(h), phi_{t-1}) + lp_t(c)
    r_b_t(h)     = logaddexp(r_b_{t-1}(h), r_n_{t-1}(h)) + lp_t(blank)
    psi(h)       = logsumexp_t [ phi_{t-1} + lp_t(c) ]      (prefix score)
    score(eos|g) = logaddexp(r_n_T(g), r_b_T(g))            (full-seq prob)
Both recurrences are first-order linear in the (logaddexp, +) semiring.
``_semiring_scan`` solves them with ``lax.associative_scan``'s odd/even
recursion, so the combines happen in the JAX package's order, at log T
depth; ``logaddexp`` and ``logsumexp`` are written as ``jax.numpy.logaddexp``
and ``jax.scipy.special.logsumexp`` write them. Rounding still differs from
XLA's in the last bits (its exp and log1p are its own), so scores agree
within a tolerance and the transcripts are the gate.
"""

from __future__ import annotations

import torch

from lipreading_tpu_torch.lm import advance_context, initial_context
from lipreading_tpu_torch.ops.decode import (
    NEG_INF,
    backtrack_best,
    beam_init,
    beam_rows,
    early_exit_scan,
    top_k,
    tree_map,
)


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)) as ``jax.numpy.logaddexp`` computes it: where
    a - b is NaN (a NaN, or infinities of one sign) the sum a + b, else
    max(a, b) + log1p(exp(-|a - b|))."""
    amax = torch.maximum(a, b)
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       amax + torch.log1p(torch.exp(-delta.abs())))


def logsumexp(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.scipy.special.logsumexp`` over ``dim``: the maximum is taken
    out (0 where it is not finite) and added back after the log."""
    amax = a.amax(dim=dim)
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    s = torch.exp(a - amax.unsqueeze(dim)).sum(dim=dim)
    return torch.log(s.abs()) + amax


def _associative_scan(combine,
                      elems: list[torch.Tensor]) -> list[torch.Tensor]:
    """Inclusive scan of ``elems`` (tensors with one leading axis) under the
    associative ``combine``, by ``lax.associative_scan``'s recursion: combine
    adjacent pairs, scan the half-length result (the odd outputs), combine
    those with the remaining even inputs, interleave."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:n - 1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = combine(odd, [e[2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[0] = e[0]
        r[2::2] = ev
        r[1::2] = od
        out.append(r)
    return out


def _semiring_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve r_t = a_t + r_{t-1}  (logaddexp)  b_t along axis 0.

    a, b: [T, ...]. Returns r: [T, ...] with r_{-1} = -inf."""

    def combine(x, y):
        a1, b1 = x
        a2, b2 = y
        return [a1 + a2, logaddexp(b1 + a2, b2)]

    return _associative_scan(combine, [a, b])[1]


def init_ctc_prefix_state(lp: torch.Tensor, blank: int) -> dict:
    """Per-sequence CTC prefix state of the empty prefix.

    lp: [N, T, V] masked log-posteriors (``mask_ctc_logp``) -> r_n / r_b
    [N, T], psi [N], last [N] int32, empty [N] bool."""
    N, T, V = lp.shape
    dev = lp.device
    return {
        "r_n": torch.full((N, T), NEG_INF, device=dev),
        "r_b": torch.cumsum(lp[:, :, blank], dim=1),        # all-blank paths
        "psi": torch.zeros((N,), device=dev),                # psi(empty) = 0
        "last": torch.full((N,), -1, dtype=torch.int32, device=dev),
        "empty": torch.ones((N,), dtype=torch.bool, device=dev),
    }


def mask_ctc_logp(logits: torch.Tensor, lengths: torch.Tensor,
                  blank: int) -> torch.Tensor:
    """log_softmax over V in float32; frames past each length emit blank
    freely (lp[blank] = 0, others -1e30), so a padded T equals the truncated
    math."""
    B, T, V = logits.shape
    lp = torch.log_softmax(logits.float(), dim=-1)
    valid = (torch.arange(T, device=lp.device)[None, :]
             < lengths[:, None])[..., None]
    pad_row = torch.full((V,), NEG_INF, device=lp.device)
    pad_row[blank] = 0.0
    return torch.where(valid, lp, pad_row)


def ctc_candidate_scores(state: dict, lp: torch.Tensor, blank: int):
    """Prefix scores of ALL vocabulary extensions of each prefix, without a
    scan.

    state: ``init_ctc_prefix_state``'s dict, [N, ...]; lp: [N, T, V].
    Returns (psi_ext [N, V], full_logp [N], emit [N, T, V]): the prefix
    score of each candidate, the full-sequence probability of the current
    prefix (the eos score), and the emission array, from which
    ``ctc_chosen_lattice`` rebuilds the lattice of the candidate the beam
    selects."""
    N, T, V = lp.shape
    r_n, r_b = state["r_n"], state["r_b"]
    last, empty = state["last"], state["empty"]
    same = torch.arange(V, device=lp.device)[None, :] == last[:, None]
    phi = logaddexp(r_b[:, :, None],
                    torch.where(same[:, None, :], NEG_INF, r_n[:, :, None]))
    # phi_{t-1}: shifted, with the virtual t = -1 slot (0 for the empty
    # prefix)
    init_slot = torch.where(empty, 0.0, NEG_INF)[:, None, None]
    phi_prev = torch.cat([init_slot.expand(N, 1, V), phi[:, :-1, :]], dim=1)
    emit = phi_prev + lp
    psi_ext = logsumexp(emit, dim=1)
    full_logp = logaddexp(r_n[:, -1], r_b[:, -1])
    return psi_ext, full_logp, emit


def ctc_chosen_lattice(emit_c: torch.Tensor, lp_c: torch.Tensor,
                       lp_blank: torch.Tensor):
    """Successor lattice of ONE chosen extension per beam.

    emit_c / lp_c / lp_blank: [N, T], the emit row and log-probs of the
    selected token c and of blank -> (r_n [N, T], r_b [N, T])."""
    N, T = emit_c.shape
    r_n = _semiring_scan(lp_c.T, emit_c.T).T
    r_n_prev = torch.cat([torch.full((N, 1), NEG_INF, device=emit_c.device),
                          r_n[:, :-1]], dim=1)
    r_b = _semiring_scan(lp_blank.T, (r_n_prev + lp_blank).T).T
    return r_n, r_b


def ctc_prefix_beam_device(logits: torch.Tensor, lengths: torch.Tensor,
                           beam: int, max_len: int, blank: int = 0,
                           sos: int = 1, eos: int = 2, lexicon=None,
                           lm=None, lm_weight: float = 0.0):
    """Exact CTC prefix beam search on the device: ``joint_beam_search`` at
    ``ctc_weight=1`` with a flat (zero-logit) attention model, so the
    hypotheses are ranked by the CTC prefix scores alone, among the finished
    ones. ``ops/ctc_beam.py`` (numpy) is its test oracle.

    logits: [B, T, V] raw CTC head outputs; lengths: [B]. Returns (ids
    [B, max_len], out_lengths [B])."""
    B, T, V = logits.shape
    BW = B * beam
    flat = torch.zeros((BW, V), device=logits.device)

    def flat_att(state, toks):
        return state, flat

    return joint_beam_search(
        flat_att, {"_": torch.zeros((BW,), device=logits.device)},
        torch.repeat_interleave(logits, beam, dim=0),
        torch.repeat_interleave(lengths, beam, dim=0),
        B, beam, max_len, sos, eos, blank=blank,
        ctc_weight=1.0, length_penalty=0.0,
        require_finished=True, lexicon=lexicon, lm=lm, lm_weight=lm_weight)


def joint_beam_search(att_step_fn, att_state, ctc_logits: torch.Tensor,
                      frame_lengths: torch.Tensor, batch: int, beam: int,
                      max_len: int, sos: int, eos: int, blank: int = 0,
                      ctc_weight: float = 0.3, length_penalty: float = 0.0,
                      lm=None, lm_weight: float = 0.0,
                      require_finished: bool = False, lexicon=None,
                      lexicon_weight: float = 0.0):
    """One-pass joint decode. ``att_state``'s tensors and ``ctc_logits`` /
    ``frame_lengths`` must already be tiled to B*W (as for
    ``ops/decode.beam_search``). Returns (ids [B, max_len], lengths [B]).

    ``lm``: optional (table [V^(n-1), V] tensor, order) for shallow fusion:
    adds ``lm_weight`` * log P_lm(c | context) to every expansion.

    ``lexicon``: optional DFA tables (``lexicon.to_torch``): every beam
    carries a trie state; expansions off the lexicon are masked to -1e30 and
    word boundaries add ``lexicon_weight`` * log P(word). The default weight
    0 makes it a pure constraint.

    ``require_finished``: pick the best beam among the finished ones (the
    pure-CTC mode, where an unfinished beam's psi is the mass of all its
    completions)."""
    BW = batch * beam
    dev = ctc_logits.device
    lp = mask_ctc_logp(ctc_logits, frame_lengths, blank)    # [BW, T, V]
    V = lp.shape[-1]
    ctc_state = init_ctc_prefix_state(lp, blank)
    if lm is not None:
        lm_table, lm_order = lm
        lm_ctx0 = initial_context(BW, lm_order, device=dev)
    else:
        lm_table = lm_order = None
        lm_ctx0 = torch.zeros((BW,), dtype=torch.int32, device=dev)
    lex_next = lexicon["next_state"] if lexicon is not None else None
    lex_bonus = lexicon["bonus"] if lexicon is not None else None
    # attention never legally emits blank or sos; CTC never emits them either
    bad = torch.zeros((V,), dtype=torch.bool, device=dev)
    bad[blank] = bad[sos] = True
    eos_only = torch.full((V,), NEG_INF, device=dev)
    eos_only[eos] = 0.0
    lp_blank = lp[:, :, blank]
    beam_self = torch.arange(BW, device=dev)

    def body(carry):
        att, ctc, lm_ctx, lex_state, scores, toks, finished, lengths = carry
        att, att_logits = att_step_fn(att, toks.reshape(BW))
        att_lp = torch.log_softmax(att_logits.float(), dim=-1)

        psi_ext, full_lp, emit = ctc_candidate_scores(ctc, lp, blank)
        delta = psi_ext - ctc["psi"][:, None]                # [BW, V]
        delta[:, eos] = full_lp - ctc["psi"]
        joint = (1.0 - ctc_weight) * att_lp + ctc_weight * delta
        if lm_table is not None:
            joint = joint + lm_weight * lm_table[lm_ctx]     # [BW, V] fusion
        if lex_next is not None:
            # hard lexicon constraint and word-LM boundary bonus: one gather
            add = lex_bonus[lex_state]                       # [BW, V]
            joint = joint + torch.where(add > NEG_INF / 2,
                                        lexicon_weight * add, NEG_INF)
        joint = torch.where(bad, NEG_INF, joint).reshape(batch, beam, V)
        joint = torch.where(finished[:, :, None], eos_only, joint)
        total = scores[:, :, None] + joint
        new_scores, idx = top_k(total.reshape(batch, beam * V), beam)
        src_beam = idx // V
        new_tok = (idx % V).to(torch.int32)

        rows = beam_rows(src_beam)

        def gather(x):
            return x[rows]

        att = tree_map(gather, att)
        # successor CTC lattices ONLY for the chosen (beam, token) pairs:
        # scans over [T, BW] instead of [T, BW, V]
        flat_tok = new_tok.reshape(BW).long()
        emit_c = emit[rows, :, flat_tok]                     # [BW, T]
        # lp is the same across the beams of one sample (tiled by repeat),
        # so it needs no beam gather
        lp_c = lp[beam_self, :, flat_tok]
        r_n_sel, r_b_sel = ctc_chosen_lattice(emit_c, lp_c, lp_blank)
        chose_eos = (flat_tok == eos) | gather(finished.reshape(BW))
        psi_sel = psi_ext[rows, flat_tok]
        new_ctc = {
            "r_n": torch.where(chose_eos[:, None], gather(ctc["r_n"]),
                               r_n_sel),
            "r_b": torch.where(chose_eos[:, None], gather(ctc["r_b"]),
                               r_b_sel),
            "psi": torch.where(chose_eos, gather(ctc["psi"]), psi_sel),
            "last": torch.where(chose_eos, gather(ctc["last"]),
                                flat_tok.to(torch.int32)),
            # every live beam has emitted
            "empty": torch.zeros((BW,), dtype=torch.bool, device=dev),
        }
        if lm_table is not None:
            lm_ctx = advance_context(gather(lm_ctx), flat_tok, lm_order, V)
        if lex_next is not None:
            g = gather(lex_state)
            stepped = torch.gather(lex_next[g], 1, flat_tok[:, None])[:, 0]
            # finished beams re-emit eos; their state stays frozen
            lex_state = torch.where(chose_eos, g, torch.clamp(stepped, min=0))
        finished = torch.gather(finished, 1, src_beam)
        lengths = torch.gather(lengths, 1, src_beam)
        lengths = lengths + (~finished).to(torch.int32)
        finished = finished | (new_tok == eos)
        return (att, new_ctc, lm_ctx, lex_state, new_scores, new_tok,
                finished, lengths), (new_tok, src_beam)

    (scores0, toks0, fin0, len0), bufs = beam_init(batch, beam, max_len, sos,
                                                   eos, dev)
    lex0 = torch.zeros((BW,), dtype=torch.int32, device=dev)   # DFA root
    carry, (toks, srcs) = early_exit_scan(
        body, (att_state, ctc_state, lm_ctx0, lex0, scores0, toks0, fin0,
               len0), lambda c: c[6], bufs, max_len)
    scores, finished, lengths = carry[4], carry[6], carry[7]
    return backtrack_best(toks, srcs, scores, lengths, eos, length_penalty,
                          finished if require_finished else None)
