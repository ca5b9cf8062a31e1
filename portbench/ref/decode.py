"""Plain reference of the serving path's decoding.

* ``greedy``: per-frame argmax of the CTC log-probabilities (the lower id
  on a tie), repeats collapsed, blanks dropped; its confidence is the mean
  top-1 minus top-2 gap over the valid frames.
* ``triggers``: the cascade's three triggers (confidence below the margin;
  the char LM's per-char NLL of a greedy transcript of at least 4 chars
  above 1.35; a word outside the lexicon).
* ``joint_beam``: the one-pass joint CTC/attention beam (Watanabe et al.
  2017) with shallow fusion of the char LM: every expansion scores
  (1 - w) * attention + w * (CTC prefix score change) + lm_weight * LM; eos
  scores the whole-sequence CTC probability; finished beams re-emit eos at
  no cost; the best beam by score / ((length + 5) / 6) ** length_penalty.
  Plainly written: the decoder is run teacher-forced over each whole
  prefix, and the CTC prefix lattices step frame by frame.
* ``joint_score``: that same score of a given transcript in closed form
  (the attention and LM log-probabilities of its tokens and eos, the CTC
  log-likelihood by ``F.ctc_loss``), length-normalised.
* ``viterbi``: the best CTC alignment's log-probability of a given
  transcript; greedy's path is the best of all, so its difference to the
  per-frame maxima's sum is how far a transcript lies below greedy's.
* ``segments``: the shots of a tracked clip (runs of at least 25 invalid
  frames split it; invalid frames inside a shot are dropped)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.frozen import text as tx
from portbench.frozen.fixtures import LEXICON
from portbench.ref import model as M

NEG = -1e30
LEX = frozenset(LEXICON)


def masked(lp, lens):
    """Frames past a length emit blank at probability 1."""
    T, V = lp.shape[1:]
    pad = torch.full((V,), NEG, device=lp.device)
    pad[tx.BLANK] = 0.0
    ok = (torch.arange(T, device=lp.device)[None] < lens[:, None])[..., None]
    return torch.where(ok, lp, pad)


def greedy(lp, lens):
    """-> (transcripts, confidences numpy)."""
    ids = lp.argmax(-1).cpu().numpy()
    top2 = torch.topk(lp, 2, dim=-1).values
    ok = (torch.arange(lp.shape[1], device=lp.device)[None]
          < lens[:, None]).float()
    conf = (((top2[..., 0] - top2[..., 1]) * ok).sum(-1)
            / ok.sum(-1).clamp(min=1.0)).cpu().numpy()
    texts = []
    for b, n in enumerate(lens.cpu().numpy()):
        prev, seq = None, []
        for i in ids[b, :n]:
            if i != prev and i != tx.BLANK:
                seq.append(int(i))
            prev = i
        texts.append(tx.decode(seq))
    return texts, conf


def load_lm(path, device):
    """The char LM (``char_lm.npz``) -> (table tensor on ``device``,
    order, the numpy table)."""
    with np.load(path) as z:
        table, order = np.asarray(z["table"], np.float32), int(z["order"])
    return torch.from_numpy(table).to(device), order, table


def lm_nll(table, order, text):
    """Per-char NLL of ``text`` and eos under the char LM (numpy table)."""
    V = tx.V
    ids = [tx.SOS] * (order - 1) + list(tx.encode(text)) + [tx.EOS]
    ctx = 0
    for t in ids[:order - 1]:
        ctx = ctx * V + t
    mod = V ** (order - 1)
    total = 0.0
    for c in ids[order - 1:]:
        total += float(table[ctx, c])
        ctx = (ctx * V + c) % mod
    return -total / (len(ids) - order + 1)


def triggers(text, conf, lm, serve):
    """(flagged, how far the least-missed trigger was from firing)."""
    table, order = lm[2], lm[1]
    dist = [conf - serve["margin"]]
    if len(text) >= serve["lm_min_chars"]:
        dist.append(serve["lm_margin"] - lm_nll(table, order, text))
    oov = any(w not in LEX for w in text.split())
    flagged = oov or min(dist) < 0
    return flagged, (0.0 if flagged else min(dist))


def lm_context0(order):
    idx = 0
    for _ in range(order - 1):
        idx = idx * tx.V + tx.SOS
    return idx


def joint_beam(P, cfg, enc, lens, lp, lm, serve, prec):
    """Rows of encoder states [N, T, D] and their log-probabilities
    [N, T, V] (not masked) -> token lists (eos not included)."""
    N, T, V = lp.shape
    W = serve["beam"]
    w, lw = cfg["train"]["ctc_weight"], serve["lm_weight"]
    max_len = cfg["train"]["max_decode_len"]
    pen = cfg["train"]["length_penalty"]
    dev = lp.device
    lp = masked(lp, lens)
    table, order = lm[0], lm[1]
    mod = V ** (order - 1)
    ar = torch.arange(N, device=dev)[:, None]
    scores = torch.full((N, W), NEG, device=dev)
    scores[:, 0] = 0.0
    toks = torch.full((N, W, 1), tx.SOS, dtype=torch.long, device=dev)
    fin = torch.zeros((N, W), dtype=torch.bool, device=dev)
    length = torch.zeros((N, W), dtype=torch.long, device=dev)
    r_n = torch.full((N, W, T), NEG, device=dev)
    r_b = torch.cumsum(lp[:, :, tx.BLANK], 1)[:, None].expand(N, W, T).clone()
    psi = torch.zeros((N, W), device=dev)
    last = torch.full((N, W), -1, dtype=torch.long, device=dev)
    empty = torch.ones((N, W), dtype=torch.bool, device=dev)
    ctx = torch.full((N, W), lm_context0(order), dtype=torch.long,
                     device=dev)
    eos_only = torch.full((V,), NEG, device=dev)
    eos_only[tx.EOS] = 0.0
    encW = enc.repeat_interleave(W, 0)
    lensW = lens.repeat_interleave(W, 0)
    lpb = lp[:, :, tx.BLANK]
    for _ in range(max_len):
        if bool(fin.all()):
            break
        att = M.decoder_log_probs(P, cfg, toks.reshape(N * W, -1), encW,
                                  lensW, prec)[:, -1].reshape(N, W, V)
        same = torch.arange(V, device=dev) == last[..., None]
        phi = torch.logaddexp(r_b[..., None],
                              torch.where(same[:, :, None, :], NEG,
                                          r_n[..., None]))
        init = torch.where(empty, 0.0, NEG)[..., None, None].expand(N, W, 1, V)
        emit = torch.cat([init, phi[:, :, :-1]], 2) + lp[:, None]
        psi_ext = torch.logsumexp(emit, 2)
        delta = psi_ext - psi[..., None]
        delta[..., tx.EOS] = torch.logaddexp(r_n[..., -1], r_b[..., -1]) - psi
        joint = (1 - w) * att + w * delta + lw * table[ctx]
        joint[..., tx.BLANK] = NEG
        joint[..., tx.SOS] = NEG
        joint = torch.where(fin[..., None], eos_only, joint)
        total = (scores[..., None] + joint).reshape(N, W * V)
        order_ = torch.sort(total, dim=1, descending=True, stable=True)
        scores, idx = order_.values[:, :W], order_.indices[:, :W]
        src, tok = idx // V, idx % V
        g_fin = fin[ar, src]
        chose_eos = (tok == tx.EOS) | g_fin
        emit_c = emit[ar, src, :, tok]                       # [N, W, T]
        lp_c = lp[ar[:, :, None], torch.arange(T, device=dev)[None, None],
                  tok[..., None]]
        rn = torch.full((N, W, T), NEG, device=dev)
        rb = torch.full((N, W, T), NEG, device=dev)
        prev_n = torch.full((N, W), NEG, device=dev)
        prev_b = torch.full((N, W), NEG, device=dev)
        for t in range(T):
            rn[..., t] = torch.logaddexp(prev_n + lp_c[..., t],
                                         emit_c[..., t])
            rb[..., t] = torch.logaddexp(prev_b, prev_n) + lpb[:, None, t]
            prev_n, prev_b = rn[..., t], rb[..., t]
        keep = chose_eos[..., None]
        r_n = torch.where(keep, r_n[ar, src], rn)
        r_b = torch.where(keep, r_b[ar, src], rb)
        psi = torch.where(chose_eos, psi[ar, src], psi_ext[ar, src, tok])
        last = torch.where(chose_eos, last[ar, src], tok)
        empty = torch.zeros_like(empty)
        ctx = (ctx[ar, src] * V + tok) % mod
        length = length[ar, src] + (~g_fin).long()
        fin = g_fin | (tok == tx.EOS)
        toks = torch.cat([toks[ar, src], tok[..., None]], 2)
    sel = scores / (((length.float() + 5.0) / 6.0) ** pen).clamp(min=1e-6)
    best = sel.argmax(1)
    out = []
    for n in range(N):
        seq = toks[n, best[n], 1:].tolist()
        out.append(seq[:seq.index(tx.EOS)] if tx.EOS in seq else seq)
    return out


def joint_score(P, cfg, enc, lens, lp, seqs, lm, serve, prec):
    """Length-normalised joint score of each row's token list (eos
    appended) -> numpy [N]."""
    N = len(seqs)
    w, lw = cfg["train"]["ctc_weight"], serve["lm_weight"]
    pen = cfg["train"]["length_penalty"]
    L = max(len(s) for s in seqs) + 1
    dev = lp.device
    inp = torch.full((N, L), tx.PAD, dtype=torch.long, device=dev)
    out = torch.full((N, L), tx.PAD, dtype=torch.long, device=dev)
    mask = torch.zeros((N, L), device=dev)
    for i, s in enumerate(seqs):
        inp[i, :len(s) + 1] = torch.tensor([tx.SOS] + s)
        out[i, :len(s) + 1] = torch.tensor(s + [tx.EOS])
        mask[i, :len(s) + 1] = 1.0
    att = M.decoder_log_probs(P, cfg, inp, enc, lens, prec)
    att = (torch.gather(att, 2, out[..., None])[..., 0] * mask).sum(1)
    tgt = torch.zeros((N, max(L - 1, 1)), dtype=torch.long, device=dev)
    for i, s in enumerate(seqs):
        if s:
            tgt[i, :len(s)] = torch.tensor(s)
    nll = F.ctc_loss(lp.transpose(0, 1), tgt, lens.long(),
                     torch.tensor([len(s) for s in seqs], device=dev),
                     blank=tx.BLANK, reduction="none")
    table, order = lm[2], lm[1]
    lmv = np.zeros(N)
    for i, s in enumerate(seqs):
        ctx = lm_context0(order)
        for c in s + [tx.EOS]:
            lmv[i] += float(table[ctx, c])
            ctx = (ctx * tx.V + c) % (tx.V ** (order - 1))
    raw = (1 - w) * att.double().cpu().numpy() \
        - w * nll.double().cpu().numpy() + lw * lmv
    n = np.asarray([len(s) + 1 for s in seqs], np.float64)
    return raw / ((n + 5.0) / 6.0) ** pen


def viterbi(lp, lens, seqs):
    """Best CTC alignment log-probability of each row's token list; the
    per-frame maxima's sum beside it -> (numpy, numpy)."""
    N, T, _ = lp.shape
    dev = lp.device
    L = max(1, max(len(s) for s in seqs))
    S = 2 * L + 1
    ext = torch.zeros((N, S), dtype=torch.long, device=dev)
    for i, s in enumerate(seqs):
        if s:
            ext[i, 1:2 * len(s):2] = torch.tensor(s)
    prev2 = F.pad(ext, (2, 0), value=tx.BLANK)[:, :S]
    skip = (ext != tx.BLANK) & (ext != prev2)
    em = torch.gather(lp, 2, ext[:, None].expand(N, T, S))
    a = torch.full((N, S), NEG, device=dev)
    a[:, 0] = em[:, 0, 0]
    a[:, 1] = em[:, 0, 1]
    ln = lens.long()
    for t in range(1, T):
        s1 = F.pad(a, (1, 0), value=NEG)[:, :S]
        s2 = torch.where(skip, F.pad(a, (2, 0), value=NEG)[:, :S], NEG)
        nxt = torch.maximum(torch.maximum(a, s1), s2) + em[:, t]
        a = torch.where((t < ln)[:, None], nxt, a)
    k = torch.tensor([len(s) for s in seqs], device=dev)
    end = torch.gather(a, 1, (2 * k)[:, None])[:, 0]
    end2 = torch.gather(a, 1, (2 * k - 1).clamp(min=0)[:, None])[:, 0]
    best = torch.maximum(end, torch.where(k > 0, end2, NEG))
    ok = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
    top = (lp.amax(-1) * ok).sum(1)
    return best.double().cpu().numpy(), top.double().cpu().numpy()


def segments(valid, gap=25):
    idx = np.flatnonzero(np.asarray(valid, bool))
    if idx.size == 0:
        return []
    segs, start, prev = [], int(idx[0]), int(idx[0])
    for i in idx[1:]:
        if int(i) - prev - 1 >= gap:
            segs.append((start, prev + 1))
            start = int(i)
        prev = int(i)
    segs.append((start, prev + 1))
    return segs
