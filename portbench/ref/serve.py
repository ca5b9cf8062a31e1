"""Plain reference of one serving batch and the judge of a served batch.

``reference_batch`` runs the serving path's semantics from the raw frames:
the tracked preprocessing (``ref/preprocess.py``), the encoder and CTC head
(``ref/model.py``), greedy on every clip; the cascade's triggers flag clips
valid on every frame of their length for the joint beam with the char LM;
a clip with an invalid frame inside its length is decoded by shot (its
valid frames, shot by shot, zero-padded to a multiple of 64 frames: one
shared pad for models whose norms are per frame, each shot its own for the
others, whose GroupNorm pools over the padded frames too), each shot
through the same cascade, the shots' texts joined by spaces.

``judge`` holds a served batch against it:

* ``roi_max_abs``: the largest |ROI - reference ROI| over every frame of
  the batch, in normalised units;
* ``valid_mismatch``: frames inside a clip's length whose valid flag
  differs (an exact comparison);
* ``ctc_kl``: the greedy leg's CTC posteriors, the largest KL divergence
  (nats) of a valid frame's served distribution from the reference's;
* ``transcript_gap``: how far (nats) the served transcripts and the
  cascade's choices lie below the reference's (``transcript_gap``): a
  transcript that differs on a near tie, and scores as high, reads 0."""

from __future__ import annotations

import numpy as np
import torch

from portbench.frozen import text as tx
from portbench.ref import decode as D
from portbench.ref import model as M
from portbench.ref import preprocess as RP

SHOT_BUCKET = 64
BIG = 1e3


def _encode(P, cfg, rois, lens, prec, block=16):
    encs, lps = [], []
    for i in range(0, rois.shape[0], block):
        e = M.encode(P, cfg, rois[i:i + block], lens[i:i + block], prec)
        encs.append(e)
        lps.append(M.ctc_log_probs(P, e, prec))
    return torch.cat(encs), torch.cat(lps)


def _decode_rows(P, cfg, enc, lens, lp, lm, serve, prec, beam_all=False):
    """Greedy, triggers and (for flagged rows, or all with ``beam_all``) the
    joint beam -> dict of per-row lists."""
    texts, conf = D.greedy(lp, lens)
    trig = [D.triggers(t, c, lm, serve) for t, c in zip(texts, conf)]
    flags = [f for f, _ in trig]
    rows = [i for i in range(len(texts)) if beam_all or flags[i]]
    beams = [None] * len(texts)
    if rows:
        sel = torch.tensor(rows, device=enc.device)
        for i, s in zip(rows, D.joint_beam(P, cfg, enc[sel], lens[sel],
                                           lp[sel], lm, serve, prec)):
            beams[i] = s
    final = [tx.decode(beams[i]) if flags[i] else texts[i]
             for i in range(len(texts))]
    return {"greedy": texts, "conf": conf, "flags": flags,
            "dist": [d for _, d in trig], "beam": beams, "text": final}


@torch.no_grad()
def reference_batch(frames, lens, assets, P, cfg, lm, serve, pre,
                    prec_pre=None, prec_model=None):
    """frames [B, T, H, W, 3] uint8 tensor, lens [B] int tensor (both on
    the reference's device) -> the reference's batch (a dict)."""
    prec_pre = prec_pre or M.Prec()
    prec_model = prec_model or M.Prec()
    rois, valid = RP.preprocess(frames, assets, pre, prec_pre)
    lens_np = lens.cpu().numpy()
    valid_np = valid.cpu().numpy()
    B = len(lens_np)
    seg = np.asarray([not valid_np[k, :lens_np[k]].all() for k in range(B)])
    with prec_model.flags():
        enc, lp = _encode(P, cfg, rois, lens, prec_model)
        main = _decode_rows(P, cfg, enc, lens, lp, lm, serve, prec_model)
        shots = {}
        framewise = cfg["model"].get("framewise_norm", False)
        for k in np.flatnonzero(seg):
            n = int(lens_np[k])
            spans = D.segments(valid_np[k, :n])
            parts = [rois[k, lo + np.flatnonzero(valid_np[k, lo:hi])]
                     for lo, hi in spans]
            shared = (-(-max(len(p) for p in parts) // SHOT_BUCKET)
                      * SHOT_BUCKET if parts else 0)
            out = []
            for part in parts:
                L = len(part)
                pad = shared if framewise else -(-L // SHOT_BUCKET) * SHOT_BUCKET
                x = part.new_zeros((1, pad) + tuple(part.shape[1:]))
                x[0, :L] = part
                ln = torch.tensor([L], device=x.device)
                e, l = _encode(P, cfg, x, ln, prec_model)
                r = _decode_rows(P, cfg, e, ln, l, lm, serve, prec_model,
                                 beam_all=True)
                out.append({"enc": e, "lp": l, "len": ln, **{
                    key: v[0] for key, v in r.items()}})
            shots[int(k)] = out
    texts = list(main["text"])
    for k, out in shots.items():
        texts[k] = " ".join(s["text"] for s in out if s["text"])
    flags = np.asarray(main["flags"]) & ~seg
    return {"rois": rois, "valid": valid, "seg": seg, "enc": enc, "lp": lp,
            "main": main, "shots": shots, "texts": texts, "flags": flags,
            "lens": lens}


def _row_gaps(P, cfg, enc, lens, lp, served, ref_beam, lm, serve, prec):
    """(greedy gap, beam gap) of each served token list."""
    best, top = D.viterbi(lp, lens, served)
    s_served = D.joint_score(P, cfg, enc, lens, lp, served, lm, serve, prec)
    s_ref = D.joint_score(P, cfg, enc, lens, lp, ref_beam, lm, serve, prec)
    return top - best, np.maximum(s_ref - s_served, 0.0)


def _lexicon_or_lm(text, lm, serve):
    """The lexicon or the LM trigger fires on ``text``."""
    if any(w not in D.LEX for w in text.split()):
        return True
    return (len(text) >= serve["lm_min_chars"]
            and D.lm_nll(lm[2], lm[1], text) > serve["lm_margin"])


def transcript_gap(served, ref, P, cfg, lm, serve) -> float:
    """The largest of, over the batch's clips (nats): for a clip served by
    greedy, how far its transcript's best CTC alignment lies below the
    best path; for a rescored clip, how far its joint score lies below
    the reference beam's (0 where as high or higher); where the cascade's
    flag differs from the reference's, how near the reference's trigger
    was to the other side (``BIG`` where a transcript served by greedy
    trips the lexicon or LM trigger); for a clip decoded by shot, the
    smaller of the first two for its shot (``BIG`` where the shots are
    several and the texts differ); ``BIG`` where a clip was decoded by
    shot on one side and not on the other."""
    prec = M.Prec()
    lens = ref["lens"]
    B = len(served["texts"])
    seg_p = np.asarray(served["seg"], bool)
    flags_p = np.asarray(served["flags"], bool)
    main = ref["main"]
    gap = BIG if np.any(seg_p != np.asarray(ref["seg"], bool)) else 0.0
    rows = [k for k in range(B) if not seg_p[k] and not ref["seg"][k]]
    if rows:
        sel = torch.tensor(rows, device=lens.device)
        ids = [list(tx.encode(served["texts"][k])) for k in rows]
        need = [k for k in rows if flags_p[k] and main["beam"][k] is None]
        if need:
            s = torch.tensor(need, device=lens.device)
            for k, seq in zip(need, D.joint_beam(
                    P, cfg, ref["enc"][s], lens[s], ref["lp"][s], lm, serve,
                    prec)):
                main["beam"][k] = seq
        g, b = _row_gaps(P, cfg, ref["enc"][sel], lens[sel], ref["lp"][sel],
                         ids, [main["beam"][k] if flags_p[k] else i
                               for k, i in zip(rows, ids)], lm, serve, prec)
        for j, k in enumerate(rows):
            gap = max(gap, float(b[j] if flags_p[k] else g[j]))
            if flags_p[k] and not main["flags"][k]:
                gap = max(gap, float(main["dist"][k]))
            elif not flags_p[k] and main["flags"][k]:
                gap = max(gap, BIG if _lexicon_or_lm(served["texts"][k], lm,
                                                     serve)
                          else serve["margin"] - float(main["conf"][k]))
    for k in range(B):
        if not (seg_p[k] and ref["seg"][k]):
            continue
        shots = ref["shots"][k]
        if len(shots) != 1:
            if served["texts"][k] != ref["texts"][k]:
                gap = BIG
            continue
        s = shots[0]
        g, b = _row_gaps(P, cfg, s["enc"], s["len"], s["lp"],
                         [list(tx.encode(served["texts"][k]))], [s["beam"]],
                         lm, serve, prec)
        gap = max(gap, float(min(g[0], b[0])))
    return gap


@torch.no_grad()
def judge(served: dict, ref: dict, P, cfg, lm, serve) -> dict:
    """served: {"rois", "valid", "logp" tensors, "texts" list, "flags",
    "seg"} of the batch ``ref`` was computed for -> the numbers."""
    lens_np = ref["lens"].cpu().numpy()
    inside = (np.arange(ref["valid"].shape[1])[None] < lens_np[:, None])
    dev = ref["rois"].device
    sv = served["valid"].cpu().numpy().astype(bool)
    lr = ref["lp"]
    ls = served["logp"].float().to(dev)
    kl = (lr.exp() * (lr - ls)).sum(-1)
    ok = torch.from_numpy(inside).to(dev)
    nums = {
        "roi_max_abs": float((served["rois"].float().to(dev)
                              - ref["rois"]).abs().max()),
        "valid_mismatch": float(((sv != ref["valid"].cpu().numpy())
                                 & inside).sum()),
        "ctc_kl": float(torch.where(ok, kl, 0.0).amax()),
    }
    with M.Prec().flags():
        nums["transcript_gap"] = transcript_gap(served, ref, P, cfg, lm,
                                                serve)
    return nums


def served_from_reference(ref: dict) -> dict:
    """A reference batch (the control's) in the served batch's form."""
    return {"rois": ref["rois"], "valid": ref["valid"], "logp": ref["lp"],
            "texts": ref["texts"], "flags": ref["flags"], "seg": ref["seg"]}
