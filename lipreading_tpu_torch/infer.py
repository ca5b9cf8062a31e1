"""Inference: encoder pass and decoding strategy dispatch (counterpart of
``lipreading_tpu/infer.py``: ``decode_ids``, ``decode_ids_from_enc``,
``ctc_log_probs``, ``transcribe``, ``transcribe_cascade`` and the body of
``_greedy_conf_jit``).

* ``greedy_conf`` encodes, takes the float32 CTC log-probabilities, their
  mean top1 - top2 margin over valid frames (the cascade's confidence) and
  the greedy ids from the CTC-greedy kernel. ``transcribe_greedy`` runs
  uint8 frames through preprocessing and ``greedy_conf`` to strings and
  flags the clips below the margin.
* ``decode_ids`` picks the decoder: CTC greedy (the kernel) or the device
  CTC prefix beam for ``decoder="ctc"``; the attention decoder's greedy
  decode at beam <= 1; the joint CTC/attention beam (``ops/joint_decode``),
  with char-LM fusion and the lexicon DFA on request, for ``"hybrid"``.
* ``transcribe_cascade`` runs the greedy leg on every clip and the joint
  beam only on the clips its triggers flag, from the greedy leg's encoder
  output.
* ``transcribe_segmented`` decodes one tracked video by shot: it splits the
  frames at long runs of invalid (no-face) frames and, given the frames'
  signatures (``frame_signature``), at hard cuts (``signature_cuts``), and
  decodes the segments as one batch (numpy helpers ``segment_valid_runs``
  and the two above, copied from the JAX package).

Every entry runs on the device of the model; the char LM
(``assets/char_lm.npz``) and the lexicon tables are loaded once per device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lipreading_tpu_torch import profiling
from lipreading_tpu_torch.config import Config
from lipreading_tpu_torch.fixtures import LEXICON
from lipreading_tpu_torch.io import ASSETS_DIR
from lipreading_tpu_torch.lexicon import fixture_lexicon, to_torch
from lipreading_tpu_torch.lm import load_lm, lm_nll_per_char
from lipreading_tpu_torch.models import attention
from lipreading_tpu_torch.models import transformer as tf
from lipreading_tpu_torch.models.lipreader import (
    LipReader,
    _act_dtype,
    ctc_logits,
    encode,
)
from lipreading_tpu_torch.models.nn import length_mask
from lipreading_tpu_torch.ops.decode import (
    beam_search,
    ctc_greedy_ids,
    greedy_decode,
)
from lipreading_tpu_torch.ops.joint_decode import (
    ctc_prefix_beam_device,
    joint_beam_search,
)
from lipreading_tpu_torch.ops.preprocess import preprocess_clips
from lipreading_tpu_torch.text import Vocab


def _attention_step_fn(model: LipReader, cfg: Config, enc: torch.Tensor,
                       enc_lengths: torch.Tensor, dtype):
    """(initial state, step_fn) of the model's attention decoder.

    The Bahdanau decoder's state is ``{"h": [B, H]}`` in the encoder's type;
    its encoder-side projection and mask are computed once here. The
    transformer decoder's state is its KV cache, which rides the activation
    type: ``decoder_step`` computes K/V in it and casts cache reads back to
    it, so a float32 cache under bf16 activations would only hold exact
    bf16 values at twice the bytes. The cross-attention K/V are computed
    once here; they are constant across steps and identical across the
    beams of a sample (enc is tiled by repeat), so the step closes over them
    and the beams never gather them."""
    p = model.att_decoder
    if cfg.encoder == "bigru":
        enc_proj = attention.precompute_attention(p, enc, dtype)
        enc_mask = length_mask(enc_lengths, enc.shape[1])
        state = {"h": torch.zeros(enc.shape[0], p.gru.w_hh.shape[0],
                                  dtype=enc.dtype, device=enc.device)}

        def gru_step(state, tok):
            h, logits = attention.decoder_step(p, state["h"], tok, enc,
                                               enc_proj, enc_mask, dtype)
            return {"h": h}, logits

        return state, gru_step
    heads = cfg.model.tf_heads
    cache = tf.decoder_init_cache(p, enc.shape[0], cfg.train.max_decode_len,
                                  heads, dtype or torch.float32)
    cross_kv = tf.decoder_cross_kv(p, enc, heads, dtype)

    def step(cache, tok):
        return tf.decoder_step(p, cache, tok, enc, enc_lengths, heads, dtype,
                               cross_kv=cross_kv)

    return cache, step


_LM_CACHE: dict = {}


def load_char_lm(device) -> tuple[torch.Tensor, int] | None:
    """The shipped char LM (``assets/char_lm.npz``) as (table [V^3, V]
    float32 on ``device``, order), or None without the file; loaded once
    per device."""
    key = ("lm", str(torch.device(device)))
    if key not in _LM_CACHE:
        host = load_char_lm_host()
        _LM_CACHE[key] = None if host is None else (
            torch.from_numpy(host[0]).to(device), host[1])
    return _LM_CACHE[key]


def load_char_lm_host() -> tuple[np.ndarray, int] | None:
    """The shipped char LM as (numpy table, order), or None; loaded once."""
    if "lm_host" not in _LM_CACHE:
        path = os.path.join(ASSETS_DIR, "char_lm.npz")
        _LM_CACHE["lm_host"] = load_lm(path) if os.path.exists(path) else None
    return _LM_CACHE["lm_host"]


def load_lexicon(device) -> dict[str, torch.Tensor]:
    """The fixture-corpus lexicon DFA (``lexicon.fixture_lexicon``) on
    ``device``; built once per device."""
    key = ("lex", str(torch.device(device)))
    if key not in _LM_CACHE:
        _LM_CACHE[key] = to_torch(fixture_lexicon(), device)
    return _LM_CACHE[key]


@torch.inference_mode()
def decode_ids(model: LipReader, cfg: Config, rois, frame_lengths,
               beam: int | None = None, lm_weight: float = 0.0, lm=None,
               lexicon=None):
    """[B, T, R, R] ROIs + [B] lengths on the model's device -> (ids [B, L],
    lengths [B]) on that device.

    Strategy: CTC greedy (the kernel) for ``decoder="ctc"`` at beam <= 1,
    the device CTC prefix beam (``ctc_prefix_beam_device``) at beam > 1;
    for the attention decoders, greedy at beam <= 1, else the joint
    CTC/attention beam (``"hybrid"``) or the attention beam."""
    enc = encode(model, cfg, rois, frame_lengths, _act_dtype(cfg))
    return decode_ids_from_enc(model, cfg, enc, frame_lengths, beam,
                               lm_weight, lm=lm, lexicon=lexicon)


@torch.inference_mode()
def decode_ids_from_enc(model: LipReader, cfg: Config, enc: torch.Tensor,
                        frame_lengths: torch.Tensor, beam: int | None = None,
                        lm_weight: float = 0.0, lm=None, lexicon=None):
    """``decode_ids`` from a precomputed encoder output [B, T, D], so the
    cascade's rescore leg reuses the encoder pass of its greedy leg.
    ``lm`` (table, order) is loaded from the assets when ``lm_weight`` > 0
    and it is None."""
    dtype = _act_dtype(cfg)
    vocab = Vocab()
    beam = cfg.train.beam_width if beam is None else beam
    max_len = cfg.train.max_decode_len
    B = enc.shape[0]
    frame_lengths = frame_lengths.to(torch.int32)
    if lm is None and lm_weight > 0.0 and beam > 1:
        lm = load_char_lm(enc.device)
    if cfg.decoder == "ctc":
        logits = ctc_logits(model, enc)
        if beam > 1:
            return ctc_prefix_beam_device(
                logits, frame_lengths, beam, max_len, blank=vocab.blank_id,
                sos=vocab.sos_id, eos=vocab.eos_id, lexicon=lexicon, lm=lm,
                lm_weight=lm_weight)
        return ctc_greedy_ids(logits, frame_lengths, blank=vocab.blank_id)
    if beam <= 1:
        state, step = _attention_step_fn(model, cfg, enc, frame_lengths,
                                         dtype)
        return greedy_decode(step, state, B, max_len, vocab.sos_id,
                             vocab.eos_id)

    enc_t = torch.repeat_interleave(enc, beam, dim=0)
    len_t = torch.repeat_interleave(frame_lengths, beam, dim=0)
    state, step = _attention_step_fn(model, cfg, enc_t, len_t, dtype)
    if cfg.decoder == "hybrid":
        # joint CTC/attention one-pass decoding: the frame-synchronous CTC
        # prefix score vetoes attention loops; optional shallow fusion with
        # the shipped char LM
        ctc_t = torch.repeat_interleave(ctc_logits(model, enc), beam, dim=0)
        return joint_beam_search(
            step, state, ctc_t, len_t, B, beam, max_len, vocab.sos_id,
            vocab.eos_id, blank=vocab.blank_id,
            ctc_weight=cfg.train.ctc_weight,
            length_penalty=cfg.train.length_penalty, lm=lm,
            lm_weight=lm_weight, lexicon=lexicon)
    return beam_search(step, state, B, beam, max_len, vocab.sos_id,
                       vocab.eos_id, length_penalty=cfg.train.length_penalty)


@torch.inference_mode()
def ctc_log_probs(model: LipReader, cfg: Config, rois: torch.Tensor,
                  frame_lengths: torch.Tensor) -> torch.Tensor:
    """[B, T, R, R] -> [B, T, V] float32 log-posteriors of the CTC head."""
    enc = encode(model, cfg, rois, frame_lengths, _act_dtype(cfg))
    return torch.log_softmax(ctc_logits(model, enc), dim=-1)


def _on_device(model: LipReader, rois, frame_lengths):
    """ROIs and int32 lengths (numpy or tensors) on the model's device (a
    copy from host memory waits for the device's stream)."""
    dev = next(model.parameters()).device
    with profiling.span("wait.h2d"):
        return (torch.as_tensor(rois, device=dev),
                torch.as_tensor(frame_lengths, dtype=torch.int32,
                                device=dev))


def _texts(ids: torch.Tensor, lengths: torch.Tensor, vocab: Vocab):
    """Padded ids [B, L] and lengths [B] -> strings (specials dropped)."""
    with profiling.span("wait.texts"):
        ids, lengths = ids.cpu().numpy(), lengths.cpu().numpy()
    return [vocab.decode(ids[b, :lengths[b]]) for b in range(ids.shape[0])]


def transcribe(model: LipReader, cfg: Config, rois, frame_lengths,
               beam: int | None = None, vocab: Vocab | None = None,
               lm_weight: float = 0.0, use_lexicon: bool = False) -> list[str]:
    """Batch of ROI sequences (numpy or tensors) -> transcripts.

    ``use_lexicon`` constrains the beam decodes (CTC prefix beam, joint) to
    the fixture-corpus word lexicon; greedy decodes ignore it."""
    vocab = vocab or Vocab()
    rois, frame_lengths = _on_device(model, rois, frame_lengths)
    lex = load_lexicon(rois.device) if use_lexicon else None
    ids, lengths = decode_ids(model, cfg, rois, frame_lengths, beam,
                              lm_weight, lexicon=lex)
    # CTC ids are already collapsed; attention ids are raw: decode drops
    # the specials either way
    return _texts(ids, lengths, vocab)


def transcribe_cascade(model: LipReader, cfg: Config, rois, frame_lengths,
                       beam: int | None = None, vocab: Vocab | None = None,
                       lm_weight: float = 0.0, use_lexicon: bool = False,
                       margin: float = 8.0, lm_margin: float = 1.35,
                       lm_min_chars: int = 4, oov_trigger: bool = True,
                       oov_words=None, rescore_bucket: int = 8,
                       return_flags: bool = False, mark=None, rows=None):
    """Cascade decoding: CTC greedy on every clip, then the joint beam (with
    the LM and lexicon as asked) only on the uncertain clips, decoded from
    the greedy leg's encoder output. Confident clips keep the greedy
    transcript.

    Three triggers flag a clip:
    * CTC margin: mean top1 - top2 log-posterior gap below ``margin`` nats;
    * LM score (when ``lm_weight`` > 0): the greedy transcript's per-char
      NLL under the shipped char LM above ``lm_margin``, for transcripts of
      at least ``lm_min_chars`` chars (a correct short word has a high
      per-char NLL from its boundary transitions alone);
    * out of lexicon (``oov_trigger``): a word of the greedy transcript
      outside ``oov_words`` (default: ``fixtures.LEXICON``).

    The flagged rows are padded to a multiple of ``rescore_bucket`` by
    repeating the last one; the duplicates are discarded. Returns
    (transcripts, n_rescored), or (transcripts, flags [B] bool numpy) with
    ``return_flags``. At ``margin=inf`` every clip is rescored (==
    ``transcribe``); with every trigger off (margin=0, lm_margin=inf,
    oov_trigger=False) none is (== greedy). ``mark(stage)``, if given, is
    called after the greedy leg ("greedy") and after the rescore leg
    ("rescore"). ``rows`` ([B] bool, default every row) limits the rescore
    leg to those clips: the others keep their greedy transcript and are
    never flagged (the serving loop decodes them by shot, and the greedy
    leg keeps the batch's shape). Traced (``profiling``): the span
    ``cascade`` and the counters ``cascade.calls``, and ``beam.rows`` and
    ``beam.pad_rows`` (the rescore leg's rows, and the repeats among
    them)."""
    with profiling.span("cascade"):
        profiling.count("cascade.calls")
        mark = mark or (lambda stage: None)
        vocab = vocab or Vocab()
        beam = cfg.train.beam_width if beam is None else beam
        rois, frame_lengths = _on_device(model, rois, frame_lengths)
        ids, counts, conf, enc = greedy_conf(model, cfg, rois, frame_lengths)
        out = _texts(ids, counts, vocab)
        with profiling.span("wait.conf"):
            uncertain = conf.cpu().numpy() < margin
        if lm_weight > 0.0 and np.isfinite(lm_margin):
            lm = load_char_lm_host()
            if lm is not None:
                lm_nll = np.asarray([lm_nll_per_char(lm[0], lm[1], t, vocab)
                                     for t in out])
                long_enough = np.asarray([len(t) >= lm_min_chars for t in out])
                uncertain |= (lm_nll > lm_margin) & long_enough
        if oov_trigger:
            if oov_words is None:
                oov_words = set(LEXICON)
            uncertain |= np.asarray(
                [any(w not in oov_words for w in t.split()) for t in out])
        if rows is not None:
            uncertain &= np.asarray(rows, bool)
        idx = np.nonzero(uncertain)[0]
        mark("greedy")
        if beam > 1 and idx.size:
            n, pad = idx.size, -idx.size % rescore_bucket
            profiling.count("beam.rows", n + pad)
            profiling.count("beam.pad_rows", pad)
            with profiling.span("wait.h2d"):
                take = torch.from_numpy(np.concatenate(
                    [idx, np.repeat(idx[-1:], pad)])).to(enc.device)
            lex = load_lexicon(enc.device) if use_lexicon else None
            sids, slens = decode_ids_from_enc(model, cfg, enc[take],
                                              frame_lengths[take], beam,
                                              lm_weight, lexicon=lex)
            sub = _texts(sids, slens, vocab)
            for k, b in enumerate(idx):
                out[int(b)] = sub[k]
        mark("rescore")
        if return_flags:
            return out, uncertain
        return out, int(idx.size)


@torch.inference_mode()
def greedy_conf(model: LipReader, cfg: Config, rois: torch.Tensor,
                lengths: torch.Tensor):
    """[B, T, R, R] ROIs + [B] frame lengths -> (ids [B, T] int32,
    counts [B] int32, conf [B] float32, enc [B, T, D]).

    Greedy runs on the float32 log-probabilities, not on the logits, as the
    JAX package does: subtracting the log-sum-exp can turn two close logits
    into a tie, and a tie goes to the lower id."""
    lengths = lengths.to(torch.int32)
    enc = encode(model, cfg, rois, lengths, _act_dtype(cfg))
    logp = torch.log_softmax(ctc_logits(model, enc), dim=-1)
    top2 = torch.topk(logp, 2, dim=-1).values                   # [B, T, 2]
    margin = top2[..., 0] - top2[..., 1]
    mask = length_mask(lengths, logp.shape[1]).float()
    conf = (margin * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
    ids, counts = ctc_greedy_ids(logp, lengths, blank=Vocab().blank_id)
    return ids, counts, conf, enc


def transcribe_greedy(model: LipReader, cfg: Config, det_params, ert_model,
                      clips, frame_lengths=None, margin: float = 8.0,
                      vocab: Vocab | None = None):
    """[B, T, H, W, 3] uint8 clips (numpy or tensor) -> (transcripts,
    flags [B] bool numpy).

    Runs on the device of ``model``; ``det_params`` and ``ert_model`` must
    lie there too. ``flags[b]`` is ``conf < margin``, the cascade's margin
    trigger."""
    vocab = vocab or Vocab()
    dev = next(model.parameters()).device
    clips = torch.as_tensor(clips, device=dev)
    B, T = clips.shape[:2]
    if frame_lengths is None:
        frame_lengths = torch.full((B,), T, dtype=torch.int32)
    lengths = torch.as_tensor(frame_lengths, dtype=torch.int32, device=dev)
    rois = preprocess_clips(det_params, ert_model, clips, cfg.preprocess)
    ids, counts, conf, _ = greedy_conf(model, cfg, rois, lengths)
    ids, counts = ids.cpu().numpy(), counts.cpu().numpy()
    texts = [vocab.decode(ids[b, :counts[b]]) for b in range(B)]
    return texts, (conf < margin).cpu().numpy()


def frame_signature(frames, grid: int = 16) -> np.ndarray:
    """[N, H, W, 3] uint8 -> [N, grid, grid] block-mean gray in [0, 1]: the
    shot-boundary signal. Background and framing are static within a shot,
    so the consecutive-frame difference of the full-frame signature jumps
    at a hard cut, where the mouth ROI alone cannot tell a cut from
    talking motion."""
    f = np.asarray(frames)
    g = f.astype(np.float32).mean(-1) if f.ndim == 4 else f.astype(np.float32)
    N, H, W = g.shape
    H2, W2 = H - H % grid, W - W % grid
    s = g[:, :H2, :W2].reshape(
        N, grid, H2 // grid, grid, W2 // grid).mean((2, 4))
    return s / 255.0


def signature_cuts(sig: np.ndarray, cut_k: float = 8.0,
                   cut_min: float = 0.02) -> np.ndarray:
    """Hard-cut frame indices of a [N, g, g] signature sequence: a cut at i
    means frames i - 1 and i straddle a shot boundary. The threshold is
    ``cut_k`` times the sequence's median consecutive-frame difference,
    and at least ``cut_min``, so a near-static stream cannot fire on
    noise."""
    sig = np.asarray(sig)
    if sig.shape[0] < 2:
        return np.zeros((0,), np.int64)
    d = np.abs(np.diff(sig, axis=0)).mean(axis=(1, 2))
    thr = max(cut_min, cut_k * float(np.median(d)))
    return np.flatnonzero(d > thr) + 1


def segment_valid_runs(valid, gap: int = 25) -> list[tuple[int, int]]:
    """A frame-validity mask -> shot segments, ``[start, end)`` spans over
    the frame axis: a run of at least ``gap`` invalid frames is a shot
    boundary (a cutaway). Leading and trailing invalid frames are trimmed;
    shorter invalid runs stay inside a span (the caller drops those
    frames). ``gap <= 0``: one span over all valid frames."""
    valid = np.asarray(valid).astype(bool)
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return []
    if gap <= 0:
        return [(int(idx[0]), int(idx[-1]) + 1)]
    segs = []
    start = prev = int(idx[0])
    for i in idx[1:]:
        if int(i) - prev - 1 >= gap:
            segs.append((start, prev + 1))
            start = int(i)
        prev = int(i)
    segs.append((start, prev + 1))
    return segs


def transcribe_segmented(model: LipReader, cfg: Config, rois, valid,
                         gap: int = 25, bucket: int = 64,
                         cascade: bool = False, sig=None, cut_k: float = 8.0,
                         cut_min: float = 0.02, **decode_kw):
    """Tracked decode of one video by shot.

    ``rois`` [N, R, R] (numpy, from
    ``ops.preprocess.preprocess_padded_tracked``, or a tensor, which stays
    on its device) and ``valid`` [N] (numpy) over the video's frame axis.
    The video splits at runs of at least ``gap`` invalid frames and, with
    ``sig`` (``frame_signature`` of the same frames), at hard cuts.
    Each segment keeps its valid frames; the segments are padded to a
    multiple of ``bucket`` and decoded by ``transcribe``, or
    ``transcribe_cascade`` with ``cascade``, one call a length bucket
    (one shared bucket for ``framewise_norm`` models, whose frames do not
    see the padding). Returns (the segments' texts joined by spaces,
    [((start, end), text), ...])."""
    valid = np.asarray(valid).astype(bool)
    dev = next(model.parameters()).device
    rois = (rois.to(dev) if isinstance(rois, torch.Tensor)
            else torch.tensor(np.asarray(rois), device=dev))
    segs = segment_valid_runs(valid, gap)
    if sig is not None and segs:
        cuts = signature_cuts(sig, cut_k, cut_min)
        split = []
        for lo, hi in segs:
            for c in cuts[(cuts > lo) & (cuts < hi)]:
                if valid[lo:c].any():
                    split.append((lo, int(c)))
                lo = int(c)
            if valid[lo:hi].any():
                split.append((lo, hi))
        segs = split
    if not segs:
        return "", []
    with profiling.span("wait.h2d"):
        seg_rois = [rois[torch.from_numpy(lo + np.flatnonzero(valid[lo:hi]))
                         .to(rois.device)] for lo, hi in segs]
    lens = [int(r.shape[0]) for r in seg_rois]
    # segments batch by length bucket: under the releases' time-pooled
    # GroupNorm a short segment padded to a long one's bucket sees other
    # features; framewise-norm models do not, and share one bucket
    buckets: dict[int, list[int]] = {}
    if cfg.model.framewise_norm:
        buckets[-(-max(lens) // bucket) * bucket] = list(range(len(segs)))
    else:
        for i, L in enumerate(lens):
            buckets.setdefault(-(-L // bucket) * bucket, []).append(i)
    texts = [""] * len(segs)
    for tb, idxs in sorted(buckets.items()):
        batch = rois.new_zeros((len(idxs), tb) + tuple(rois.shape[1:]))
        for k, i in enumerate(idxs):
            batch[k, :lens[i]] = seg_rois[i]
        blens = np.asarray([lens[i] for i in idxs], np.int32)
        if cascade:
            sub, _ = transcribe_cascade(model, cfg, batch, blens, **decode_kw)
        else:
            sub = transcribe(model, cfg, batch, blens, **decode_kw)
        for k, i in enumerate(idxs):
            texts[i] = sub[k]
    text = " ".join(t for t in texts if t)
    return text, list(zip(segs, texts))
