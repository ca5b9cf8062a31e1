"""Streaming (online) transcription: chunked sliding-window decoding
(counterpart of ``lipreading_tpu/streaming.py``).

Frames arrive in chunks (a webcam's); each chunk is padded to a multiple of
``chunk_bucket`` by repeating its last frame and preprocessed on the device
of the model, and its ROI frames join a buffer that stays on that device.
The encoders are bidirectional, so the transcriber re-decodes a window:

* every ``decode_every`` buffered frames the window is encoded and its live
  suffix decoded: the per-frame argmax of the CTC head (greedy), or at
  ``beam`` > 1 the CTC prefix beam (``ops/joint_decode``, with char-LM
  fusion at ``lm_weight`` > 0) over the log-probabilities rolled so that
  the live suffix comes first;
* when the buffer outgrows ``window``, the text before the last blank run
  ahead of a ``tail_guard`` is committed and its frames dropped, but the
  trailing ``context`` frames stay as encoder context (``_ctx``: their text
  is already committed). At ``beam`` > 1 the beam's hypothesis is forced
  back onto the frames (``ops/ctc.ctc_viterbi_align``) to find the cut, so
  the committed words are the beam's;
* with ``tracked`` (the presence head), each chunk runs the robust
  detection path with the track's state carried across chunks, frames
  without a confident face are never buffered, a run of ``gap_flush``
  such frames or a hard cut of the frame signature (``cut_flush``) is a
  shot boundary: the buffer is decoded and committed in full and the
  context reset. After a hard cut the track is re-acquired from the cut
  frame with a fresh state;
* at a flush or ``finish()``, a ``hybrid`` model at ``beam`` > 1 decodes
  the uncommitted suffix with the joint CTC/attention beam.

The tracked chunk samples integer mouth boxes, whatever the landmarker, as
the JAX package's does; the untracked chunk goes through
``preprocess_frames``, which follows ``use_subpixel_roi``. The ROI kernel
is the only kernel on this path; the alignment, the beams and the Viterbi
loop are plain PyTorch, as the JAX package leaves them to XLA.
``counts`` counts the window commits, Viterbi alignments, beam-tail
decodes, segment decodes and flushes.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from lipreading_tpu_torch.config import Config
from lipreading_tpu_torch.infer import (
    ctc_log_probs,
    decode_ids,
    frame_signature,
    load_char_lm,
)
from lipreading_tpu_torch.models.lipreader import LipReader
from lipreading_tpu_torch.ops import detector as det_ops
from lipreading_tpu_torch.ops import ert as ert_ops
from lipreading_tpu_torch.ops import landmarker as lmk_ops
from lipreading_tpu_torch.ops import roi as roi_ops
from lipreading_tpu_torch.ops.ctc import ctc_viterbi_align
from lipreading_tpu_torch.ops.joint_decode import ctc_prefix_beam_device
from lipreading_tpu_torch.ops.preprocess import (
    mouth_boxes_from_landmarks,
    preprocess_frames,
)
from lipreading_tpu_torch.ops.tracking import track_boxes
from lipreading_tpu_torch.text import Vocab


class StreamingTranscriber:
    """Online video -> growing transcript, on the device of ``model``."""

    def __init__(
        self,
        model: LipReader,
        cfg: Config,
        det,
        ert,
        window: int = 128,
        decode_every: int = 16,
        beam: int = 1,
        lm_weight: float = 0.0,
        chunk_bucket: int = 16,
        tail_guard: int = 24,
        context: int = 16,
        presence=None,
        tracked: bool = False,
        track_threshold: float = 0.5,
        track_topk: int = 4,
        gap_flush: int = 25,
        cut_flush: float = 8.0,
        cut_min: float = 0.02,
    ):
        """``model`` is a ``LipReader`` on its device (as
        ``io.load_release_model`` returns it); ``det``, ``ert`` (the ERT, or
        the conv landmarker's weights with ``preprocess.landmarker=conv``)
        and ``presence`` are the preprocessing weights on that device
        (``io.load_preprocessors``).

        ``tracked`` needs ``presence``. ``gap_flush``: a run of at least
        this many no-face frames is a shot boundary (0 disables).
        ``cut_flush``: a face-to-face frame-signature diff above this many
        times the median of the last 50 within-shot diffs (at least 8 of
        them, and above ``cut_min``) is a hard cut (0 disables)."""
        if cfg.decoder not in ("ctc", "hybrid"):
            raise ValueError(
                "streaming needs a CTC head for alignment commits; "
                f"decoder={cfg.decoder!r}"
            )
        if tracked and presence is None:
            raise ValueError("tracked streaming requires the presence head")
        self.model = model
        self.cfg = cfg
        self.det, self.ert, self.presence = det, ert, presence
        self.device = next(model.parameters()).device
        self.window = window
        self.decode_every = decode_every
        self.chunk_bucket = chunk_bucket
        self.tail_guard = min(tail_guard, window // 2)
        self.context = min(context, window // 4)
        self.vocab = Vocab()
        self._buf: list[torch.Tensor] = []  # ROI frames [R, R] on the device
        self._ctx = 0                       # committed-context prefix length
        self._since_decode = 0
        self.committed = ""
        self.hypothesis = ""
        self.gap_flush = gap_flush
        self._gap = 0                       # consecutive no-face frames seen
        self.cut_flush = cut_flush
        self.cut_min = cut_min
        self._cut_hist: deque = deque(maxlen=50)  # within-shot sig diffs
        self._prev_sig: np.ndarray | None = None  # last frame's signature
        self.cut_events = 0                 # hard-cut flushes fired
        self._tracked = tracked
        self.track_threshold = track_threshold
        self.track_topk = track_topk
        if tracked:
            self._track_state = self._fresh_track_state()
        self.beam = beam
        self.lm_weight = lm_weight
        self._lm = (load_char_lm(self.device)
                    if beam > 1 and lm_weight > 0.0 else None)
        self.counts = dict.fromkeys(
            ("commits", "viterbi", "tail_beam", "segment", "flushes"), 0)

    # ----- preprocessing -----

    def _fresh_track_state(self):
        return (torch.zeros((1,), dtype=torch.bool, device=self.device),
                torch.zeros((1, 3), dtype=torch.float32, device=self.device))

    def _pre_tracked(self, frames: torch.Tensor, have, prev_box):
        """[N, H, W, 3] uint8 -> (ROIs [N, R, R], valid [N], track state):
        top-k candidates gated by the presence head, tracked from the
        carried state, integer mouth boxes."""
        pc = self.cfg.preprocess
        N, H, W, _ = frames.shape
        gray = roi_ops.grayscale(frames)
        feats, head = det_ops.forward_features(
            self.det, roi_ops.resize_frames(gray, det_ops.INPUT))
        pmap = det_ops.presence_logits(self.presence, feats)
        cand, logit_k = det_ops.decode_boxes_topk(head, H, W, self.track_topk,
                                                  pmap)
        conf = torch.sigmoid(logit_k)
        boxes, valid, state = track_boxes(
            cand[None], conf[None], self.track_threshold,
            init_state=(have, prev_box), return_state=True)
        if pc.landmarker == "conv":
            lms = lmk_ops.predict_batch_conv(self.ert, gray, boxes[0])
        else:
            lms = ert_ops.predict_batch(self.ert, gray, boxes[0])
        mboxes = mouth_boxes_from_landmarks(lms, pc.roi_margin, H, W)
        rois = roi_ops.sample_rois(gray, mboxes, pc.roi_size,
                                   mean=pc.normalize_mean,
                                   std=pc.normalize_std)
        return rois, valid[0], state

    @torch.inference_mode()
    def feed(self, frames: np.ndarray) -> str:
        """Append [N, H, W, 3] uint8 frames (numpy); returns the current
        transcript."""
        frames = np.asarray(frames)
        n = frames.shape[0]
        if n == 0:
            return self.hypothesis
        padded = -(-n // self.chunk_bucket) * self.chunk_bucket
        if padded != n:
            frames = np.concatenate(
                [frames, np.repeat(frames[-1:], padded - n, axis=0)])
        if not self._tracked:
            rois = preprocess_frames(
                self.det, self.ert,
                torch.as_tensor(frames, device=self.device),
                self.cfg.preprocess)
            self._buf.extend(rois[:n].unbind(0))
        else:
            n = self._feed_tracked(frames, n)
            if n == 0:
                return self.hypothesis
        self._since_decode += n
        if self._since_decode >= self.decode_every:
            self._since_decode = 0
            self._redecode()
        return self.hypothesis

    def _feed_tracked(self, frames: np.ndarray, n: int) -> int:
        """The live skip-frame semantics of a padded chunk of ``n`` real
        frames, with the gap and hard-cut flushes -> frames buffered."""
        rois, valid, self._track_state = self._pre_tracked(
            torch.as_tensor(frames, device=self.device), *self._track_state)
        rois = rois[:n]
        keep = valid[:n].cpu().numpy().copy()
        cut_d = None
        if self.cut_flush > 0:
            sig = frame_signature(frames[:n])
            prev = sig[:1] if self._prev_sig is None else self._prev_sig[None]
            cut_d = np.abs(np.diff(np.concatenate([prev, sig]), axis=0)
                           ).mean(axis=(1, 2))   # [n]; cut_d[0] spans chunks
            self._prev_sig = sig[-1]
        added = 0
        for i in range(n):
            if cut_d is not None and keep[i] and self._gap == 0:
                # only face-to-face diffs count: a diff into or out of a
                # no-face run is the gap logic's
                d = float(cut_d[i])
                is_cut = len(self._cut_hist) >= 8 and d > max(
                    self.cut_min,
                    self.cut_flush * float(np.median(self._cut_hist)))
                if not is_cut:
                    self._cut_hist.append(d)   # within-shot diffs only
                else:
                    self.cut_events += 1
                    if self._buf:
                        self._flush()
                    self._cut_hist.clear()
                    # re-acquire the track from the cut frame with a fresh
                    # state, padded to the chunk's own shape
                    rest = frames[i:n]
                    if rest.shape[0] < frames.shape[0]:
                        rest = np.concatenate(
                            [rest, np.repeat(rest[-1:],
                                             frames.shape[0] - rest.shape[0],
                                             axis=0)])
                    r2, v2, self._track_state = self._pre_tracked(
                        torch.as_tensor(rest, device=self.device),
                        *self._fresh_track_state())
                    rois[i:n] = r2[:n - i]
                    keep[i:n] = v2[:n - i].cpu().numpy()
            if not keep[i]:
                self._gap += 1
                continue
            if 0 < self.gap_flush <= self._gap and self._buf:
                self._flush()                  # shot boundary
                self._cut_hist.clear()
            self._gap = 0
            self._buf.append(rois[i])
            added += 1
        return added

    # ----- decoding -----

    def _window(self, T: int):
        """The first T buffered frames zero-padded to ``window`` ->
        ([1, W, R, R], lengths [1])."""
        win = torch.stack(self._buf[:T])
        if T < self.window:
            win = F.pad(win, (0, 0, 0, 0, 0, self.window - T))
        return win[None], torch.tensor([T], dtype=torch.int32,
                                       device=self.device)

    def _path(self, T: int) -> np.ndarray:
        """CTC best-path ids of the first T buffered frames."""
        win, length = self._window(T)
        lp = ctc_log_probs(self.model, self.cfg, win, length)
        return torch.argmax(lp, dim=-1)[0, :T].cpu().numpy()

    def _beam_live(self, win, length, ctx: int):
        """(log-probs rolled by -ctx, beam ids, lengths) of the window's
        live suffix [ctx, length)."""
        return self._beam(ctc_log_probs(self.model, self.cfg, win, length),
                          length, ctx)

    def _beam(self, lp, length, ctx: int):
        """The prefix beam over a window's log-probs rolled by -ctx: the
        committed-context frames wrap past length - ctx, where the beam
        masks them -> (rolled log-probs, ids, lengths)."""
        lp = torch.roll(lp, -ctx, dims=1)
        v = self.vocab
        ids, n = ctc_prefix_beam_device(
            lp, length - ctx, self.beam, self.cfg.train.max_decode_len,
            blank=v.blank_id, sos=v.sos_id, eos=v.eos_id, lm=self._lm,
            lm_weight=self.lm_weight)
        return lp, ids, n

    def _force(self, lp, ids, n, length, ctx: int) -> torch.Tensor:
        """The beam's ids without specials, moved to the front in order
        (a stable sort), forced onto the rolled log-probs' frames by
        ``ctc_viterbi_align`` and rolled back by ctx -> [1, W] path; the
        frames before ctx emit blank."""
        v = self.vocab
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        keep = ((ids != v.blank_id) & (ids != v.sos_id) & (ids != v.eos_id)
                & (pos < n[:, None]))
        order = torch.argsort((~keep).int(), dim=1, stable=True)
        labels = torch.gather(ids, 1, order)
        path = ctc_viterbi_align(lp, labels, length - ctx, keep.sum(dim=1),
                                 blank=v.blank_id)
        return torch.roll(path, ctx, dims=1)

    def _beam_aligned_path(self, T: int) -> np.ndarray:
        """Per-frame path of the beam hypothesis for the first T frames."""
        win, length = self._window(T)
        lp, ids, n = self._beam_live(win, length, self._ctx)
        path = self._force(lp, ids, n, length, self._ctx)
        self.counts["viterbi"] += 1
        return path[0, :T].cpu().numpy()

    def _commit_from_window(self) -> None:
        """Commit the stable head of an over-full buffer: cut at the last
        blank run before the tail guard, commit the collapsed text of
        [ctx, cut), keep the trailing ``context`` frames as context."""
        W = self.window
        path = (self._beam_aligned_path(W) if self.beam > 1
                else self._path(W))
        guard = W - self.tail_guard
        is_blank = path[:guard] == self.vocab.blank_id
        is_blank[: self._ctx] = False            # the cut must pass ctx
        run = np.flatnonzero(is_blank[1:] & is_blank[:-1])
        single = np.flatnonzero(is_blank)
        if run.size:
            cut = int(run[-1]) + 1
        elif single.size:
            cut = int(single[-1]) + 1
        else:
            cut = guard
        self.committed += self.vocab.decode_ctc_greedy(path[self._ctx:cut])
        keep = min(self.context, cut)
        del self._buf[: cut - keep]
        self._ctx = keep
        self.counts["commits"] += 1

    def _segment_text(self) -> str | None:
        """Joint-beam decode of the uncommitted suffix (None without an
        attention head, at beam 1, or with nothing live). The suffix is
        padded to the first time bucket that holds it, else to a multiple
        of 16: the conv3d-stem releases pool their norms over the padded
        T."""
        live = len(self._buf) - self._ctx
        if self.beam <= 1 or self.cfg.decoder != "hybrid" or live <= 0:
            return None
        seg = torch.stack(self._buf[self._ctx:])
        T = seg.shape[0]
        fit = [b for b in self.cfg.data.time_buckets if b >= T]
        W = fit[0] if fit else -(-T // 16) * 16
        if T < W:
            seg = F.pad(seg, (0, 0, 0, 0, 0, W - T))
        ids, lens = decode_ids(
            self.model, self.cfg, seg[None],
            torch.tensor([T], dtype=torch.int32, device=self.device),
            self.beam, self.lm_weight, lm=self._lm)
        self.counts["segment"] += 1
        return self.vocab.decode(ids[0, :int(lens[0])].cpu().numpy())

    def _flush(self) -> None:
        """Shot boundary: decode and commit the whole buffer, then reset so
        the next segment never attends across the cut."""
        while len(self._buf) > self.window:
            self._commit_from_window()
        tail = self._segment_text()
        if tail is not None:
            text = self.committed + tail
        else:
            self._redecode()
            text = self.hypothesis
        if text and not text.endswith(" "):
            text += " "                 # a segment boundary is a word's
        self.committed = text
        self.hypothesis = text
        self._buf.clear()
        self._ctx = 0
        self._since_decode = 0
        self.counts["flushes"] += 1

    def _redecode(self) -> None:
        while len(self._buf) > self.window:
            self._commit_from_window()
        T = len(self._buf)
        if self.beam > 1 and T > self._ctx:
            win, length = self._window(T)
            _, ids, n = self._beam_live(win, length, self._ctx)
            tail = self.vocab.decode(ids[0, :int(n[0])].cpu().numpy())
            self.counts["tail_beam"] += 1
        else:
            path = self._path(T)
            tail = self.vocab.decode_ctc_greedy(path[self._ctx:])
        self.hypothesis = self.committed + tail

    @torch.inference_mode()
    def finish(self) -> str:
        """Commit anything over the window and decode the remaining tail
        (the joint beam for hybrid models at beam > 1)."""
        if self._buf:
            while len(self._buf) > self.window:
                self._commit_from_window()
            tail = self._segment_text()
            if tail is not None:
                self.hypothesis = self.committed + tail
            else:
                self._redecode()
        self.hypothesis = self.hypothesis.rstrip()
        return self.hypothesis
