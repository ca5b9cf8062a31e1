"""Inference: the greedy leg of cascade decoding (counterpart of the body of
``_greedy_conf_jit`` in ``lipreading_tpu/infer.py``).

``greedy_conf`` encodes, takes the float32 CTC log-probabilities, their mean
top1 - top2 margin over valid frames (the cascade's confidence) and the
greedy ids from the CTC-greedy kernel. ``transcribe_greedy`` runs uint8
frames through preprocessing and ``greedy_conf`` to strings, and flags the
clips whose confidence is below ``margin``: those are the clips the cascade
would send on to the joint beam, which is a later slice of this package.
"""

from __future__ import annotations

import numpy as np
import torch

from lipreading_tpu_torch.config import Config
from lipreading_tpu_torch.models.lipreader import (
    LipReader,
    _act_dtype,
    ctc_logits,
    encode,
)
from lipreading_tpu_torch.models.nn import length_mask
from lipreading_tpu_torch.ops.decode import ctc_greedy_ids
from lipreading_tpu_torch.ops.preprocess import preprocess_clips
from lipreading_tpu_torch.text import Vocab


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
