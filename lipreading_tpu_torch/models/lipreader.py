"""The composed lip-reading model (counterpart of ``encode``, ``ctc_logits``
and ``_act_dtype`` in ``lipreading_tpu/models/lipreader.py``).

Ported so far: the patchify stem, the transformer encoder and the CTC head,
for inference. The conv3d stem, the bi-GRU encoder, the attention decoders
and the training losses are later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from lipreading_tpu_torch.config import Config
from lipreading_tpu_torch.models.frontend3d import Patchify
from lipreading_tpu_torch.models.nn import Dense
from lipreading_tpu_torch.models.transformer import TransformerEncoder


def _act_dtype(cfg: Config) -> torch.dtype:
    """Activation type; parameters stay float32."""
    return torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32


class LipReader(nn.Module):
    """Patchify stem -> transformer encoder -> CTC head."""

    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        if m.frontend != "patchify":
            raise NotImplementedError(
                f"frontend {m.frontend!r}: the conv3d stem is a later slice")
        if cfg.encoder != "transformer":
            raise NotImplementedError(
                f"encoder {cfg.encoder!r}: the bi-GRU is a later slice")
        if cfg.decoder not in ("ctc", "hybrid"):
            raise NotImplementedError(
                f"decoder {cfg.decoder!r}: attention decoding is a later slice")
        self.cfg = cfg
        self.frontend = Patchify(m, cfg.preprocess.roi_size)
        self.encoder = TransformerEncoder(m, m.frontend_dim)
        self.ctc_head = Dense(m.tf_dim, m.vocab_size)


def encode(model: LipReader, cfg: Config, rois: torch.Tensor,
           frame_lengths: torch.Tensor, dtype: torch.dtype | None = None):
    """[B, T, R, R] + lengths [B] -> [B, T, D] encoder states."""
    dtype = dtype or _act_dtype(cfg)
    feats = model.frontend(rois, dtype)
    return model.encoder(feats, frame_lengths, dtype)


def ctc_logits(model: LipReader, enc: torch.Tensor,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """[B, T, D] -> [B, T, V] float32 CTC logits."""
    return model.ctc_head(enc, dtype).float()
