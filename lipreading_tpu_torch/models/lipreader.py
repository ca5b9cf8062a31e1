"""The composed lip-reading model and its training losses (counterpart of
``init_model``, ``encode``, ``ctc_logits``, ``attention_logits``,
``cross_entropy_loss``, ``compute_loss`` and ``_act_dtype`` in
``lipreading_tpu/models/lipreader.py``).

Ported so far: the patchify stem, the transformer encoder, the CTC head and
the transformer attention decoder (``decoder="hybrid"``). The conv3d stem,
the bi-GRU encoder and its Bahdanau decoder are later slices.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lipreading_tpu_torch.config import Config
from lipreading_tpu_torch.models import nn as lnn
from lipreading_tpu_torch.models.frontend3d import Patchify
from lipreading_tpu_torch.models.nn import Dense, length_mask
from lipreading_tpu_torch.models.transformer import (
    TransformerDecoder,
    TransformerEncoder,
)
from lipreading_tpu_torch.ops.ctc import ctc_loss_best


def _act_dtype(cfg: Config) -> torch.dtype:
    """Activation type; parameters stay float32."""
    return torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32


class LipReader(nn.Module):
    """Patchify stem -> transformer encoder -> CTC head (and, for
    ``decoder="hybrid"``, the transformer attention decoder)."""

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
                f"decoder {cfg.decoder!r}: a model without the CTC head is a "
                "later slice")
        self.cfg = cfg
        self.frontend = Patchify(m, cfg.preprocess.roi_size)
        self.encoder = TransformerEncoder(m, m.frontend_dim)
        self.ctc_head = Dense(m.tf_dim, m.vocab_size)
        if cfg.decoder == "hybrid":
            self.att_decoder = TransformerDecoder(m)


@torch.no_grad()
def init_params_(model: LipReader, gen: torch.Generator) -> LipReader:
    """Draw ``model``'s parameters in place with the JAX package's
    distributions (``models/nn.py`` inits): dense and conv weights and biases
    uniform in +-1/sqrt(fan_in), the highway gate bias shifted by -2,
    embedding tables standard normal, norms at scale 1 and bias 0, ``pos``
    the sinusoidal table. The values differ from ``jax.random``'s."""
    dev = next(model.parameters()).device

    def uniform_(p, scale):
        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1).mul_(scale))

    for mod in model.modules():
        if isinstance(mod, Dense):
            scale = 1.0 / math.sqrt(mod.w.shape[0])
            uniform_(mod.w, scale)
            uniform_(mod.b, scale)
        elif isinstance(mod, lnn.Conv3d):
            scale = 1.0 / math.sqrt(math.prod(mod.w.shape[:-1]))
            uniform_(mod.w, scale)
            uniform_(mod.b, scale)
        elif isinstance(mod, lnn.Embedding):
            mod.table.copy_(torch.randn(mod.table.shape, generator=gen))
    for mod in model.modules():
        if isinstance(mod, lnn.Highway):
            mod.t.b.sub_(2.0)
    return model.to(dev)


def init_model(cfg: Config, gen: torch.Generator | None = None,
               device: str | torch.device = "cuda") -> LipReader:
    """A freshly initialised ``LipReader`` on ``device``; draws come from
    ``gen`` (a CPU generator; seeded with ``cfg.train.seed`` if None)."""
    gen = gen or torch.Generator().manual_seed(cfg.train.seed)
    return init_params_(LipReader(cfg), gen).to(device)


def encode(model: LipReader, cfg: Config, rois: torch.Tensor,
           frame_lengths: torch.Tensor, dtype: torch.dtype | None = None,
           gen: torch.Generator | None = None):
    """[B, T, R, R] + lengths [B] -> [B, T, D] encoder states; ``gen``
    enables dropout (training), None is deterministic."""
    dtype = dtype or _act_dtype(cfg)
    rate = cfg.model.dropout
    feats = model.frontend(rois, dtype, gen, rate)
    return model.encoder(feats, frame_lengths, dtype, gen, rate)


def ctc_logits(model: LipReader, enc: torch.Tensor,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """[B, T, D] -> [B, T, V] float32 CTC logits."""
    return model.ctc_head(enc, dtype).float()


def attention_logits(model: LipReader, cfg: Config, enc: torch.Tensor,
                     enc_lengths: torch.Tensor, targets: torch.Tensor,
                     dtype: torch.dtype | None = None,
                     gen: torch.Generator | None = None) -> torch.Tensor:
    """Teacher-forced next-token logits [B, L-1, V] for targets [B, L]."""
    dtype = dtype or _act_dtype(cfg)
    return model.att_decoder(targets[:, :-1], enc, enc_lengths, dtype, gen,
                             cfg.model.dropout)


def cross_entropy_loss(logits: torch.Tensor, targets_out: torch.Tensor,
                       target_lengths: torch.Tensor, pad_id: int = 0,
                       sample_weight: torch.Tensor | None = None):
    """Masked mean cross-entropy of logits [B, L-1, V] against
    ``targets_out = targets[:, 1:]``; positions 0..len-2 are real.
    ``sample_weight`` [B] scales each sample's mask (0 drops it)."""
    L = targets_out.shape[1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, targets_out.long()[..., None])[..., 0]
    mask = length_mask(target_lengths - 1, L).float()
    if sample_weight is not None:
        mask = mask * sample_weight.float()[:, None]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def compute_loss(model: LipReader, cfg: Config, batch: dict,
                 train: bool = True, gen: torch.Generator | None = None):
    """The hybrid loss over a batch dict of tensors on the model's device:

        rois           [B, T, R, R]  normalised float32
        frame_lengths  [B]
        targets        [B, L]   sos-framed, eos-terminated, pad after
        target_lengths [B]      includes sos and eos
        ctc_labels     [B, Lc]  bare char ids
        ctc_lengths    [B]
        sample_weight  [B]      optional; 0 drops a sample

    ``gen`` (with ``train``) turns on dropout and the ROI appearance jitter
    (``cfg.train.roi_augment``); None is the JAX package's ``rng=None``.
    Returns (loss, metrics dict of tensors)."""
    t = cfg.train
    rois = batch["rois"]
    if gen is None or not train:
        gen = None
    elif t.roi_augment > 0.0:
        # per-sample gain and bias plus light pixel noise, in normalised units
        a = t.roi_augment
        shp = (rois.shape[0],) + (1,) * (rois.ndim - 1)

        def u(shape):
            return torch.rand(shape, generator=gen, device=rois.device,
                              dtype=rois.dtype) * 2 - 1

        gain = 1.0 + a * u(shp)
        bias = 2.0 * a * u(shp)
        noise = 0.5 * a * torch.randn(rois.shape, generator=gen,
                                      device=rois.device, dtype=rois.dtype)
        rois = rois * gain + bias + noise
    lengths = batch["frame_lengths"]
    enc = encode(model, cfg, rois, lengths, gen=gen)
    metrics = {}
    loss = torch.zeros((), device=enc.device)
    sw = batch.get("sample_weight")
    if cfg.decoder in ("ctc", "hybrid"):
        nll = ctc_loss_best(ctc_logits(model, enc), batch["ctc_labels"],
                            lengths, batch["ctc_lengths"])
        per = nll / torch.clamp(batch["ctc_lengths"].float(), min=1.0)
        if sw is None:
            lc = per.mean()
        else:
            # where() before weighting: an infeasible sample's nll is ~1e30
            per = torch.where(sw > 0, per, 0.0)
            lc = per.sum() / torch.clamp(sw.sum(), min=1.0)
        w = t.ctc_weight if cfg.decoder == "hybrid" else 1.0
        loss = loss + w * lc
        metrics["ctc_loss"] = lc
    if cfg.decoder == "hybrid":
        att = attention_logits(model, cfg, enc, lengths, batch["targets"],
                               gen=gen)
        la = cross_entropy_loss(att, batch["targets"][:, 1:],
                                batch["target_lengths"], sample_weight=sw)
        loss = loss + t.att_weight * la
        metrics["att_loss"] = la
    metrics["loss"] = loss
    return loss, metrics
