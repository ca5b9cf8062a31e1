"""The composed lip-reading model and its training losses (counterpart of
``init_model``, ``encode``, ``ctc_logits``, ``attention_logits``,
``cross_entropy_loss``, ``compute_loss`` and ``_act_dtype`` in
``lipreading_tpu/models/lipreader.py``).

Every family of the JAX package's ``init_model``:

    frontend="patchify" | "conv3d"  the visual stem (``train.remat``
                                    recomputes it in the backward)
    encoder="transformer" | "bigru" the encoder
    decoder="ctc"                   the CTC head
    decoder="attention"             the attention decoder alone
    decoder="hybrid"                both, loss ctc_weight * CTC +
                                    att_weight * cross-entropy

The attention decoder is the Bahdanau GRU decoder (``models/attention.py``)
after the bi-GRU and the transformer decoder after the transformer. Over a
mesh of ranks (``parallel/mesh.py``) ``encode`` routes the transformer
encoder through ring attention or the GPipe pipeline, and each loss
divides by its global denominator (``data_total``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lipreading_tpu_torch import profiling
from lipreading_tpu_torch.config import Config
from lipreading_tpu_torch.models import nn as lnn
from lipreading_tpu_torch.models.attention import (
    AttnDecoder,
    teacher_forced_logits,
)
from lipreading_tpu_torch.models.frontend3d import Frontend3D, Patchify
from lipreading_tpu_torch.models.gru import BiGRU, GRUCell
from lipreading_tpu_torch.models.nn import Dense, length_mask
from lipreading_tpu_torch.models.transformer import (
    TransformerDecoder,
    TransformerEncoder,
)
from lipreading_tpu_torch.ops.ctc import ctc_loss_best
from lipreading_tpu_torch.parallel.comm import all_reduce_


def _act_dtype(cfg: Config) -> torch.dtype:
    """Activation type; parameters stay float32."""
    return torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32


class LipReader(nn.Module):
    """Stem -> encoder -> CTC head and/or attention decoder, as ``cfg``
    names them (the module doc)."""

    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        if m.frontend not in ("patchify", "conv3d"):
            raise ValueError(f"unknown frontend {m.frontend!r}")
        if cfg.decoder not in ("ctc", "attention", "hybrid"):
            raise ValueError(f"unknown decoder {cfg.decoder!r}")
        self.cfg = cfg
        stem = Patchify if m.frontend == "patchify" else Frontend3D
        self.frontend = stem(m, cfg.preprocess.roi_size)
        if cfg.encoder == "bigru":
            self.encoder = BiGRU(m.frontend_dim, m.gru_hidden, m.gru_layers)
            enc_dim = 2 * m.gru_hidden
        elif cfg.encoder == "transformer":
            self.encoder = TransformerEncoder(m, m.frontend_dim)
            enc_dim = m.tf_dim
        else:
            raise ValueError(f"unknown encoder {cfg.encoder!r}")
        if cfg.decoder in ("ctc", "hybrid"):
            self.ctc_head = Dense(enc_dim, m.vocab_size)
        if cfg.decoder in ("attention", "hybrid"):
            self.att_decoder = (AttnDecoder(m, enc_dim)
                                if cfg.encoder == "bigru"
                                else TransformerDecoder(m))


@torch.no_grad()
def init_params_(model: LipReader, gen: torch.Generator) -> LipReader:
    """Draw ``model``'s parameters in place with the JAX package's
    distributions (``models/nn.py`` and ``models/gru.py`` inits): dense and
    conv weights and biases uniform in +-1/sqrt(fan_in), GRU cells' in
    +-1/sqrt(H), the highway gate bias shifted by -2, embedding tables
    standard normal, norms at scale 1 and bias 0, ``pos`` the sinusoidal
    table. The values differ from ``jax.random``'s."""
    dev = next(model.parameters()).device

    def uniform_(p, scale):
        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1).mul_(scale))

    for mod in model.modules():
        if isinstance(mod, Dense):
            scale = 1.0 / math.sqrt(mod.w.shape[0])
            uniform_(mod.w, scale)
            if mod.b is not None:
                uniform_(mod.b, scale)
        elif isinstance(mod, GRUCell):
            scale = 1.0 / math.sqrt(mod.w_hh.shape[0])
            for p in (mod.w_ih, mod.w_hh, mod.b_ih, mod.b_hh):
                uniform_(p, scale)
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


def _frontend_remat(model: LipReader, rois: torch.Tensor,
                    dtype: torch.dtype, gen: torch.Generator | None,
                    rate: float) -> torch.Tensor:
    """The frontend under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward instead of held (``train.remat``). The
    dropout masks come from ``gen``, which ``preserve_rng_state`` does not
    restore; so the recompute replays ``gen`` from the state the forward
    started at, and puts back the state it found."""
    from torch.utils.checkpoint import checkpoint

    start = gen.get_state() if gen is not None else None
    ran = []

    def run(r):
        if start is None or not ran:
            ran.append(True)
            return model.frontend(r, dtype, gen, rate)
        held = gen.get_state()
        gen.set_state(start)
        try:
            return model.frontend(r, dtype, gen, rate)
        finally:
            gen.set_state(held)

    return checkpoint(run, rois, use_reentrant=False,
                      preserve_rng_state=False)


def encode(model: LipReader, cfg: Config, rois: torch.Tensor,
           frame_lengths: torch.Tensor, dtype: torch.dtype | None = None,
           gen: torch.Generator | None = None, mesh=None):
    """[B, T, R, R] + lengths [B] -> [B, T, D] encoder states; ``gen``
    enables dropout (training), None is deterministic. The transformer
    encoder's attention takes the flash kernels when
    ``cfg.model.flash_attention`` is set, with the backward
    ``cfg.model.flash_bwd``; ``cfg.train.remat`` recomputes the frontend in
    the backward.

    ``mesh`` (a ``parallel.mesh.Mesh``; the rois are this rank's rows)
    routes the transformer encoder as the JAX package does when the model
    axis is larger than 1: ``cfg.mesh.pipeline_parallel`` through the GPipe
    encoder (``parallel/pipeline.py``), ``cfg.mesh.sequence_parallel``
    through ring attention (``parallel/ring.py``), the two exclusive and
    both refused by the bi-GRU; otherwise the plain encoder (tensor
    parallel when its layers carry the model axis).

    Traced (``profiling``): the span ``model.encode``, the device span
    ``model.stem`` over the frontend and, with gradients enabled, the
    device span ``model.stem_backward`` from the frontend output's
    gradient to ``profiling.backward_done()``."""
    with profiling.span("model.encode"):
        return _encode(model, cfg, rois, frame_lengths, dtype, gen, mesh)


def _encode(model, cfg, rois, frame_lengths, dtype, gen, mesh):
    dtype = dtype or _act_dtype(cfg)
    rate = cfg.model.dropout
    with profiling.span("model.stem", device=True):
        if cfg.train.remat and torch.is_grad_enabled():
            feats = _frontend_remat(model, rois, dtype, gen, rate)
        else:
            feats = model.frontend(rois, dtype, gen, rate)
    profiling.backward_span(feats, "model.stem_backward")
    mp_live = mesh is not None and mesh.mp > 1
    sp = mp_live and cfg.mesh.sequence_parallel
    pp = mp_live and cfg.mesh.pipeline_parallel
    if sp and pp:
        raise ValueError(
            "sequence_parallel and pipeline_parallel are exclusive uses "
            "of the model mesh axis"
        )
    if cfg.encoder == "bigru":
        if sp or pp:
            raise ValueError(
                "sequence/pipeline parallelism requires the transformer "
                "encoder (the bi-GRU is sequential over time)"
            )
        return model.encoder(feats, frame_lengths, dtype, gen, rate)
    m = cfg.model
    if pp:
        from lipreading_tpu_torch.parallel.pipeline import (
            pipeline_encoder_apply,
        )

        return pipeline_encoder_apply(
            model.encoder, feats, frame_lengths, m.tf_heads, mesh, dtype,
            microbatches=cfg.mesh.pipeline_microbatches, gen=gen, rate=rate,
            flash=m.flash_attention, flash_bwd=m.flash_bwd, local_rows=True)
    if sp:
        from lipreading_tpu_torch.parallel.ring import ring_encoder_apply

        return ring_encoder_apply(model.encoder, feats, frame_lengths,
                                  m.tf_heads, mesh, dtype, gen=gen,
                                  rate=rate, local_rows=True)
    return model.encoder(feats, frame_lengths, dtype, gen, rate,
                         flash=m.flash_attention, flash_bwd=m.flash_bwd)


def ctc_logits(model: LipReader, enc: torch.Tensor,
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """[B, T, D] -> [B, T, V] float32 CTC logits."""
    return model.ctc_head(enc, dtype).float()


def attention_logits(model: LipReader, cfg: Config, enc: torch.Tensor,
                     enc_lengths: torch.Tensor, targets: torch.Tensor,
                     dtype: torch.dtype | None = None,
                     gen: torch.Generator | None = None) -> torch.Tensor:
    """Teacher-forced next-token logits [B, L-1, V] for targets [B, L];
    the Bahdanau decoder samples its own predictions at
    ``cfg.train.teacher_forcing`` < 1 (with ``gen``)."""
    dtype = dtype or _act_dtype(cfg)
    if cfg.encoder == "bigru":
        return teacher_forced_logits(
            model.att_decoder, enc, enc_lengths, targets, dtype,
            cfg.train.teacher_forcing, gen)
    return model.att_decoder(targets[:, :-1], enc, enc_lengths, dtype, gen,
                             cfg.model.dropout)


def data_total(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` summed over the mesh's data axis (a loss's denominator: the
    global count of a batch split over the data ranks); ``x`` itself
    without a process group."""
    if mesh is None or mesh.data.group is None:
        return x
    return all_reduce_(x.detach().clone(), mesh.data)


def cross_entropy_loss(logits: torch.Tensor, targets_out: torch.Tensor,
                       target_lengths: torch.Tensor, pad_id: int = 0,
                       sample_weight: torch.Tensor | None = None,
                       mesh=None):
    """Masked mean cross-entropy of logits [B, L-1, V] against
    ``targets_out = targets[:, 1:]``; positions 0..len-2 are real.
    ``sample_weight`` [B] scales each sample's mask (0 drops it). Under a
    ``mesh`` the denominator is the global count of target tokens (this
    rank's share of the global mean)."""
    L = targets_out.shape[1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 2, targets_out.long()[..., None])[..., 0]
    mask = length_mask(target_lengths - 1, L).float()
    if sample_weight is not None:
        mask = mask * sample_weight.float()[:, None]
    return (nll * mask).sum() / torch.clamp(data_total(mask.sum(), mesh),
                                            min=1.0)


def compute_loss(model: LipReader, cfg: Config, batch: dict,
                 train: bool = True, gen: torch.Generator | None = None,
                 mesh=None):
    """The model's loss over a batch dict of tensors on the model's device:

        rois           [B, T, R, R]  normalised float32
        frame_lengths  [B]
        targets        [B, L]   sos-framed, eos-terminated, pad after
        target_lengths [B]      includes sos and eos
        ctc_labels     [B, Lc]  bare char ids
        ctc_lengths    [B]
        sample_weight  [B]      optional; 0 drops a sample

    ``gen`` (with ``train``) turns on dropout and the ROI appearance jitter
    (``cfg.train.roi_augment``); None is the JAX package's ``rng=None``.
    ``mesh`` (the batch is then this rank's rows) routes the encoder
    (``encode``) and divides each mean by its global denominator (target
    tokens, samples or sample weights summed over the data axis): the loss
    is this rank's share of the global batch's, so the sum of the ranks'
    gradients is its gradient. Returns (loss, metrics dict of tensors)."""
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
    enc = encode(model, cfg, rois, lengths, gen=gen, mesh=mesh)
    metrics = {}
    loss = torch.zeros((), device=enc.device)
    sw = batch.get("sample_weight")
    if cfg.decoder in ("ctc", "hybrid"):
        nll = ctc_loss_best(ctc_logits(model, enc), batch["ctc_labels"],
                            lengths, batch["ctc_lengths"])
        per = nll / torch.clamp(batch["ctc_lengths"].float(), min=1.0)
        if sw is None and (mesh is None or mesh.data.group is None):
            lc = per.mean()
        elif sw is None:
            lc = per.sum() / data_total(
                torch.tensor(float(per.shape[0]), device=per.device), mesh)
        else:
            # where() before weighting: an infeasible sample's nll is ~1e30
            per = torch.where(sw > 0, per, 0.0)
            lc = per.sum() / torch.clamp(data_total(sw.sum(), mesh), min=1.0)
        w = t.ctc_weight if cfg.decoder == "hybrid" else 1.0
        loss = loss + w * lc
        metrics["ctc_loss"] = lc
    if cfg.decoder in ("attention", "hybrid"):
        att = attention_logits(model, cfg, enc, lengths, batch["targets"],
                               gen=gen)
        la = cross_entropy_loss(att, batch["targets"][:, 1:],
                                batch["target_lengths"], sample_weight=sw,
                                mesh=mesh)
        w = t.att_weight if cfg.decoder == "hybrid" else 1.0
        loss = loss + w * la
        metrics["att_loss"] = la
    metrics["loss"] = loss
    return loss, metrics
