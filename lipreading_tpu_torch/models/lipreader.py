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

The port alone has the Auto-AVSR family (no JAX counterpart):
``frontend="resnet18"`` (``models/resnet.py``), ``encoder="conformer"``
(``models/conformer.py``, its own transformer decoder), dropout on the CTC
head's input, and ESPnet's losses (``loss="espnet"``): each term over the
number of clips, the decoder's label-smoothed by ``LABEL_SMOOTHING``.
Its BatchNorm layers use the batch's statistics while the model is in
training mode (``nn.Module.train``, the default) and update their running
statistics; ``eval()`` uses the running ones.
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
from lipreading_tpu_torch.models.conformer import (
    AvsrDecoder,
    ConformerEncoder,
    ConvModule,
    RelPosMHA,
)
from lipreading_tpu_torch.models.frontend3d import Frontend3D, Patchify
from lipreading_tpu_torch.models.gru import BiGRU, GRUCell
from lipreading_tpu_torch.models.nn import Dense, dropout, length_mask
from lipreading_tpu_torch.models.resnet import ConvW, ResNet18Trunk
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
        if m.frontend not in ("patchify", "conv3d", "resnet18"):
            raise ValueError(f"unknown frontend {m.frontend!r}")
        if cfg.decoder not in ("ctc", "attention", "hybrid"):
            raise ValueError(f"unknown decoder {cfg.decoder!r}")
        if cfg.loss not in ("mean", "espnet"):
            raise ValueError(f"unknown loss {cfg.loss!r}")
        self.cfg = cfg
        if m.frontend == "resnet18":
            self.frontend = ResNet18Trunk()
        else:
            stem = Patchify if m.frontend == "patchify" else Frontend3D
            self.frontend = stem(m, cfg.preprocess.roi_size)
        feat_dim = (ResNet18Trunk.out_dim if m.frontend == "resnet18"
                    else m.frontend_dim)
        if cfg.encoder == "conformer":
            self.encoder = ConformerEncoder(m, feat_dim)
            enc_dim = m.tf_dim
        elif m.frontend == "resnet18":
            raise ValueError("frontend 'resnet18' needs encoder 'conformer'")
        elif cfg.encoder == "bigru":
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
            if cfg.encoder == "bigru":
                self.att_decoder = AttnDecoder(m, enc_dim)
            elif cfg.encoder == "conformer":
                self.att_decoder = AvsrDecoder(m)
            else:
                self.att_decoder = TransformerDecoder(m)


@torch.no_grad()
def init_params_(model: LipReader, gen: torch.Generator) -> LipReader:
    """Draw ``model``'s parameters in place with the JAX package's
    distributions (``models/nn.py`` and ``models/gru.py`` inits): dense and
    conv weights and biases uniform in +-1/sqrt(fan_in), GRU cells' in
    +-1/sqrt(H), the highway gate bias shifted by -2, embedding tables
    standard normal, norms at scale 1 and bias 0, ``pos`` the sinusoidal
    table. The values differ from ``jax.random``'s. The Auto-AVSR family:
    the trunk's convolutions normal with std sqrt(2 / (kT kH kW Cout)) (the
    ResNet rule), the depthwise convolutions uniform in +-1/sqrt(kernel),
    the relative attention's biases u and v Xavier-uniform, BatchNorm at
    scale 1, bias 0, running mean 0 and variance 1."""
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
        elif isinstance(mod, ConvW):
            std = math.sqrt(2.0 / math.prod(mod.w.shape[:3] + mod.w.shape[4:]))
            mod.w.copy_(torch.randn(mod.w.shape, generator=gen).mul_(std))
        elif isinstance(mod, ConvModule):
            scale = 1.0 / math.sqrt(mod.dw_w.shape[1])
            uniform_(mod.dw_w, scale)
            uniform_(mod.dw_b, scale)
        elif isinstance(mod, RelPosMHA):
            H, Dh = mod.bias_u.shape
            bound = math.sqrt(6.0 / (H + Dh))
            uniform_(mod.bias_u, bound)
            uniform_(mod.bias_v, bound)
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
    if cfg.encoder == "conformer":
        if mp_live:
            raise ValueError("the conformer encoder runs on one device a "
                             "replica (no model mesh axis)")
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


LABEL_SMOOTHING = 0.1    # ESPnet's, as Auto-AVSR trains (``loss="espnet"``)


def label_smoothing_loss(logits: torch.Tensor, targets_out: torch.Tensor,
                         target_lengths: torch.Tensor, smoothing: float,
                         clips: torch.Tensor) -> torch.Tensor:
    """ESPnet's ``LabelSmoothingLoss(normalize_length=False)``: over the
    real positions of logits [B, L-1, V], the KL divergence from the log-
    softmax to the target distribution (1 - ``smoothing`` on the target,
    ``smoothing`` / (V - 1) on each other class), summed and divided by
    ``clips``. It is the smoothed cross-entropy less the target
    distribution's entropy, a constant."""
    V = logits.shape[-1]
    L = targets_out.shape[1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = torch.gather(logp, 2, targets_out.long()[..., None])[..., 0]
    conf, off = 1.0 - smoothing, smoothing / (V - 1)
    kl = -conf * tgt - off * (logp.sum(-1) - tgt)
    if smoothing > 0.0:
        kl = kl + conf * math.log(conf) + smoothing * math.log(off)
    mask = length_mask(target_lengths - 1, L).float()
    return (kl * mask).sum() / clips


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
    clips = None                # ESPnet's denominator: the clips
    if cfg.loss == "espnet":
        n = (torch.tensor(float(enc.shape[0]), device=enc.device)
             if sw is None else sw.float().sum())
        clips = torch.clamp(data_total(n, mesh), min=1.0)
    if cfg.decoder in ("ctc", "hybrid"):
        head_in = enc
        if cfg.encoder == "conformer":
            head_in = dropout(enc, cfg.model.dropout, gen)
        nll = ctc_loss_best(ctc_logits(model, head_in), batch["ctc_labels"],
                            lengths, batch["ctc_lengths"])
        per = nll / torch.clamp(batch["ctc_lengths"].float(), min=1.0)
        if clips is not None:
            lc = (nll if sw is None
                  else torch.where(sw > 0, nll, 0.0)).sum() / clips
        elif sw is None and (mesh is None or mesh.data.group is None):
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
        if clips is not None:
            tl = batch["target_lengths"]
            if sw is not None:
                tl = torch.where(sw > 0, tl, 1)
            la = label_smoothing_loss(att, batch["targets"][:, 1:], tl,
                                      LABEL_SMOOTHING, clips)
        else:
            la = cross_entropy_loss(att, batch["targets"][:, 1:],
                                    batch["target_lengths"],
                                    sample_weight=sw, mesh=mesh)
        w = t.att_weight if cfg.decoder == "hybrid" else 1.0
        loss = loss + w * la
        metrics["att_loss"] = la
    metrics["loss"] = loss
    return loss, metrics
