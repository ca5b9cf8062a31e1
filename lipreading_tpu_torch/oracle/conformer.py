"""Plain reference of the Auto-AVSR visual speech recogniser (Ma et al.
2023, arXiv:2303.14307; the architecture of arXiv:2202.13084): the
ResNet-18 trunk, the Conformer encoder with relative-position attention,
the CTC head, the transformer decoder and the hybrid loss, forward and
gradients (by autograd), in float32 with TF32 off. Plain ``torch``
operations in PyTorch's own layouts (NCDHW, NCHW, [B, C, T]); it imports
no kernel and no module of the port, and nothing of JAX.

It reads a flat dict ``P`` of parameters and BatchNorm buffers keyed as
the port's ``state_dict`` keys them ("encoder.blocks.0.attn.q.w"; dense
weights [in, out], convolution weights [kT, kH, kW, Cin, Cout]) and the
configuration as a dict (``Config.to_dict()``). The equations:

* trunk: conv3d 5x7x7 stride (1, 2, 2) pad (2, 3, 3), BatchNorm, swish,
  max pool 3x3 stride 2 pad 1 on each frame; ResNet-18 BasicBlocks
  [2, 2, 2, 2] of 64 .. 512 channels, strides 1, 2, 2, 2, each conv
  followed by BatchNorm, swish after the first and after the sum, a 1x1
  conv and BatchNorm on the shortcut where the shape changes; the mean
  over each frame's 3x3 positions;
* encoder: Linear 512 -> d, times sqrt(d), dropout; the sinusoids of the
  relative positions T-1 .. -(T-1), dropout (one mask for the batch); each
  block x += 1/2 FFN(LN x), x += MHSA_rel(LN x), x += Conv(LN x), x += 1/2
  FFN(LN x), x = LN x, each branch followed by dropout; a final LN.
  FFN = W2 drop(swish(W1 x)). MHSA_rel: scores = [(q + u) k^T + S] /
  sqrt(Dh) with S[i, j] = ((q_i + v) . (W_pos p))[T-1-i+j], the relative
  position i - j taken by an explicit index (ESPnet's ``rel_shift``
  reshapes instead), keys past the length at -1e30, softmax, dropout of
  the weights, times V, W_o. Conv: pointwise d -> 2d, GLU, padded frames
  zeroed, depthwise conv (same padding), BatchNorm over the B T rows,
  swish, pointwise d -> d. LayerNorm eps 1e-12;
* CTC head on drop(encoder output); decoder: the token embedding times
  sqrt(d) plus sinusoids of positions 0 .. L-1, dropout; pre-LN layers of
  causal self-attention, cross-attention to the valid frames (weights
  dropped out) and a ReLU FFN, each branch dropped out; LN, output layer;
* loss: ctc_weight x CTC + att_weight x label-smoothed KL, each summed
  over the batch and divided by the number of clips (ESPnet's ``CTC`` and
  ``LabelSmoothingLoss(normalize_length=False)``).

BatchNorm normalises with the batch's statistics (population variance,
eps 1e-5) and returns the running statistics a step leaves (momentum 0.1,
the variance unbiased), as ``torch.nn.BatchNorm*`` in training mode.

Departures from the published model: the padded frames are zeroed before
the depthwise convolution (the public code is not in the repository to
confirm how it treats them) and enter every BatchNorm's statistics;
dropout masks come from an explicit generator in the forward's order
(``Draws``); no time masking (augmentation)."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
LN_EPS = 1e-12
BN_EPS = 1e-5
SMOOTHING = 0.1         # ESPnet's label smoothing, as Auto-AVSR trains
MOMENTUM = 0.1


class Plain:
    """float32 with TF32 off (the reference's arithmetic)."""

    def q(self, t):
        return t

    @contextlib.contextmanager
    def flags(self):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev


class Draws:
    """Dropout at ``rate`` from ``gen``: keep where a uniform draw is below
    1 - rate, the kept values scaled by 1 / (1 - rate). A batched mask is
    drawn at all ``B`` rows and ``rows`` of it kept; ``shared`` draws one
    mask of the tensor's own shape (the positions')."""

    def __init__(self, gen: torch.Generator, rate: float, B: int, rows=None):
        self.gen, self.rate, self.B, self.rows = gen, rate, B, rows

    def _apply(self, x, shape, rows):
        if self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(shape, generator=self.gen, device=x.device) < keep
        if rows is not None:
            mask = mask[rows]
        return torch.where(mask, x / keep, 0.0)

    def __call__(self, x):
        return self._apply(x, (self.B,) + tuple(x.shape[1:]), self.rows)

    def shared(self, x):
        return self._apply(x, tuple(x.shape), None)


class _NoDrop:
    def __call__(self, x):
        return x

    shared = __call__


def dense(P, name, x, prec):
    y = prec.q(x) @ prec.q(P[f"{name}.w"])
    b = P.get(f"{name}.b")
    return y if b is None else y + b


def layernorm(P, name, x):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * P[f"{name}.scale"] \
        + P[f"{name}.bias"]


def batchnorm(P, stats, name, x, dim):
    """BatchNorm of ``x`` over its channel axis ``dim``; the running
    statistics it leaves go into ``stats``."""
    xc = x.movedim(dim, -1)
    flat = xc.reshape(-1, xc.shape[-1])
    mean = flat.mean(0)
    var = ((flat - mean) ** 2).mean(0)
    y = (xc - mean) / torch.sqrt(var + BN_EPS) * P[f"{name}.scale"] \
        + P[f"{name}.bias"]
    n = flat.shape[0]
    stats[f"{name}.mean"] = ((1 - MOMENTUM) * P[f"{name}.mean"]
                             + MOMENTUM * mean.detach())
    stats[f"{name}.var"] = ((1 - MOMENTUM) * P[f"{name}.var"]
                            + MOMENTUM * var.detach() * n / (n - 1))
    return y.movedim(-1, dim)


def swish(x):
    return x * torch.sigmoid(x)


def _conv2d(P, name, x, prec, stride, pad):
    """x [N, Cin, H, W]; weight [1, kH, kW, Cin, Cout]."""
    w = P[f"{name}.w"][0].permute(3, 2, 0, 1)
    return F.conv2d(prec.q(x), prec.q(w), stride=stride, padding=pad)


def _stem(P, rois, prec, stats):
    B, T = rois.shape[:2]
    w = P["frontend.conv0.w"].permute(4, 3, 0, 1, 2)
    x = F.conv3d(prec.q(rois[:, None]), prec.q(w), stride=(1, 2, 2),
                 padding=(2, 3, 3))
    x = swish(batchnorm(P, stats, "frontend.bn0", x, 1))
    x = x.transpose(1, 2).flatten(0, 1)                 # [B T, C, H, W]
    return F.max_pool2d(x, 3, 2, 1)


def _block(P, n, x, s, prec, stats):
    h = swish(batchnorm(P, stats, f"{n}.bn1",
                        _conv2d(P, f"{n}.conv1", x, prec, s, 1), 1))
    h = batchnorm(P, stats, f"{n}.bn2",
                  _conv2d(P, f"{n}.conv2", h, prec, 1, 1), 1)
    if f"{n}.down.w" in P:
        x = batchnorm(P, stats, f"{n}.down_bn",
                      _conv2d(P, f"{n}.down", x, prec, s, 0), 1)
    return swish(h + x)


def trunk(P, rois, prec, stats):
    """[B, T, R, R] -> [B, T, 512]. The stem and each block run under
    ``torch.utils.checkpoint`` (recomputed in the backward, the same
    arithmetic), so that the float32 activations of a batch of 8,192
    frames fit on one card."""
    from torch.utils.checkpoint import checkpoint

    B, T = rois.shape[:2]
    x = checkpoint(_stem, P, rois, prec, stats, use_reentrant=False)
    for i, stride in enumerate((1, 2, 2, 2)):
        for j in range(2):
            x = checkpoint(_block, P, f"frontend.layers.{i}.{j}", x,
                           stride if j == 0 else 1, prec, stats,
                           use_reentrant=False)
    return x.mean(dim=(2, 3)).reshape(B, T, -1)


def sinusoids(positions, dim, device):
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / dim))
    pos = torch.as_tensor(np.asarray(positions), dtype=torch.float32)
    ang = pos[:, None] * div[None]
    out = torch.zeros((len(positions), dim))
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out.to(device)


def _split(x, heads):
    B, T, D = x.shape
    return x.reshape(B, T, heads, D // heads).transpose(1, 2)


def _weights(s, mask, drop):
    return drop(torch.softmax(torch.where(mask, s, NEG), dim=-1))


def _merge(o):
    B, H, T, Dh = o.shape
    return o.transpose(1, 2).reshape(B, T, H * Dh)


def rel_attention(P, name, x, pos, mask, heads, prec, drop):
    """x [B, T, D], pos [1, 2T-1, D] -> [B, T, D]."""
    T = x.shape[1]
    q = _split(dense(P, f"{name}.q", x, prec), heads)
    k = _split(dense(P, f"{name}.k", x, prec), heads)
    v = _split(dense(P, f"{name}.v", x, prec), heads)
    p = _split(dense(P, f"{name}.pos", pos, prec), heads)
    u = P[f"{name}.bias_u"][None, :, None]
    vb = P[f"{name}.bias_v"][None, :, None]
    ac = (q + u) @ k.transpose(-1, -2)
    full = (q + vb) @ p.transpose(-1, -2)                  # [B, H, T, 2T-1]
    i = torch.arange(T, device=x.device)
    idx = (T - 1) - i[:, None] + i[None, :]                # position i - j
    bd = full[:, :, i[:, None], idx]
    w = _weights((ac + bd) / math.sqrt(q.shape[-1]), mask, drop)
    return dense(P, f"{name}.o", _merge(w @ v), prec)


def attention(P, name, q_in, kv_in, mask, heads, prec, drop):
    q = _split(dense(P, f"{name}.q", q_in, prec), heads)
    k = _split(dense(P, f"{name}.k", kv_in, prec), heads)
    v = _split(dense(P, f"{name}.v", kv_in, prec), heads)
    w = _weights(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), mask,
                 drop)
    return dense(P, f"{name}.o", _merge(w @ v), prec)


def ffn(P, name, x, prec, act, drop):
    return dense(P, f"{name}.w2",
                 drop(act(dense(P, f"{name}.w1", x, prec))), prec)


def conv_module(P, name, x, valid, prec, stats):
    h = dense(P, f"{name}.pw1", x, prec)
    a, b = h.chunk(2, dim=-1)
    h = (a * torch.sigmoid(b)) * valid[..., None]
    w = P[f"{name}.dw_w"]
    h = F.conv1d(prec.q(h.transpose(1, 2)), prec.q(w[:, None]),
                 P[f"{name}.dw_b"], padding=w.shape[1] // 2,
                 groups=w.shape[0])
    h = swish(batchnorm(P, stats, f"{name}.bn", h, 1)).transpose(1, 2)
    return dense(P, f"{name}.pw2", h, prec)


def key_mask(lengths, T):
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths[:, None])


def encode(P, cfg, rois, lengths, prec, drop, stats):
    """[B, T, R, R] normalised ROIs + lengths -> [B, T, d]."""
    m = cfg["model"]
    D, H = m["tf_dim"], m["tf_heads"]
    x = dense(P, "encoder.embed", trunk(P, rois, prec, stats), prec)
    x = drop(x * math.sqrt(D))
    T = x.shape[1]
    pos = drop.shared(sinusoids(range(T - 1, -T, -1), D, x.device)[None])
    valid = key_mask(lengths, T)
    mask = valid[:, None, None, :]
    for i in range(m["tf_layers"]):
        n = f"encoder.blocks.{i}"
        x = x + 0.5 * drop(ffn(P, f"{n}.ffm", layernorm(P, f"{n}.ln_ffm", x),
                               prec, swish, drop))
        x = x + drop(rel_attention(P, f"{n}.attn",
                                   layernorm(P, f"{n}.ln_mha", x), pos, mask,
                                   H, prec, drop))
        x = x + drop(conv_module(P, f"{n}.conv",
                                 layernorm(P, f"{n}.ln_conv", x), valid,
                                 prec, stats))
        x = x + 0.5 * drop(ffn(P, f"{n}.ff", layernorm(P, f"{n}.ln_ff", x),
                               prec, swish, drop))
        x = layernorm(P, f"{n}.ln_out", x)
    return layernorm(P, "encoder.ln_out", x)


def ctc_logits(P, enc, prec, drop):
    return dense(P, "ctc_head", drop(enc), prec)


def decoder_logits(P, cfg, tokens, enc, enc_lengths, prec, drop):
    """Teacher-forced: tokens [B, L] (sos first) -> [B, L, V] logits."""
    m = cfg["model"]
    D, H = m["tf_dim"], m["tf_heads"]
    L = tokens.shape[1]
    h = F.embedding(tokens.long(), P["att_decoder.embed.table"]) \
        * math.sqrt(D) + sinusoids(range(L), D, enc.device)
    h = drop(h)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=h.device))
    emask = key_mask(enc_lengths, enc.shape[1])[:, None, None, :]
    for i in range(m["tf_dec_layers"]):
        n = f"att_decoder.layers.{i}"
        hn = layernorm(P, f"{n}.ln1", h)
        h = h + drop(attention(P, f"{n}.self", hn, hn, causal, H, prec,
                               drop))
        h = h + drop(attention(P, f"{n}.cross", layernorm(P, f"{n}.ln2", h),
                               enc, emask, H, prec, drop))
        h = h + drop(ffn(P, f"{n}.ffn", layernorm(P, f"{n}.ln3", h), prec,
                         torch.relu, drop))
    return dense(P, "att_decoder.out", layernorm(P, "att_decoder.ln_out", h),
                 prec)


def smoothed_kl(logits, targets_out, target_lengths, smoothing):
    """Summed over the real positions: KL(target distribution || softmax),
    the target distribution 1 - smoothing on the target and smoothing /
    (V - 1) on each other class."""
    V = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    td = torch.full_like(logp, smoothing / (V - 1))
    td.scatter_(2, targets_out.long()[..., None], 1.0 - smoothing)
    kl = (torch.xlogy(td, td) - td * logp).sum(-1)
    L = targets_out.shape[1]
    mask = key_mask(target_lengths - 1, L)
    return (kl * mask).sum()


def losses(P, cfg, batch, prec=None, rows=None, draws=None):
    """-> (loss, CTC loss, decoder loss, the BatchNorm running statistics
    the step leaves) of ``batch`` (tensors: normalised ``rois``,
    ``frame_lengths``, ``targets``, ``target_lengths``, ``ctc_labels``,
    ``ctc_lengths``); ``rows`` keeps those rows; ``draws`` (a ``Draws``
    over all the batch's rows) drops out."""
    if cfg.get("loss") != "espnet":
        raise ValueError("the reference computes ESPnet's losses "
                         "(loss 'espnet')")
    prec = prec or Plain()
    b = batch if rows is None else {k: v[rows] for k, v in batch.items()}
    drop = draws if draws is not None else _NoDrop()
    t = cfg["train"]
    lens = b["frame_lengths"].long()
    stats: dict = {}
    enc = encode(P, cfg, b["rois"], lens, prec, drop, stats)
    clips = float(enc.shape[0])
    lp = torch.log_softmax(ctc_logits(P, enc, prec, drop), dim=-1)
    nll = F.ctc_loss(lp.transpose(0, 1), b["ctc_labels"].long(), lens,
                     b["ctc_lengths"].long(), blank=0, reduction="none")
    lc = nll.sum() / clips
    tg = b["targets"].long()
    logits = decoder_logits(P, cfg, tg[:, :-1], enc, lens, prec, drop)
    la = smoothed_kl(logits, tg[:, 1:], b["target_lengths"].long(),
                     SMOOTHING) / clips
    return t["ctc_weight"] * lc + t["att_weight"] * la, lc, la, stats
