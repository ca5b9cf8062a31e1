"""The Conformer encoder and the transformer decoder of the Auto-AVSR
family (``encoder="conformer"``; Gulati et al. 2020, arXiv:2005.08100, as
ESPnet writes it and Auto-AVSR trains it, arXiv:2303.14307). No JAX
counterpart.

Encoder, from the trunk's [B, T, 512]:

    x = drop(embed(x) * sqrt(d))
    P = drop(the relative sinusoids of T-1 .. -(T-1))
    each block:  x += 1/2 drop(FFN(LN x));   x += drop(MHSA_rel(LN x, P))
                 x += drop(Conv(LN x));      x += 1/2 drop(FFN'(LN x))
                 x = LN x
    x = LN x

    FFN      = W2 drop(swish(W1 .)), d -> ff -> d
    MHSA_rel = softmax_masked([(q + u) k^T + rel_shift((q + v) (W_pos P)^T)]
               / sqrt(Dh)), attention dropout, . V, W_o (Transformer-XL's
               relative attention, ESPnet's RelPositionMultiHeadedAttention)
    Conv     = pointwise d -> 2d, GLU, the padded frames zeroed, depthwise
               conv of ``CONV_KERNEL`` (same padding), BatchNorm over
               all B T rows, swish, pointwise d -> d

The decoder: pre-LN transformer layers (causal self-attention,
cross-attention to the valid frames, ReLU FFN), the token embedding times
sqrt(d) plus fixed sinusoidal absolute positions, a final LN and the output
layer. Dropout at ``rate`` sits where ESPnet's does: on the scaled
embedding and the positions, the FFNs' hidden units, the attention weights,
each residual branch (and, in ``lipreader.compute_loss``, the CTC head's
input). Every mask is drawn from the step's generator in the forward's
order (``nn.dropout``). LayerNorm eps 1e-12 as ESPnet's.

Traced (``profiling``): the device spans ``model.conformer`` over the
blocks, ``conformer.attn`` over each block's attention (projections to
W_o, the positional term and ``rel_shift`` included) and
``conformer.conv`` over each convolution module.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lipreading_tpu_torch import profiling
from lipreading_tpu_torch.config import ModelConfig
from lipreading_tpu_torch.models.nn import (
    BatchNorm,
    Dense,
    Embedding,
    LayerNorm,
    dropout,
    length_mask,
)
from lipreading_tpu_torch.models.transformer import MHA

EPS = 1e-12
CONV_KERNEL = 31        # the depthwise convolution's taps, Auto-AVSR's


def _ln(dim: int) -> LayerNorm:
    return LayerNorm(dim, EPS)


def _sinusoids(positions: np.ndarray, dim: int) -> torch.Tensor:
    """[n] positions -> [n, dim] float32: sin at even, cos at odd columns of
    position x 10000^(-2i/dim)."""
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * np.float32(-math.log(10000.0) / dim))
    ang = positions.astype(np.float32)[:, None] * div[None, :]
    out = np.zeros((len(positions), dim), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


def rel_positions(T: int, dim: int) -> torch.Tensor:
    """The relative encodings of positions T-1, T-2, ..., -(T-1):
    [2T-1, dim]."""
    return _sinusoids(np.arange(T - 1, -T, -1), dim)


def abs_positions(L: int, dim: int) -> torch.Tensor:
    """The absolute encodings of positions 0 .. L-1: [L, dim]."""
    return _sinusoids(np.arange(L), dim)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[..., T, 2T-1] scores against the positions T-1 .. -(T-1) ->
    [..., T, T] with out[..., i, j] = x[..., i, T-1-i+j], the score of the
    relative position i - j (a strided view of ``x`` made contiguous)."""
    T, P = x.shape[-2:]
    x = x.contiguous()
    lead = x.shape[:-2]
    strides = tuple(x.stride()[:-2]) + (P - 1, 1)
    return x.as_strided((*lead, T, T), strides, x.storage_offset() + T - 1)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, Dh]."""
    B, T, D = x.shape
    return x.reshape(B, T, heads, D // heads).transpose(1, 2)


def _attend(q, k, v, mask, extra, gen, rate):
    """softmax over the keys of (q k^T + extra) / sqrt(Dh), keys outside
    ``mask`` at -1e30 in float32, attention dropout, times v: [B, H, Tq,
    Dh] each -> [B, Tq, H Dh]."""
    s = q @ k.transpose(-1, -2)
    if extra is not None:
        s = s + extra
    s = s / math.sqrt(q.shape[-1])
    w = torch.softmax(torch.where(mask, s.float(), -1e30), dim=-1)
    w = dropout(w.to(q.dtype), rate, gen)
    out = w @ v
    B, H, T, Dh = out.shape
    return out.transpose(1, 2).reshape(B, T, H * Dh)


def mha(p: MHA, q_in, kv_in, mask, heads, dtype=None, gen=None, rate=0.0):
    """Multi-head attention with attention-weight dropout (the decoder's)."""
    q = _heads(p.q(q_in, dtype), heads)
    k = _heads(p.k(kv_in, dtype), heads)
    v = _heads(p.v(kv_in, dtype), heads)
    return p.o(_attend(q, k, v, mask, None, gen, rate), dtype)


class RelPosMHA(MHA):
    """``MHA``'s projections, the positional projection ``pos`` (no bias)
    and the per-head biases ``bias_u`` and ``bias_v`` [H, Dh]."""

    def __init__(self, dim: int, heads: int):
        super().__init__(dim)
        self.pos = Dense(dim, dim, bias=False)
        self.bias_u = nn.Parameter(torch.zeros(heads, dim // heads))
        self.bias_v = nn.Parameter(torch.zeros(heads, dim // heads))

    def forward(self, x, pos, mask, heads, dtype=None, gen=None, rate=0.0):
        """x [B, T, D], pos [1, 2T-1, D] -> [B, T, D]."""
        q = self.q(x, dtype)
        B, T, D = q.shape
        q = q.reshape(B, T, heads, D // heads)
        k = _heads(self.k(x, dtype), heads)
        v = _heads(self.v(x, dtype), heads)
        p = _heads(self.pos(pos, dtype), heads)              # [1, H, 2T-1, Dh]
        qu = (q + self.bias_u.to(q.dtype)).transpose(1, 2)
        qv = (q + self.bias_v.to(q.dtype)).transpose(1, 2)
        bd = rel_shift(qv @ p.transpose(-1, -2))
        return self.o(_attend(qu, k, v, mask, bd, gen, rate), dtype)


class FFN(nn.Module):
    """``w2(drop(act(w1 x)))``."""

    def __init__(self, dim: int, hidden: int, act):
        super().__init__()
        self.w1 = Dense(dim, hidden)
        self.w2 = Dense(hidden, dim)
        self.act = act

    def forward(self, x, dtype=None, gen=None, rate=0.0):
        return self.w2(dropout(self.act(self.w1(x, dtype)), rate, gen), dtype)


class ConvModule(nn.Module):
    """The convolution module (the module doc): ``dw_w`` [D, K] and
    ``dw_b`` [D] the depthwise convolution's."""

    def __init__(self, dim: int, kernel: int):
        super().__init__()
        self.pw1 = Dense(dim, 2 * dim)
        self.dw_w = nn.Parameter(torch.zeros(dim, kernel))
        self.dw_b = nn.Parameter(torch.zeros(dim))
        self.bn = BatchNorm(dim)
        self.pw2 = Dense(dim, dim)

    def forward(self, x, valid, dtype=None):
        h = F.glu(self.pw1(x, dtype), dim=-1)
        h = torch.where(valid[..., None], h, 0.0)
        K = self.dw_w.shape[1]
        h = F.conv1d(h.transpose(1, 2), self.dw_w.to(h.dtype)[:, None],
                     self.dw_b.to(h.dtype), padding=K // 2,
                     groups=h.shape[-1]).transpose(1, 2)
        return self.pw2(F.silu(self.bn(h)), dtype)


class ConformerBlock(nn.Module):
    def __init__(self, m: ModelConfig):
        super().__init__()
        D = m.tf_dim
        self.ln_ffm = _ln(D)
        self.ffm = FFN(D, m.tf_mlp, F.silu)
        self.ln_mha = _ln(D)
        self.attn = RelPosMHA(D, m.tf_heads)
        self.ln_conv = _ln(D)
        self.conv = ConvModule(D, CONV_KERNEL)
        self.ln_ff = _ln(D)
        self.ff = FFN(D, m.tf_mlp, F.silu)
        self.ln_out = _ln(D)

    def forward(self, x, pos, mask, valid, heads, dtype=None, gen=None,
                rate=0.0):
        x = x + 0.5 * dropout(self.ffm(self.ln_ffm(x), dtype, gen, rate),
                              rate, gen)
        with profiling.span("conformer.attn", device=True):
            a = self.attn(self.ln_mha(x), pos, mask, heads, dtype, gen, rate)
        x = x + dropout(a, rate, gen)
        with profiling.span("conformer.conv", device=True):
            c = self.conv(self.ln_conv(x), valid, dtype)
        x = x + dropout(c, rate, gen)
        x = x + 0.5 * dropout(self.ff(self.ln_ff(x), dtype, gen, rate),
                              rate, gen)
        return self.ln_out(x)


class ConformerEncoder(nn.Module):
    def __init__(self, m: ModelConfig, in_dim: int):
        super().__init__()
        self.cfg = m
        self.embed = Dense(in_dim, m.tf_dim)
        self.blocks = nn.ModuleList(ConformerBlock(m)
                                    for _ in range(m.tf_layers))
        self.ln_out = _ln(m.tf_dim)

    def forward(self, feats, lengths, dtype=None, gen=None, rate=0.0):
        """[B, T, in] + lengths [B] -> [B, T, tf_dim]."""
        D = self.cfg.tf_dim
        x = dropout(self.embed(feats, dtype) * math.sqrt(D), rate, gen)
        T = x.shape[1]
        pos = rel_positions(T, D).to(device=x.device, dtype=x.dtype)[None]
        pos = dropout(pos, rate, gen)
        valid = length_mask(lengths.to(x.device), T)
        mask = valid[:, None, None, :]
        with profiling.span("model.conformer", device=True):
            for blk in self.blocks:
                x = blk(x, pos, mask, valid, self.cfg.tf_heads, dtype, gen,
                        rate)
        return self.ln_out(x)


class DecoderLayer(nn.Module):
    def __init__(self, m: ModelConfig):
        super().__init__()
        D = m.tf_dim
        self.ln1 = _ln(D)
        # "self" as the transformer decoder's layers name it
        self.add_module("self", MHA(D))
        self.ln2 = _ln(D)
        self.cross = MHA(D)
        self.ln3 = _ln(D)
        self.ffn = FFN(D, m.tf_mlp, torch.relu)


class AvsrDecoder(nn.Module):
    def __init__(self, m: ModelConfig):
        super().__init__()
        self.cfg = m
        self.embed = Embedding(m.vocab_size, m.tf_dim)
        self.layers = nn.ModuleList(DecoderLayer(m)
                                    for _ in range(m.tf_dec_layers))
        self.ln_out = _ln(m.tf_dim)
        self.out = Dense(m.tf_dim, m.vocab_size)

    def forward(self, targets_in, enc, enc_lengths, dtype=None, gen=None,
                rate=0.0):
        """Teacher-forced: [B, L] ids -> [B, L, V] float32 logits."""
        B, L = targets_in.shape
        D, heads = self.cfg.tf_dim, self.cfg.tf_heads
        h = self.embed(targets_in, dtype) * math.sqrt(D)
        h = dropout(h + abs_positions(L, D).to(device=h.device,
                                               dtype=h.dtype), rate, gen)
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=h.device))
        emask = length_mask(enc_lengths.to(h.device),
                            enc.shape[1])[:, None, None, :]
        for lp in self.layers:
            hn = lp.ln1(h)
            h = h + dropout(mha(getattr(lp, "self"), hn, hn, causal, heads,
                                dtype, gen, rate), rate, gen)
            h = h + dropout(mha(lp.cross, lp.ln2(h), enc, emask, heads,
                                dtype, gen, rate), rate, gen)
            h = h + dropout(lp.ffn(lp.ln3(h), dtype, gen, rate), rate, gen)
        return self.out(self.ln_out(h), dtype).float()
