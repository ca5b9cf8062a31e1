"""Transformer encoder and decoder (counterpart of ``mha``, ``mlp``, the
non-flash branch of ``encoder_apply`` and the teacher-forced
``decoder_apply`` in ``lipreading_tpu/models/transformer.py``).

Pre-LN blocks; attention scores in the activation type, cast to float32 for
the ``-1e30`` mask and the softmax, cast back for the weighted sum. The
positional tables ``pos`` are parameters (trained and weight-decayed, as in
the JAX package). Dropout, drawn from an explicit generator, follows every
residual branch in training. The decoder's incremental step with a KV cache
belongs to the joint beam, a later slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lipreading_tpu_torch.config import ModelConfig
from lipreading_tpu_torch.models.nn import (
    Dense,
    Embedding,
    LayerNorm,
    dropout,
    length_mask,
)


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.zeros((max_len, dim), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


class MHA(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (Dense(dim, dim) for _ in range(4))

    def forward(self, q_in, kv_in, mask, heads: int, dtype=None):
        """mask: [B, 1, Tq|1, Tk] bool (True = attend)."""
        B, Tq, D = q_in.shape
        Tk = kv_in.shape[1]
        Dh = D // heads
        q = self.q(q_in, dtype).reshape(B, Tq, heads, Dh)
        k = self.k(kv_in, dtype).reshape(B, Tk, heads, Dh)
        v = self.v(kv_in, dtype).reshape(B, Tk, heads, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
        scores = torch.where(mask, scores.float(), -1e30)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Tq, D)
        return self.o(out, dtype)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # "in" is the parameter name in the release tree
        self.add_module("in", Dense(dim, hidden))
        self.out = Dense(hidden, dim)

    def forward(self, x, dtype=None):
        h = F.gelu(getattr(self, "in")(x, dtype), approximate="tanh")
        return self.out(h, dtype)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.tf_dim)
        self.attn = MHA(cfg.tf_dim)
        self.ln2 = LayerNorm(cfg.tf_dim)
        self.mlp = MLP(cfg.tf_dim, cfg.tf_mlp)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.tf_dim)
        # "self" is the parameter name in the release tree
        self.add_module("self", MHA(cfg.tf_dim))
        self.ln2 = LayerNorm(cfg.tf_dim)
        self.cross = MHA(cfg.tf_dim)
        self.ln3 = LayerNorm(cfg.tf_dim)
        self.mlp = MLP(cfg.tf_dim, cfg.tf_mlp)


def encoder_apply(p: "TransformerEncoder", x: torch.Tensor,
                  lengths: torch.Tensor, heads: int,
                  dtype: torch.dtype | None = None,
                  gen: torch.Generator | None = None,
                  rate: float = 0.0) -> torch.Tensor:
    """[B, T, in] -> [B, T, tf_dim]; self-attention masked to valid frames;
    dropout on both residual branches when ``gen`` is given."""
    B, T, _ = x.shape
    h = p.proj(x, dtype)
    h = h + p.pos[:T][None].to(h.dtype)
    mask = length_mask(lengths, T)[:, None, None, :]
    for lp in p.layers:
        hn = lp.ln1(h)
        h = h + dropout(lp.attn(hn, hn, mask, heads, dtype), rate, gen)
        h = h + dropout(lp.mlp(lp.ln2(h), dtype), rate, gen)
    return p.ln_out(h)


def decoder_apply(p: "TransformerDecoder", targets_in: torch.Tensor,
                  enc: torch.Tensor, enc_lengths: torch.Tensor, heads: int,
                  dtype: torch.dtype | None = None,
                  gen: torch.Generator | None = None,
                  rate: float = 0.0) -> torch.Tensor:
    """Teacher-forced pass: [B, L] ids -> [B, L, V] float32 next-token
    logits; causal self-attention, cross-attention to the valid frames of
    ``enc``; dropout on the three residual branches when ``gen`` is given."""
    B, L = targets_in.shape
    T = enc.shape[1]
    h = p.embed(targets_in, dtype) * math.sqrt(enc.shape[-1])
    h = h + p.pos[:L][None].to(h.dtype)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=h.device))[None, None]
    enc_mask = length_mask(enc_lengths, T)[:, None, None, :]
    for lp in p.layers:
        hn = lp.ln1(h)
        h = h + dropout(getattr(lp, "self")(hn, hn, causal, heads, dtype),
                        rate, gen)
        h = h + dropout(lp.cross(lp.ln2(h), enc, enc_mask, heads, dtype),
                        rate, gen)
        h = h + dropout(lp.mlp(lp.ln3(h), dtype), rate, gen)
    h = p.ln_out(h)
    return p.out(h, dtype).float()


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, in_dim: int):
        super().__init__()
        if cfg.flash_attention:
            raise NotImplementedError(
                "flash attention is a later slice of the port")
        self.cfg = cfg
        self.proj = Dense(in_dim, cfg.tf_dim)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.tf_layers))
        self.ln_out = LayerNorm(cfg.tf_dim)
        self.pos = nn.Parameter(torch.from_numpy(sinusoidal_positions(1024, cfg.tf_dim)))

    def forward(self, x, lengths, dtype=None, gen=None, rate=0.0):
        return encoder_apply(self, x, lengths, self.cfg.tf_heads, dtype, gen,
                             rate)


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.tf_dim)
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.tf_dec_layers))
        self.ln_out = LayerNorm(cfg.tf_dim)
        self.out = Dense(cfg.tf_dim, cfg.vocab_size)
        self.pos = nn.Parameter(torch.from_numpy(
            sinusoidal_positions(1024, cfg.tf_dim)))

    def forward(self, targets_in, enc, enc_lengths, dtype=None, gen=None,
                rate=0.0):
        return decoder_apply(self, targets_in, enc, enc_lengths,
                             self.cfg.tf_heads, dtype, gen, rate)
