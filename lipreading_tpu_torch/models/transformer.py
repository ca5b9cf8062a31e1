"""Transformer encoder and decoder (counterpart of ``mha``, ``mha_flash``,
``mlp``, ``encoder_apply``, the teacher-forced ``decoder_apply`` and the
incremental ``decoder_init_cache``, ``decoder_cross_kv`` and ``decoder_step``
in ``lipreading_tpu/models/transformer.py``).

Pre-LN blocks; attention scores in the activation type, cast to float32 for
the ``-1e30`` mask and the softmax, cast back for the weighted sum. With
``flash`` (``cfg.model.flash_attention``) the encoder's self-attention core
runs through the flash kernels instead (``ops/flash_attention.py``: scores
in float32 from the upcast inputs, no [B, H, T, T] buffer), with the
backward that ``flash_bwd`` picks; the projections are the same. The
positional tables ``pos`` are parameters (trained and weight-decayed, as in
the JAX package). Dropout, drawn from an explicit generator, follows every
residual branch in training. The decoder's incremental step reads and
writes a KV cache in the activation type, with the cross-attention K/V
computed once per decode (the beams of ``ops/decode.py`` and
``ops/joint_decode.py`` step it).

Tensor parallelism (``parallel/mesh.py``, training under
``mesh.model_parallel`` > 1 without sequence or pipeline parallelism)
splits ``MHA`` and ``MLP`` in the Megatron layout; without a model axis the
code path is the one-device one. The incremental decoder runs on whole
parameters only.
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
    dense,
    dropout,
    length_mask,
)
from lipreading_tpu_torch.ops.flash_attention import check_bwd, flash_attention
from lipreading_tpu_torch.parallel.comm import copy, psum


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.zeros((max_len, dim), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


def _row_parallel(d: Dense, x: torch.Tensor, dtype, axis) -> torch.Tensor:
    """A dense layer split by input rows over ``axis``: the partial products
    summed over it, then the (replicated) bias added once."""
    y = psum(dense(x, d.w, None, dtype), axis)
    return y + d.b.to(dtype if dtype is not None else y.dtype)


class MHA(nn.Module):
    """Multi-head attention. ``model_axis`` (set by
    ``parallel.mesh.shard_params_``) makes it tensor-parallel: q, k and v
    hold this rank's output columns (its heads), ``o`` its input rows; the
    inputs pass ``copy`` and the output ``psum``. None is one device."""

    model_axis = None

    def __init__(self, dim: int):
        super().__init__()
        self.q, self.k, self.v, self.o = (Dense(dim, dim) for _ in range(4))

    def split(self, q_in, kv_in, heads: int):
        """The inputs as this rank sees them and its number of heads."""
        ax = self.model_axis
        if ax is None:
            return q_in, kv_in, heads
        same = kv_in is q_in
        q_in = copy(q_in, ax)
        kv_in = q_in if same else copy(kv_in, ax)
        return q_in, kv_in, heads // ax.size

    def out(self, x, dtype=None):
        if self.model_axis is None:
            return self.o(x, dtype)
        return _row_parallel(self.o, x, dtype, self.model_axis)

    def forward(self, q_in, kv_in, mask, heads: int, dtype=None):
        """mask: [B, 1, Tq|1, Tk] bool (True = attend)."""
        B, Tq, D = q_in.shape
        Tk = kv_in.shape[1]
        Dh = D // heads
        q_in, kv_in, heads = self.split(q_in, kv_in, heads)
        q = self.q(q_in, dtype).reshape(B, Tq, heads, Dh)
        k = self.k(kv_in, dtype).reshape(B, Tk, heads, Dh)
        v = self.v(kv_in, dtype).reshape(B, Tk, heads, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
        scores = torch.where(mask, scores.float(), -1e30)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Tq, heads * Dh)
        return self.out(out, dtype)


def mha_flash(p: MHA, x: torch.Tensor, lengths: torch.Tensor, heads: int,
              dtype: torch.dtype | None = None,
              bwd: str = "auto") -> torch.Tensor:
    """Encoder self-attention through the flash kernels: ``MHA``'s
    projections around ``flash_attention``'s core (on this rank's heads
    under tensor parallelism); ``bwd`` is its backward policy
    (``cfg.model.flash_bwd``)."""
    B, T, D = x.shape
    Dh = D // heads
    x, _, heads = p.split(x, x, heads)
    q = p.q(x, dtype).reshape(B, T, heads, Dh)
    k = p.k(x, dtype).reshape(B, T, heads, Dh)
    v = p.v(x, dtype).reshape(B, T, heads, Dh)
    lengths = lengths.to(device=x.device, dtype=torch.int32)
    out = flash_attention(q, k, v, lengths, bwd=bwd).reshape(B, T, heads * Dh)
    return p.out(out, dtype)


class MLP(nn.Module):
    """``out(gelu(in(x)))``; under ``model_axis`` ``in`` holds this rank's
    columns and ``out`` its rows, as in ``MHA``."""

    model_axis = None

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        # "in" is the parameter name in the release tree
        self.add_module("in", Dense(dim, hidden))
        self.out = Dense(hidden, dim)

    def forward(self, x, dtype=None):
        ax = self.model_axis
        if ax is not None:
            x = copy(x, ax)
        h = F.gelu(getattr(self, "in")(x, dtype), approximate="tanh")
        if ax is None:
            return self.out(h, dtype)
        return _row_parallel(self.out, h, dtype, ax)


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
                  rate: float = 0.0, flash: bool = False,
                  flash_bwd: str = "auto") -> torch.Tensor:
    """[B, T, in] -> [B, T, tf_dim]; self-attention masked to valid frames;
    dropout on both residual branches when ``gen`` is given. ``flash``
    streams the attention core through the flash kernels, ``flash_bwd``
    picks their backward."""
    B, T, _ = x.shape
    h = p.proj(x, dtype)
    h = h + p.pos[:T][None].to(h.dtype)
    mask = length_mask(lengths, T)[:, None, None, :]
    for lp in p.layers:
        hn = lp.ln1(h)
        attn = (mha_flash(lp.attn, hn, lengths, heads, dtype, flash_bwd)
                if flash else lp.attn(hn, hn, mask, heads, dtype))
        h = h + dropout(attn, rate, gen)
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
        check_bwd(cfg.flash_bwd)
        self.cfg = cfg
        self.proj = Dense(in_dim, cfg.tf_dim)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.tf_layers))
        self.ln_out = LayerNorm(cfg.tf_dim)
        self.pos = nn.Parameter(torch.from_numpy(sinusoidal_positions(1024, cfg.tf_dim)))

    def forward(self, x, lengths, dtype=None, gen=None, rate=0.0,
                flash=False, flash_bwd="auto"):
        return encoder_apply(self, x, lengths, self.cfg.tf_heads, dtype, gen,
                             rate, flash, flash_bwd)


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


def decoder_init_cache(p: TransformerDecoder, batch: int, max_len: int,
                       heads: int, dtype: torch.dtype = torch.float32) -> dict:
    """KV cache for incremental decoding: per layer ``k`` and ``v``
    [B, max_len, H, Dh] in ``dtype``, zero, and the step position ``pos``.

    Every tensor is batch-leading, so the beams gather the whole cache row
    by row (``ops/decode.tree_map``). ``pos`` is a Python int: decoding is
    in lockstep, and an int indexes the cache without a device read (the
    JAX package carries it as a [B] vector that is always uniform)."""
    dim = p.embed.table.shape[1]
    dh = dim // heads
    dev = p.embed.table.device
    return {
        "layers": [
            {"k": torch.zeros((batch, max_len, heads, dh), dtype=dtype,
                              device=dev),
             "v": torch.zeros((batch, max_len, heads, dh), dtype=dtype,
                              device=dev)}
            for _ in p.layers
        ],
        "pos": 0,
    }


def decoder_cross_kv(p: TransformerDecoder, enc: torch.Tensor, heads: int,
                     dtype: torch.dtype | None = None) -> list[dict]:
    """Per-layer cross-attention K/V [B, T, H, Dh] from the encoder output.

    They depend only on ``enc``, so they are computed once per decode, not
    per step; their rows are identical across the beams of one sample (enc
    is tiled by repeat), so the beams never gather them."""
    B, T, D = enc.shape
    dh = D // heads
    return [{"k": lp.cross.k(enc, dtype).reshape(B, T, heads, dh),
             "v": lp.cross.v(enc, dtype).reshape(B, T, heads, dh)}
            for lp in p.layers]


def decoder_step(p: TransformerDecoder, cache: dict, token: torch.Tensor,
                 enc: torch.Tensor, enc_lengths: torch.Tensor, heads: int,
                 dtype: torch.dtype | None = None,
                 cross_kv: list[dict] | None = None):
    """One incremental step: token [B] -> (cache', logits [B, V] float32).

    Self-attention writes this step's K/V into the cache (in the cache's
    type) at ``pos`` and attends over the positions up to it. ``cross_kv``
    (``decoder_cross_kv``) supplies the cross-attention K/V; when None they
    are recomputed from ``enc`` (the same arithmetic). Scores run in the
    activation type and are divided by sqrt(Dh) before the float32 cast and
    the -1e30 mask; the softmax runs in float32 and is cast back."""
    B = token.shape[0]
    T = enc.shape[1]
    dim = p.embed.table.shape[1]
    dh = dim // heads
    pos = cache["pos"]
    maxlen = cache["layers"][0]["k"].shape[1]
    scale = math.sqrt(dh)

    h = p.embed(token, dtype) * math.sqrt(enc.shape[-1])
    h = h + p.pos[pos].to(h.dtype)
    h = h[:, None, :]                                       # [B, 1, D]
    enc_mask = length_mask(enc_lengths, T)[:, None, None, :]
    pos_mask = (torch.arange(maxlen, device=h.device)
                <= pos)[None, None, None, :]               # [1, 1, 1, maxlen]
    new_layers = []
    for li, (lp, lc) in enumerate(zip(p.layers, cache["layers"])):
        sp = getattr(lp, "self")
        hn = lp.ln1(h)
        q = sp.q(hn, dtype).reshape(B, 1, heads, dh)
        k_all, v_all = lc["k"].clone(), lc["v"].clone()
        k_all[:, pos] = sp.k(hn, dtype).reshape(B, heads, dh).to(k_all.dtype)
        v_all[:, pos] = sp.v(hn, dtype).reshape(B, heads, dh).to(v_all.dtype)
        new_layers.append({"k": k_all, "v": v_all})
        scores = torch.einsum("bqhd,bkhd->bhqk", q,
                              k_all.to(q.dtype)) / scale
        scores = torch.where(pos_mask, scores.float(), -1e30)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", w, v_all.to(q.dtype))
        h = h + sp.o(attn.reshape(B, 1, dim), dtype)
        if cross_kv is None:
            h = h + lp.cross(lp.ln2(h), enc, enc_mask, heads, dtype)
        else:
            cp = lp.cross
            qc = cp.q(lp.ln2(h), dtype).reshape(B, 1, heads, dh)
            kc, vc = cross_kv[li]["k"], cross_kv[li]["v"]
            sc = torch.einsum("bqhd,bkhd->bhqk", qc, kc.to(qc.dtype)) / scale
            sc = torch.where(enc_mask, sc.float(), -1e30)
            wc = torch.softmax(sc, dim=-1).to(qc.dtype)
            ac = torch.einsum("bhqk,bkhd->bqhd", wc, vc.to(qc.dtype))
            h = h + cp.o(ac.reshape(B, 1, dim), dtype)
        h = h + lp.mlp(lp.ln3(h), dtype)
    h = p.ln_out(h)
    logits = p.out(h, dtype)[:, 0, :].float()
    return {"layers": new_layers, "pos": pos + 1}, logits
