"""Ring attention: the transformer encoder with its time axis split over the
mesh's model axis (counterpart of ``lipreading_tpu/parallel/ring.py``).

Each model rank holds one T/n block of the sequence. Everything
position-wise (projection, positions, LayerNorm, MLP, residuals) runs on
the block; self-attention streams the key and value blocks (and the keys'
validity) around the ring with ``comm.ppermute``, n rotations, into an
online-softmax accumulator in float32 (``NEG_INF`` masks, the output
``acc / max(l, 1e-30)``), so no rank holds the [T, T] scores or the whole
sequence. The result is exact attention: equal to the unsharded encoder up
to float rounding. The score products are plain ``torch.einsum``, as the
JAX package computes them outside any Pallas kernel, and autograd through
``ppermute`` gives the backward.

``ring_encoder_apply`` gathers the blocks' outputs along time
(``comm.all_gather``, whose backward hands each rank its block's gradient),
since everything after the encoder runs identically on every model rank.
Under training, the frontend, ``proj``, ``pos`` and the layers see only
their block's gradient on each rank, so ``train/loop.py`` sums them over
the model axis.
"""

from __future__ import annotations

import math

import torch

from lipreading_tpu_torch.models.nn import dropout
from lipreading_tpu_torch.parallel.comm import Axis, all_gather, ppermute
from lipreading_tpu_torch.parallel.mesh import Mesh, rank_generator

NEG_INF = -1e30
RING_STREAM = 0x121C        # the ring's dropout stream, apart from the step's


def ring_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_valid: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Exact attention with the k/v blocks rotating around ``axis``.

    q, k, v: [B, Tl, H, Dh] local blocks; kv_valid: [B, Tl] the local keys'
    validity. Returns [B, Tl, H, Dh] in q's type. The running max m, the
    denominator l and the numerator acc are float32 and are corrected as
    each incoming block raises the max."""
    B, Tl, H, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    m = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, Dh), dtype=torch.float32, device=q.device)
    for _ in range(axis.size):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        s = torch.where(kv_valid[:, None, None, :], s.float(), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype), v).float()
        m = m_new
        k = ppermute(k, axis)
        v = ppermute(v, axis)
        kv_valid = ppermute(kv_valid, axis)
    out = acc / torch.clamp(l, min=1e-30)[..., None]           # [B, H, Tl, Dh]
    return out.transpose(1, 2).to(q.dtype)                     # [B, Tl, H, Dh]


def encoder_block_local(p, x_blk: torch.Tensor, lengths: torch.Tensor,
                        heads: int, axis: Axis, dtype=None,
                        gen: torch.Generator | None = None,
                        rate: float = 0.0) -> torch.Tensor:
    """The encoder on this rank's time block: x_blk [B, Tl, in] at
    positions ``axis.index * Tl`` on, with the keys' validity from the
    global ``lengths`` [B]. ``p`` is a ``TransformerEncoder``."""
    B, Tl, _ = x_blk.shape
    start = axis.index * Tl
    h = p.proj(x_blk, dtype)
    h = h + p.pos[start:start + Tl][None].to(h.dtype)
    gpos = start + torch.arange(Tl, device=x_blk.device)
    kv_valid = gpos[None, :] < lengths.to(x_blk.device)[:, None]
    for lp in p.layers:
        hn = lp.ln1(h)
        ap = lp.attn
        D = hn.shape[-1]
        Dh = D // heads
        q = ap.q(hn, dtype).reshape(B, Tl, heads, Dh)
        k = ap.k(hn, dtype).reshape(B, Tl, heads, Dh)
        v = ap.v(hn, dtype).reshape(B, Tl, heads, Dh)
        attn = ring_attend(q, k, v, kv_valid, axis)
        h = h + dropout(ap.o(attn.reshape(B, Tl, D), dtype), rate, gen)
        h = h + dropout(lp.mlp(lp.ln2(h), dtype), rate, gen)
    return p.ln_out(h)


def data_rows(mesh: Mesh, B: int, local_rows: bool) -> slice | None:
    """The rows of a batch of ``B`` this rank computes, or None when the
    batch replicates over the data axis: ``local_rows`` means the batch is
    already this rank's rows; a global batch splits over the data axis
    when it divides, as the JAX package's ``shard_map`` in_specs do."""
    if mesh.dp == 1 or (not local_rows and B % mesh.dp):
        return None
    if local_rows:
        return slice(0, B)
    n = B // mesh.dp
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def ring_encoder_apply(p, x: torch.Tensor, lengths: torch.Tensor,
                       heads: int, mesh: Mesh, dtype=None,
                       gen: torch.Generator | None = None, rate: float = 0.0,
                       local_rows: bool = False) -> torch.Tensor:
    """Sequence-parallel transformer encoder: [B, T, in] -> the rows this
    rank computes (``data_rows``) as [rows, T, tf_dim], every model rank
    holding the whole T. T must divide by the model axis's size.

    With ``gen`` and ``rate``, dropout draws from a generator seeded from
    ``gen``'s seed, the model index and (when the batch splits over it)
    the data index, as the JAX package folds its key: independent masks per
    block and data shard, not the unsharded encoder's."""
    n = mesh.mp
    B, T, _ = x.shape
    if T % n:
        raise ValueError(f"T={T} not divisible by model size {n}")
    rows = data_rows(mesh, B, local_rows)
    if rows is not None:
        x, lengths = x[rows], lengths[rows]
    g = None
    if gen is not None and rate > 0.0:
        coords = (mesh.model_index,) + (
            (mesh.data_index,) if rows is not None else ())
        g = rank_generator(gen, x.device, RING_STREAM, *coords)
    Tl = T // n
    start = mesh.model_index * Tl
    out = encoder_block_local(p, x[:, start:start + Tl], lengths, heads,
                              mesh.model, dtype, g, rate)
    return all_gather(out, mesh.model, dim=1)
