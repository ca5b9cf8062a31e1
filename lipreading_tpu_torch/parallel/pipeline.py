"""GPipe pipeline parallelism for the transformer encoder (counterpart of
``lipreading_tpu/parallel/pipeline.py``).

The mesh's model axis carries S stages: stage s holds encoder layers
[s L/S, (s+1) L/S) and the batch splits into M microbatches. The JAX
package's schedule, tick for tick: M + S - 1 ticks; at tick t stage 0 takes
microbatch ``clip(t)``, stage s works on microbatch ``clip(t - s)``, its
output goes to stage s + 1 by ``comm.ppermute`` (every tick, on every
stage), and outputs are recorded from tick S - 1 on. At the end the last
stage's outputs reach every stage by a masked ``comm.psum``. The
projection, the positions and ``ln_out`` run outside the pipeline on every
stage. Autograd through the ticks is the backward pipeline (ppermute's
backward is the inverse shift).

Every stage computes every tick, the bubble too, as the SPMD program does:
each rank's autograd graph is then the same shape, so every collective's
backward runs on every rank in one order. Stage 0 takes its input through
``torch.where`` for the same reason. The pipeline's input passes
``comm.copy``, so each stage holds the whole gradient of the frontend,
``proj`` and ``pos`` (as JAX's transpose of a replicated input sums it);
each layer's gradient lives on its stage alone, and ``train/loop.py`` sums
the layers over the model axis.

``flash=True`` runs each stage's attention through the port's flash
kernels (``models.transformer.mha_flash``) with ``flash_bwd``.
"""

from __future__ import annotations

import torch

from lipreading_tpu_torch.models.nn import dropout, length_mask
from lipreading_tpu_torch.models.transformer import mha_flash
from lipreading_tpu_torch.parallel.comm import copy, ppermute, psum
from lipreading_tpu_torch.parallel.mesh import Mesh, rank_generator
from lipreading_tpu_torch.parallel.ring import data_rows

PIPE_STREAM = 0x919E        # the pipeline's dropout stream


def stage_apply(layers, h, mask, lengths, heads: int, dtype=None,
                gen: torch.Generator | None = None, rate: float = 0.0,
                flash: bool = False, flash_bwd: str = "auto"):
    """This stage's layers on h: ``models.transformer.encoder_apply``'s loop
    body (pre-LN attention and MLP residual blocks)."""
    for lp in layers:
        hn = lp.ln1(h)
        if flash:
            attn = mha_flash(lp.attn, hn, lengths, heads, dtype, flash_bwd)
        else:
            attn = lp.attn(hn, hn, mask, heads, dtype)
        h = h + dropout(attn, rate, gen)
        h = h + dropout(lp.mlp(lp.ln2(h), dtype), rate, gen)
    return h


def pipeline_encoder_apply(p, x: torch.Tensor, lengths: torch.Tensor,
                           heads: int, mesh: Mesh, dtype=None,
                           microbatches: int = 0,
                           gen: torch.Generator | None = None,
                           rate: float = 0.0, flash: bool = False,
                           flash_bwd: str = "auto",
                           local_rows: bool = False) -> torch.Tensor:
    """Pipeline-parallel transformer encoder: [B, T, in] -> the rows this
    rank computes (``ring.data_rows``) as [rows, T, tf_dim]. tf_layers must
    divide by the stages and the rows by ``microbatches`` (default S).

    With ``gen`` and ``rate``, each tick's dropout draws from a generator
    seeded from ``gen``'s seed, the stage, the tick and (when the batch
    splits over it) the data index: independent masks per layer,
    microbatch and data shard, not the unsharded encoder's."""
    S = mesh.mp
    L = len(p.layers)
    if L % S:
        raise ValueError(f"tf_layers={L} not divisible by pipe stages {S}")
    rows = data_rows(mesh, x.shape[0], local_rows)
    if rows is not None:
        x, lengths = x[rows], lengths[rows]
    Bl, T, _ = x.shape
    M = microbatches or S
    if Bl % M:
        raise ValueError(f"local batch {Bl} not divisible by microbatches "
                         f"{M}")
    mb = Bl // M
    s = mesh.model_index
    Ll = L // S
    layers = list(p.layers)[s * Ll:(s + 1) * Ll]
    train = gen is not None and rate > 0.0

    h0 = p.proj(x, dtype)
    h0 = copy(h0 + p.pos[:T][None].to(h0.dtype), mesh.model)
    D = h0.shape[-1]
    x_mb = h0.reshape(M, mb, T, D)
    len_mb = lengths.reshape(M, mb)
    first = torch.tensor(s == 0, device=x.device)
    last = torch.tensor(s == S - 1, device=x.device)
    buf = torch.zeros_like(x_mb[0])
    ys = [None] * M
    for t in range(M + S - 1):
        buf = torch.where(first, x_mb[min(t, M - 1)], buf)
        l_cur = len_mb[min(max(t - s, 0), M - 1)]
        mask = None if flash else length_mask(l_cur, T)[:, None, None, :]
        g = None
        if train:
            coords = (s, t) + ((mesh.data_index,) if rows is not None else ())
            g = rank_generator(gen, x.device, PIPE_STREAM, *coords)
        out = stage_apply(layers, buf, mask, l_cur, heads, dtype, g, rate,
                          flash, flash_bwd)
        if t >= S - 1:
            ys[t - (S - 1)] = out
        buf = ppermute(out, mesh.model, 1)
    ys = torch.stack(ys)
    ys = psum(torch.where(last, ys, torch.zeros_like(ys)), mesh.model)
    return p.ln_out(ys.reshape(Bl, T, D))
