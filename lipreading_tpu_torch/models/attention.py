"""The Bahdanau GRU attention decoder of the bi-GRU family (counterpart of
``lipreading_tpu/models/attention.py``).

A step: embedding -> attention over the encoder states (two products and a
masked softmax) -> a GRU cell over [embedding, context] -> logits from
[h, context]. The scores go to float32 for the ``-1e30`` mask and the
softmax, and the weights back to the encoder's type for the weighted sum.
Teacher-forced training steps the whole target sequence; scheduled sampling
(``teacher_forcing < 1``) draws a coin per sample and step from the step's
``torch.Generator`` (other coins than ``jax.random``'s). The beams of
``ops/decode.py`` and ``ops/joint_decode.py`` step ``decoder_step``.
"""

from __future__ import annotations

import torch
from torch import nn

from lipreading_tpu_torch.config import ModelConfig
from lipreading_tpu_torch.models.gru import GRUCell, gru_cell_step
from lipreading_tpu_torch.models.nn import Dense, Embedding, length_mask


class AttnDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig, enc_dim: int):
        super().__init__()
        H, A, V = cfg.decoder_hidden, cfg.attn_dim, cfg.vocab_size
        self.embed = Embedding(V, H)
        self.attn_enc = Dense(enc_dim, A, bias=False)
        self.attn_dec = Dense(H, A)
        self.attn_v = Dense(A, 1, bias=False)
        self.gru = GRUCell(H + enc_dim, H)
        self.out = Dense(H + enc_dim, V)


def precompute_attention(p: AttnDecoder, enc: torch.Tensor,
                         dtype: torch.dtype | None = None) -> torch.Tensor:
    """The encoder side of the scores, once per sequence: [B, T, A]."""
    return p.attn_enc(enc, dtype)


def attend(p: AttnDecoder, h: torch.Tensor, enc: torch.Tensor,
           enc_proj: torch.Tensor, enc_mask: torch.Tensor,
           dtype: torch.dtype | None = None):
    """Scores ``v^T tanh(W_e enc + W_d h)`` -> (context [B, D], weights
    [B, T] in the encoder's type)."""
    q = p.attn_dec(h, dtype)                                # [B, A]
    e = torch.tanh(enc_proj + q[:, None, :])                # [B, T, A]
    scores = p.attn_v(e, dtype)[..., 0]                     # [B, T]
    scores = torch.where(enc_mask, scores.float(), -1e30)
    w = torch.softmax(scores, dim=-1).to(enc.dtype)
    ctx = torch.einsum("bt,btd->bd", w, enc)
    return ctx, w


def decoder_step(p: AttnDecoder, h: torch.Tensor, token: torch.Tensor,
                 enc: torch.Tensor, enc_proj: torch.Tensor,
                 enc_mask: torch.Tensor, dtype: torch.dtype | None = None):
    """One autoregressive step -> (h', float32 logits [B, V])."""
    emb = p.embed(token, dtype)                             # [B, H]
    ctx, _ = attend(p, h, enc, enc_proj, enc_mask, dtype)
    x = torch.cat([emb, ctx], dim=-1)
    g = p.gru
    w_ih = g.w_ih if dtype is None else g.w_ih.to(dtype)
    b_ih = g.b_ih if dtype is None else g.b_ih.to(dtype)
    h = gru_cell_step(g, h, x @ w_ih + b_ih, dtype)
    logits = p.out(torch.cat([h, ctx], dim=-1), dtype)
    return h, logits.float()


def teacher_forced_logits(p: AttnDecoder, enc: torch.Tensor,
                          enc_lengths: torch.Tensor, targets: torch.Tensor,
                          dtype: torch.dtype | None = None,
                          teacher_forcing: float = 1.0,
                          gen: torch.Generator | None = None) -> torch.Tensor:
    """Encoder states [B, T, D] and sos-framed targets [B, L] -> next-token
    logits [B, L-1, V] (positions 1..L-1).

    With ``teacher_forcing < 1`` and a ``gen``, each sample of each step
    feeds its own previous argmax instead of the target with probability
    ``1 - teacher_forcing``; the previous prediction of step 0 is token 0,
    as in the JAX package. The coins are drawn only then."""
    B, T, _ = enc.shape
    enc_mask = length_mask(enc_lengths.to(enc.device), T)
    enc_proj = precompute_attention(p, enc, dtype)
    H = p.gru.w_hh.shape[0]
    h = torch.zeros(B, H, dtype=enc.dtype, device=enc.device)
    use_ss = teacher_forcing < 1.0 and gen is not None
    pred = torch.zeros(B, dtype=targets.dtype, device=targets.device)
    out = []
    for i in range(targets.shape[1] - 1):
        tok = targets[:, i]
        if use_ss:
            coin = torch.rand(B, generator=gen, device=enc.device)
            tok = torch.where(coin < teacher_forcing, tok, pred)
        h, logits = decoder_step(p, h, tok, enc, enc_proj, enc_mask, dtype)
        pred = logits.argmax(dim=-1).to(targets.dtype)
        out.append(logits)
    return torch.stack(out, dim=1)
