"""GRU layers (counterpart of ``gru_cell_step``, ``gru_layer`` and ``bigru``
in ``lipreading_tpu/models/gru.py``).

The input projection of every step is one [B*T, in] @ [in, 3H] product; the
loop carries only the [B, H] @ [H, 3H] recurrence. The gates are the
PyTorch/cuDNN variant, with the (r, z, n) blocks along the 3H axis:

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

Every op of the step is its own op in the activation type, in this order,
so a bf16 step rounds where the JAX package's does (``torch.nn.GRU`` and
cuDNN compute ``n + z * (h - n)`` and round elsewhere). ``BiGRU`` runs the
two directions of a layer together: one batched product a step over the
stacked [2, B, H] states, the backward direction on the sequences reversed
within their lengths (``flip_sequences``). Each step is a dozen small
launches on the card; the recurrence is launch-bound.
"""

from __future__ import annotations

import torch
from torch import nn

from lipreading_tpu_torch.models.nn import dropout, flip_sequences


class GRUCell(nn.Module):
    """Parameters of one GRU direction: ``w_ih`` [in, 3H], ``w_hh`` [H, 3H],
    ``b_ih`` and ``b_hh`` [3H]."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.zeros(in_dim, 3 * hidden))
        self.w_hh = nn.Parameter(torch.zeros(hidden, 3 * hidden))
        self.b_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.b_hh = nn.Parameter(torch.zeros(3 * hidden))


def _cast(t: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def gate_update(h: torch.Tensor, x_proj: torch.Tensor,
                h_proj: torch.Tensor) -> torch.Tensor:
    """The gates of one step from the input and state projections [..., 3H]
    -> h' [..., H]."""
    H = h.shape[-1]
    xr, xz, xn = x_proj.split(H, dim=-1)
    hr, hz, hn = h_proj.split(H, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_cell_step(cell: GRUCell, h: torch.Tensor, x_proj: torch.Tensor,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """One step from the precomputed ``x_proj = x @ w_ih + b_ih`` [B, 3H]
    and the state h [B, H] -> h'."""
    h_proj = h @ _cast(cell.w_hh, dtype) + _cast(cell.b_hh, dtype)
    return gate_update(h, x_proj, h_proj)


def _recurrence(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                h: torch.Tensor):
    """Steps D stacked directions at once: input projections xp [D, T, B,
    3H], w_hh [D, H, 3H], b_hh [D, 1, 3H], states h [D, B, H] -> (every
    step's state [D, B, T, H], the last state)."""
    ys = []
    for t in range(xp.shape[1]):
        h = gate_update(h, xp[:, t], torch.bmm(h, w_hh) + b_hh)
        ys.append(h)
    return torch.stack(ys, dim=2), h


def gru_layer(cell: GRUCell, x: torch.Tensor, h0: torch.Tensor | None = None,
              dtype: torch.dtype | None = None):
    """One direction over [B, T, in] -> ([B, T, H], the last state [B, H])."""
    B, H = x.shape[0], cell.w_hh.shape[0]
    x_proj = x @ _cast(cell.w_ih, dtype) + _cast(cell.b_ih, dtype)
    h = torch.zeros(B, H, dtype=x.dtype, device=x.device) if h0 is None else h0
    ys, h = _recurrence(x_proj.transpose(0, 1)[None],
                        _cast(cell.w_hh, dtype)[None],
                        _cast(cell.b_hh, dtype)[None, None], h[None])
    return ys[0], h[0]


def bidirectional_layer(fwd: GRUCell, bwd: GRUCell, x: torch.Tensor,
                        lengths: torch.Tensor,
                        dtype: torch.dtype | None = None) -> torch.Tensor:
    """Both directions of one layer over [B, T, in] -> [B, T, 2H]: the
    forward one over x, the backward one over ``flip_sequences(x)`` and its
    output flipped back. The two recurrences step together as one batched
    product over the stacked states."""
    B, H = x.shape[0], fwd.w_hh.shape[0]
    rev = flip_sequences(x, lengths)
    xp = torch.stack([x @ _cast(fwd.w_ih, dtype) + _cast(fwd.b_ih, dtype),
                      rev @ _cast(bwd.w_ih, dtype) + _cast(bwd.b_ih, dtype)])
    y, _ = _recurrence(
        xp.transpose(1, 2), _cast(torch.stack([fwd.w_hh, bwd.w_hh]), dtype),
        _cast(torch.stack([fwd.b_hh, bwd.b_hh]), dtype)[:, None, :],
        torch.zeros(2, B, H, dtype=x.dtype, device=x.device))
    return torch.cat([y[0], flip_sequences(y[1], lengths)], dim=-1)


class BiGRU(nn.Module):
    """Stacked bidirectional GRU: ``layers.{i}.fwd`` / ``.bwd``."""

    def __init__(self, in_dim: int, hidden: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList()
        for i in range(layers):
            d = in_dim if i == 0 else 2 * hidden
            layer = nn.Module()
            layer.fwd = GRUCell(d, hidden)
            layer.bwd = GRUCell(d, hidden)
            self.layers.append(layer)

    def forward(self, x, lengths, dtype=None, gen=None, rate=0.0):
        """[B, T, in] + lengths [B] -> [B, T, 2H]; dropout at ``rate``
        between stacked layers when ``gen`` is given (training)."""
        y = x
        for i, layer in enumerate(self.layers):
            if i > 0:
                y = dropout(y, rate, gen)
            y = bidirectional_layer(layer.fwd, layer.bwd, y, lengths, dtype)
        return y
