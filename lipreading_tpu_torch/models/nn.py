"""Layer functions and the parameter-holding modules built on them.

Counterpart of ``lipreading_tpu/models/nn.py``. Parameters are float32 and
keep the JAX package's names and layouts (dense ``w`` is [in, out], conv
``w`` is [kT, kH, kW, Cin, Cout]), so a release's leaves load by path
(``io.from_jax_params``). ``dtype`` casts weights to the activation type at
each call, as the JAX package does; normalisations compute in float32 and
cast back.

Randomness (dropout, initialisation) comes from an explicit
``torch.Generator``; ``None`` means deterministic (no dropout). A generator
gives other numbers than ``jax.random`` from the same seed, so the tests
compare with dropout off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w + b`` with both w and b cast to ``dtype`` when it is given.

    Without ``dtype`` the product runs in the wider of the two types, as JAX
    promotes bf16 @ f32 to f32."""
    if dtype is not None:
        w = w.to(dtype)
        b = None if b is None else b.to(dtype)
    else:
        wide = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(wide), w.to(wide)
        b = None if b is None else b.to(wide)
    y = x @ w
    return y if b is None else y + b


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (population variance),
    result cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def groupnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              groups: int = 8, eps: float = 1e-5,
              framewise: bool = False) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of [B, (T,) ..., C].

    ``gcd(groups, C)`` groups. Statistics per sample, or per (sample, frame)
    when ``framewise`` (x is then [B, T, ...spatial..., C]). Float32,
    population variance, cast back to x's dtype."""
    xf = x.float()
    C = xf.shape[-1]
    g = math.gcd(groups, C)
    lead = tuple(xf.shape[:2] if framewise else xf.shape[:1])
    xg = xf.reshape(*lead, -1, g, C // g)
    dims = (len(lead), len(lead) + 2)
    mean = xg.mean(dim=dims, keepdim=True)
    var = xg.var(dim=dims, keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(xf.shape)
    return (y * scale + bias).to(x.dtype)


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding for one axis -> (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           strides=(1, 1, 1), dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [B, T, H, W, C] (NDHWC), w [kT, kH, kW, Cin, Cout] (DHWIO), SAME
    padding -> [B, T', H', W', Cout]."""
    if dtype is not None:
        w, b = w.to(dtype), b.to(dtype)
    pads = []
    for axis in (3, 2, 1):          # F.pad lists the last axis first
        pads.extend(_same_pads(x.shape[axis], w.shape[axis - 1],
                               strides[axis - 1]))
    xc = F.pad(x.permute(0, 4, 1, 2, 3), pads)
    y = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=tuple(strides))
    return y.permute(0, 2, 3, 4, 1) + b


def maxpool3d(x: torch.Tensor, window=(1, 2, 2)) -> torch.Tensor:
    """Non-overlapping max pool of [B, T, H, W, C] with VALID padding."""
    B, T, H, W, C = x.shape
    kt, kh, kw = window
    x = x[:, :T - T % kt, :H - H % kh, :W - W % kw]
    x = x.reshape(B, T // kt, kt, H // kh, kh, W // kw, kw, C)
    return x.amax(dim=(2, 4, 6))


def embedding(ids: torch.Tensor, table: torch.Tensor,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """Rows of ``table`` [V, D] (cast to ``dtype`` when given) for ``ids``."""
    return F.embedding(ids.long(), table if dtype is None else table.to(dtype))


def dropout(x: torch.Tensor, rate: float,
            gen: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - rate`` and scale the kept
    values by ``1 / (1 - rate)``; identity when ``gen`` is None or the rate
    is 0. The mask is drawn from ``gen`` on the device of ``x``."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool validity mask."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, dtype=None):
        return dense(x, self.w, self.b, dtype)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.table = nn.Parameter(torch.zeros(vocab, dim))

    def forward(self, ids, dtype=None):
        return embedding(ids, self.table, dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layernorm(x, self.scale, self.bias)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, framewise: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.framewise = framewise

    def forward(self, x):
        return groupnorm(x, self.scale, self.bias, framewise=self.framewise)


class Conv3d(nn.Module):
    def __init__(self, kernel: tuple[int, int, int], cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(*kernel, cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x, dtype=None):
        return conv3d(x, self.w, self.b, dtype=dtype)


class Highway(nn.Module):
    """``relu(h(x)) * t + x * (1 - t)`` with ``t = sigmoid(t(x))``."""

    def __init__(self, dim: int):
        super().__init__()
        self.h = Dense(dim, dim)
        self.t = Dense(dim, dim)

    def forward(self, x, dtype=None):
        h = torch.relu(self.h(x, dtype))
        t = torch.sigmoid(self.t(x, dtype))
        return h * t + x * (1.0 - t)
