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

from lipreading_tpu_torch import kernels, profiling
from lipreading_tpu_torch.ops.roi import full_float32


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


def _conv(x: torch.Tensor, w: torch.Tensor, strides):
    """The convolution without its bias -> (y [B, T', H', W', Cout], the
    padded NCDHW input it read)."""
    pads = []
    for axis in (3, 2, 1):          # F.pad lists the last axis first
        pads.extend(_same_pads(x.shape[axis], w.shape[axis - 1],
                               strides[axis - 1]))
    xc = F.pad(x.permute(0, 4, 1, 2, 3), pads)
    # a float32 convolution in full float32, whatever cuDNN's TF32 default
    with full_float32():
        y = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=tuple(strides))
    return y.permute(0, 2, 3, 4, 1), xc


class _Conv3dDgrad(torch.autograd.Function):
    """A stride-1 convolution whose input gradient is ``conv3d_dgrad`` (the
    kernel on a card). The forward and the weight gradient are the ops
    that autograd runs through ``_conv``: the same cuDNN calls on the same
    tensors, so the same bytes."""

    @staticmethod
    def forward(ctx, x, w):
        y, xc = _conv(x, w, (1, 1, 1))
        ctx.save_for_backward(xc, w)
        return y

    @staticmethod
    def backward(ctx, g):
        xc, w = ctx.saved_tensors
        dx = conv3d_dgrad(g, w) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                g.permute(0, 4, 1, 2, 3), xc, w.permute(4, 3, 0, 1, 2), None,
                [1, 1, 1], [0, 0, 0], [1, 1, 1], False, [0, 0, 0], 1,
                [False, True, False])[1].permute(2, 3, 4, 1, 0)
        return dx, dw


def conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           strides=(1, 1, 1), dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [B, T, H, W, C] (NDHWC), w [kT, kH, kW, Cin, Cout] (DHWIO), SAME
    padding -> [B, T', H', W', Cout].

    A bf16 stride-1 convolution whose input needs a gradient (grad mode on)
    takes its input gradient from ``conv3d_dgrad`` (counted by the tracer's
    ``conv3d.dgrad``); every other call is autograd's through cuDNN."""
    if dtype is not None:
        w, b = w.to(dtype), b.to(dtype)
    if (torch.is_grad_enabled() and x.requires_grad
            and tuple(strides) == (1, 1, 1) and x.dtype == torch.bfloat16):
        profiling.count("conv3d.dgrad")
        return _Conv3dDgrad.apply(x, w) + b
    return _conv(x, w, strides)[0] + b


def _dgrad_operands(w: torch.Tensor, size):
    """The weight [kT, kH, kW, Cin, Cout] flipped over its taps as
    [Cin, kT, kH, kW, Cout], and the correlation's pads q = k - 1 - (SAME's
    pad before) for the spatial ``size`` (T, H, W)."""
    wt = w.flip(0, 1, 2).permute(3, 0, 1, 2, 4)
    q = tuple(k - 1 - _same_pads(n, k, 1)[0] for n, k in zip(size, w.shape))
    return wt, q


def conv3d_dgrad_plain(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient of a stride-1 SAME ``conv3d``: dy [B, T, H, W,
    Cout], w [kT, kH, kW, Cin, Cout] -> dx [B, T, H, W, Cin] in dy's dtype.
    A sum over the flipped taps of shifted products, in float32 (the
    kernel's function; ``csrc/conv3d_dgrad.cu``)."""
    B, T, H, W, _ = dy.shape
    kT, kH, kW = w.shape[:3]
    wt, (qT, qH, qW) = _dgrad_operands(w.float(), (T, H, W))
    dyp = F.pad(dy.float(), (0, 0, qW, kW - 1 - qW, qH, kH - 1 - qH,
                             qT, kT - 1 - qT))
    dx = dy.new_zeros((B, T, H, W, w.shape[3]), dtype=torch.float32)
    for jt in range(kT):
        for jh in range(kH):
            for jw in range(kW):
                dx += (dyp[:, jt:jt + T, jh:jh + H, jw:jw + W]
                       @ wt[:, jt, jh, jw].T)
    return dx.to(dy.dtype)


def conv3d_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3d_dgrad_plain``'s function. On CUDA tensors (bf16) it launches
    the Hopper kernel (``csrc/conv3d_dgrad.cu``, channels padded to a
    multiple of 8 where they are not); on CPU tensors it runs the plain
    version."""
    if dy.ndim != 5 or w.ndim != 5 or dy.shape[4] != w.shape[4]:
        raise ValueError(f"conv3d_dgrad: dy {tuple(dy.shape)} and w "
                         f"{tuple(w.shape)} are not [B, T, H, W, Cout] and "
                         "[kT, kH, kW, Cin, Cout]")
    if dy.device.type == "cpu" and w.device.type == "cpu":
        return conv3d_dgrad_plain(dy, w)
    if dy.device.type != "cuda" or w.device != dy.device:
        raise ValueError(f"conv3d_dgrad: dy on {dy.device}, w on {w.device}; "
                         "need both on one CUDA device")
    if dy.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv3d_dgrad: the kernel takes bf16, got "
                        f"{dy.dtype} and {w.dtype}")
    B, T, H, W, Cout = dy.shape
    kT, kH, kW, Cin = w.shape[:4]
    ci, co = -Cin % 8, -Cout % 8
    if ci or co:
        dy = F.pad(dy, (0, co))
        w = F.pad(w, (0, co, 0, ci))
    wt, q = _dgrad_operands(w, (T, H, W))
    dy, wt = dy.contiguous(), wt.contiguous()
    dx = torch.empty((B, T, H, W, Cin + ci), dtype=dy.dtype, device=dy.device)
    err = kernels.lib().conv3d_dgrad(
        dy.data_ptr(), wt.data_ptr(), dx.data_ptr(), B, T, H, W, Cin + ci,
        Cout + co, kT, kH, kW, *q, kernels.stream_ptr(dy.device))
    kernels.check(err, "conv3d_dgrad")
    conv3d_dgrad.launches += 1
    return dx[..., :Cin] if ci else dx


conv3d_dgrad.launches = 0


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


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse [B, T, ...] within each sample's length: position t reads
    ``lengths - 1 - t``, clipped to [0, T - 1], so the positions past a
    length read index 0 (the bi-GRU's backward direction; padded positions
    equal the JAX package's)."""
    B, T = x.shape[:2]
    idx = (lengths.to(x.device).long()[:, None] - 1
           - torch.arange(T, device=x.device)[None, :]).clamp(0, T - 1)
    idx = idx.reshape(B, T, *([1] * (x.ndim - 2))).expand(x.shape)
    return torch.gather(x, 1, idx)


class Dense(nn.Module):
    """``x @ w (+ b)``; ``bias=False`` holds no ``b`` (the Bahdanau
    decoder's ``attn_enc`` and ``attn_v``)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim)) if bias else None

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

    def forward(self, x, dtype=None, strides=(1, 1, 1)):
        return conv3d(x, self.w, self.b, strides, dtype)


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
