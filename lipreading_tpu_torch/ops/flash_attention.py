"""Flash attention for the encoder's self-attention (counterpart of
``lipreading_tpu/ops/flash_attention.py``).

Length-masked, non-causal multi-head attention that never holds the
[B, H, T, T] scores in device memory, so long clips train and decode in
O(T * Dh) attention memory. Its function is the JAX package's flash kernel,
not the encoder's ``mha``: scores are formed in float32 from the upcast
inputs (``mha`` forms them in the activation type), scaled by 1/sqrt(Dh),
keys at or past the length masked with -1e30, the output ``acc / max(l,
1e-30)`` cast to q's type, and a sample of length 0 gives exact zeros. At
bf16 the two are different functions.

Four kernels (``csrc/flash_attention.cu`` in float32, on the CUDA cores; in
bf16 all four are the Hopper kernels of ``csrc/flash_attention_sm90.cu``,
tensor cores with P and dS split into bf16 hi + lo), each with its plain
PyTorch version beside it:

* ``flash_fwd`` (with the logsumexp ``lse`` on request) replaces
  ``_flash_kernel``;
* ``flash_bwd_fused`` (dq, dk, dv in one sweep) replaces
  ``_bwd_fused_kernel``;
* ``flash_bwd_dq`` and ``flash_bwd_dkv`` (the two-pass backward) replace
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``. They write dq, dk and dv
  without atomics, so their results are the same bytes from run to run.

Each wrapper runs its plain version only for tensors on the CPU; on CUDA
tensors it launches its kernel or raises. ``FlashAttention`` is the autograd
function and ``flash_attention`` the entry, with the JAX package's backward
policies (``bwd``):

* ``"xla"``: the forward kernel without lse; the backward is autograd
  through ``reference_attend`` recomputed (plain PyTorch; the [T, T] scores
  exist transiently in the backward);
* ``"pallas"``: the forward kernel with lse, then the two-pass pair (the
  reproducible backward);
* ``"fused"``: the forward kernel with lse, then the fused kernel;
* ``"auto"``: ``"xla"`` below ``AUTO_FUSED_MIN_T`` frames, ``"fused"`` at or
  above it.

The Pallas version's block sizes, interpret flag, head-dim and time padding,
``PALLAS_BWD_MIN_T`` and ``FUSED_DQ_SCRATCH_CAP`` are TPU layout and VMEM
choices; the port has none of them. The fused kernel's dq accumulator is a
float32 workspace in device memory, so it has no cap, and the ``auto``
threshold is re-derived from readings on the H100 (``PERF.md``).
"""

from __future__ import annotations

import math

import torch

from lipreading_tpu_torch import kernels

NEG_INF = -1e30
FLASH_BWD = ("auto", "xla", "pallas", "fused")
# ``auto`` takes the fused backward from this many frames on, the xla one
# below. On the H100 (80GB HBM3, 700 W) the fused kernel's forward +
# backward beat the xla backward's at every T read, 64 to 8192, with the
# first CUDA-core kernels and again with the tensor-core ones
# (chip_smoke.py's [flash] auto readings, PERF.md section 6), so this is
# the smallest T read
AUTO_FUSED_MIN_T = 64
MAX_HEAD_DIM = 128          # the kernels' limit; universal4 has 64


def check_bwd(bwd: str) -> str:
    """``bwd`` if it is one of the JAX package's policies, else raise."""
    if bwd not in FLASH_BWD:
        raise ValueError(f"flash_bwd={bwd!r}: must be one of {FLASH_BWD}")
    return bwd


def policy(bwd: str, T: int) -> str:
    """The backward that ``bwd`` picks at ``T`` frames: xla, pallas or
    fused."""
    if check_bwd(bwd) == "auto":
        return "fused" if T >= AUTO_FUSED_MIN_T else "xla"
    return bwd


def _valid(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T] key validity; lengths above T count as T."""
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths.long()[:, None])


# --- plain versions ---------------------------------------------------------

def reference_attend(q, k, v, lengths):
    """The JAX package's ``_reference_attend``: scores in the activation
    type, float32 softmax over the valid keys, weights cast back, the output
    zeroed for samples of length 0 (its gradient too). Autograd through it
    is the ``xla`` backward."""
    B, T, H, Dh = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
    valid = _valid(lengths, T)[:, None, None, :]
    s = torch.where(valid, s.float(), NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return out * (lengths > 0).to(out.dtype)[:, None, None, None]


def _scores(q, k, lengths):
    """float32 [B, H, T, T] scaled scores from the upcast inputs, -1e30 at
    keys at or past the length."""
    B, T, H, Dh = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(Dh))
    return torch.where(_valid(lengths, T)[:, None, None, :], s, NEG_INF)


def flash_fwd_reference(q, k, v, lengths, return_lse: bool = False):
    """Plain version of the forward kernel: -> out [B, T, H, Dh] in q's type
    (and lse [B, H, T] float32 when ``return_lse``)."""
    s = _scores(q, k, lengths)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)   # [B,H,T,1]
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = acc / den.permute(0, 2, 1, 3)
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    out = out.to(q.dtype)
    if return_lse:
        return out, (m + torch.log(den))[..., 0]
    return out


def _bwd_reference(q, k, v, lengths, dout, delta, lse):
    """dq, dk, dv in q's type from p = exp(s - lse) and ds = p (dO.v -
    delta); delta [B, T, H] and lse [B, H, T] float32."""
    Dh = q.shape[-1]
    scale = 1.0 / math.sqrt(Dh)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(_scores(q, k, lengths) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_fused_reference(q, k, v, lengths, dout, delta, lse):
    """Plain version of the fused backward kernel: -> (dq, dk, dv)."""
    return _bwd_reference(q, k, v, lengths, dout, delta, lse)


def flash_bwd_dq_reference(q, k, v, lengths, dout, delta, lse):
    """Plain version of the two-pass backward's dq kernel: -> dq."""
    return _bwd_reference(q, k, v, lengths, dout, delta, lse)[0]


def flash_bwd_dkv_reference(q, k, v, lengths, dout, delta, lse):
    """Plain version of the two-pass backward's dk/dv kernel: -> (dk, dv)."""
    return _bwd_reference(q, k, v, lengths, dout, delta, lse)[1:]


# --- the kernels' wrappers --------------------------------------------------

def _check(name, q, k, v, lengths, dout=None, delta=None, lse=None) -> bool:
    """Validate the inputs; True when they lie on one CUDA device, False when
    all lie on the CPU."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not one "
                         "[B, T, H, Dh] shape")
    B, T, H, Dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            x.dtype != q.dtype for x in (k, v)):
        raise TypeError(f"{name}: q, k, v must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise TypeError(f"{name}: lengths must be int32 [{B}], got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    tensors = [q, k, v, lengths]
    if dout is not None:
        if (dout.shape != q.shape or dout.dtype != q.dtype
                or delta.shape != (B, T, H) or lse.shape != (B, H, T)
                or delta.dtype != torch.float32
                or lse.dtype != torch.float32):
            raise TypeError(f"{name}: need dO like q, float32 delta "
                            f"[B, T, H] and float32 lse [B, H, T]")
        tensors += [dout, delta, lse]
    if all(x.device.type == "cpu" for x in tensors):
        return False
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError(f"{name}: inputs on {[str(x.device) for x in tensors]}"
                         "; need all on the CPU or all on one CUDA device")
    if not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {Dh} is outside the kernels' "
                         f"1..{MAX_HEAD_DIM}")
    return True


def _geometry(q):
    B, T, H, Dh = q.shape
    return (B, T, H, Dh, int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(Dh))


def _tma_ready(xs, bf16: int):
    """The bf16 kernels read [B, T, H, Dh] through TMA maps, which need
    each stride (Dh * 2 bytes) and each base to be a multiple of 16 bytes.
    Where one is not (Dh 12, say, or a view at an odd offset), the inputs
    are copied into zero-padded [B, T, H, Dp]
    buffers, Dp = Dh rounded up to 8, as the JAX package pads Dh in
    ``_prep``: zero columns add nothing to q . k and give zero output
    columns, which the caller slices off; the scale stays 1/sqrt(Dh).
    universal4 (Dh 64, whole allocations) never takes the copy. -> (xs,
    the head dim to launch with)."""
    Dh = xs[0].shape[-1]
    if not bf16 or (Dh % 8 == 0 and all(x.data_ptr() % 16 == 0
                                        for x in xs)):
        return xs, Dh
    Dp = -(-Dh // 8) * 8
    out = []
    for x in xs:
        y = x.new_zeros((*x.shape[:-1], Dp))
        y[..., :Dh] = x
        out.append(y)
    return out, Dp


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor, return_lse: bool = False):
    """q, k, v [B, T, H, Dh] (float32 or bf16), lengths [B] int32 -> out
    [B, T, H, Dh] in q's type (and lse [B, H, T] float32 when
    ``return_lse``).

    On CUDA tensors this launches the forward kernel; on CPU tensors it runs
    ``flash_fwd_reference``."""
    if not _check("flash_fwd", q, k, v, lengths):
        return flash_fwd_reference(q, k, v, lengths, return_lse)
    q, k, v, lengths = (x.contiguous() for x in (q, k, v, lengths))
    B, T, H, Dh, bf16, scale = _geometry(q)
    (q, k, v), D = _tma_ready([q, k, v], bf16)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = kernels.lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr() if return_lse else None,
        B, T, H, D, bf16, scale, kernels.stream_ptr(q.device))
    kernels.check(err, "flash_fwd")
    flash_fwd.launches += 1
    if D != Dh:
        out = out[..., :Dh].contiguous()
    return (out, lse) if return_lse else out


def _contiguous(*xs):
    """The backward kernels' inputs, contiguous (held by the caller until
    the launch)."""
    return [x.contiguous() for x in xs]


def flash_bwd_fused(q, k, v, lengths, dout, delta, lse):
    """The forward's inputs, dO [B, T, H, Dh] in their type, delta =
    rowsum(dO * out) [B, T, H] float32 and the forward's lse [B, H, T] ->
    (dq, dk, dv) in q's type, in one sweep.

    On CUDA tensors this launches the fused backward kernel (dq summed with
    atomics in a float32 workspace: reproducible to rounding only); on CPU
    tensors it runs ``flash_bwd_fused_reference``."""
    if not _check("flash_bwd_fused", q, k, v, lengths, dout, delta, lse):
        return flash_bwd_fused_reference(q, k, v, lengths, dout, delta, lse)
    q, k, v, lengths, dout, delta, lse = _contiguous(q, k, v, lengths, dout,
                                                     delta, lse)
    B, T, H, Dh, bf16, scale = _geometry(q)
    (q, k, v, dout), D = _tma_ready([q, k, v, dout], bf16)
    ws = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    err = kernels.lib().flash_bwd_fused(
        *(x.data_ptr() for x in (q, k, v, lengths, dout, delta, lse)),
        ws.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, H, D, bf16, scale, kernels.stream_ptr(q.device))
    kernels.check(err, "flash_bwd_fused")
    flash_bwd_fused.launches += 1
    if D != Dh:
        dq, dk, dv = (x[..., :Dh].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


def flash_bwd_dq(q, k, v, lengths, dout, delta, lse):
    """As ``flash_bwd_fused`` -> dq, the first pass of the two-pass
    backward. On CPU tensors it runs ``flash_bwd_dq_reference``."""
    if not _check("flash_bwd_dq", q, k, v, lengths, dout, delta, lse):
        return flash_bwd_dq_reference(q, k, v, lengths, dout, delta, lse)
    q, k, v, lengths, dout, delta, lse = _contiguous(q, k, v, lengths, dout,
                                                     delta, lse)
    B, T, H, Dh, bf16, scale = _geometry(q)
    (q, k, v, dout), D = _tma_ready([q, k, v, dout], bf16)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = kernels.lib().flash_bwd_dq(
        *(x.data_ptr() for x in (q, k, v, lengths, dout, delta, lse)),
        dq.data_ptr(), B, T, H, D, bf16, scale, kernels.stream_ptr(q.device))
    kernels.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq[..., :Dh].contiguous() if D != Dh else dq


def flash_bwd_dkv(q, k, v, lengths, dout, delta, lse):
    """As ``flash_bwd_fused`` -> (dk, dv), the second pass of the two-pass
    backward. On CPU tensors it runs ``flash_bwd_dkv_reference``."""
    if not _check("flash_bwd_dkv", q, k, v, lengths, dout, delta, lse):
        return flash_bwd_dkv_reference(q, k, v, lengths, dout, delta, lse)
    q, k, v, lengths, dout, delta, lse = _contiguous(q, k, v, lengths, dout,
                                                     delta, lse)
    B, T, H, Dh, bf16, scale = _geometry(q)
    (q, k, v, dout), D = _tma_ready([q, k, v, dout], bf16)
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    err = kernels.lib().flash_bwd_dkv(
        *(x.data_ptr() for x in (q, k, v, lengths, dout, delta, lse)),
        dk.data_ptr(), dv.data_ptr(), B, T, H, D, bf16, scale,
        kernels.stream_ptr(q.device))
    kernels.check(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    if D != Dh:
        dk, dv = (x[..., :Dh].contiguous() for x in (dk, dv))
    return dk, dv


flash_fwd.launches = 0
flash_bwd_fused.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
WRAPPERS = (flash_fwd, flash_bwd_fused, flash_bwd_dq, flash_bwd_dkv)


def bwd_inputs(out, g, lengths):
    """g gated by ``lengths > 0`` and delta = rowsum(g * out) [B, T, H],
    formed in the activation type as the JAX package forms it, as float32."""
    g = g * (lengths > 0).to(g.dtype)[:, None, None, None]
    return g.contiguous(), (g * out).sum(dim=-1).float()


class FlashAttention(torch.autograd.Function):
    """out = attention of q, k, v over the valid keys; the backward is the
    policy's (the JAX package's ``flash_attention`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, bwd):
        ctx.policy = policy(bwd, q.shape[1])
        if ctx.policy == "xla":
            ctx.save_for_backward(q, k, v, lengths)
            return flash_fwd(q, k, v, lengths)
        out, lse = flash_fwd(q, k, v, lengths, return_lse=True)
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.policy == "xla":
            q, k, v, lengths = ctx.saved_tensors
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                out = reference_attend(*leaves, lengths)
                dq, dk, dv = torch.autograd.grad(out, leaves, g)
            return dq, dk, dv, None, None
        q, k, v, lengths, out, lse = ctx.saved_tensors
        g, delta = bwd_inputs(out, g, lengths)
        if ctx.policy == "fused":
            dq, dk, dv = flash_bwd_fused(q, k, v, lengths, g, delta, lse)
        else:
            dq = flash_bwd_dq(q, k, v, lengths, g, delta, lse)
            dk, dv = flash_bwd_dkv(q, k, v, lengths, g, delta, lse)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, bwd: str = "auto") -> torch.Tensor:
    """Length-masked non-causal multi-head attention, O(T * Dh) memory.

    q, k, v [B, T, H, Dh] in the activation type; lengths [B] valid key
    counts (int32, on q's device). Returns [B, T, H, Dh] in q's type.
    ``bwd`` picks the backward (module docstring). Without a gradient to
    take, only the forward runs, without lse."""
    check_bwd(bwd)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, lengths, bwd)
    return flash_fwd(q, k, v, lengths)
