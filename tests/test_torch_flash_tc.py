"""The arithmetic of the Hopper bf16 flash kernels
(``lipreading_tpu_torch/csrc/flash_attention_sm90.cu``), emulated in plain
torch on the CPU at small sizes, against the function they must compute.

The kernels take bf16 q, k, v and dO and run every product on the tensor
cores: q.k and dO.v as bf16 x bf16 (exact products, float32 sums); P.V,
P^T.dO, dS^T.Q and dS.K with the float32 P or dS split into hi = bf16(x)
and lo = bf16(x - hi), both into one float32 accumulator, tile by tile in
the kernels' key order. The emulation does the same with bf16-valued
float32 tensors and holds the result against ``flash_fwd_reference`` /
``_bwd_reference`` and against the JAX package's ``_flash_fwd_impl`` /
``_flash_bwd_fused_impl`` (Pallas in interpret mode), all in float32 on the
same inputs: within 2e-5 of the largest value of each output, the float32
limit, before any cast of the output. A single bf16 rounding of P and dS
(what FlashAttention-2/3 and SDPA do) must break that limit: it would still
pass the card's bf16 limit of 1e-2, so only this test tells the two designs
apart.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.ops import flash_attention as jfa
from lipreading_tpu_torch.ops import flash_attention as tfa

LIMIT = 2e-5
TILE = 64   # the kernels' key tile (forward) and key / query tiles (backward)
# (B, T, H, Dh, lengths): the cases of tests/test_torch_cuda.py::FLASH_CASES
# below T 1024
CASES = [(2, 40, 2, 16, [40, 23]), (1, 13, 3, 8, [11]),
         (3, 130, 4, 64, [130, 64, 0]), (2, 77, 2, 100, [77, 5]),
         (2, 33, 1, 12, [33, 20])]
IDS = ["x".join(map(str, c[:4])) for c in CASES]


def _inputs(case, seed):
    """q, k, v, dO as bf16-valued float32 [B, T, H, Dh], and lengths."""
    B, T, H, Dh, lengths = case
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.normal(0, 1, (B, T, H, Dh)).astype(np.float32))
          .to(torch.bfloat16).float() for _ in range(4)]
    return xs, torch.tensor(lengths, dtype=torch.int32)


def _tc(x, y, split: bool):
    """x @ y on the tensor cores with a float32 left operand x and a bf16
    right operand y: x split into hi + lo (two products into one float32
    sum), or rounded once to bf16."""
    hi = x.to(torch.bfloat16).float()
    if not split:
        return hi @ y
    return hi @ y + (x - hi).to(torch.bfloat16).float() @ y


def emulate_fwd(q, k, v, lengths, split=True):
    """The forward kernel's arithmetic -> out, lse (float32)."""
    B, T, H, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    out = torch.zeros(B, H, T, Dh)
    lse = torch.zeros(B, H, T)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        qb = q[b].transpose(0, 1)                       # [H, T, Dh]
        m = torch.full((H, T), tfa.NEG_INF)
        l = torch.zeros(H, T)
        acc = torch.zeros(H, T, Dh)
        for k0 in range(0, n, TILE):                    # tiles below n only
            kt = k[b, k0:k0 + TILE].transpose(0, 1)     # [H, tile, Dh]
            vt = v[b, k0:k0 + TILE].transpose(0, 1)
            s = (qb @ kt.transpose(1, 2)) * scale
            keys = torch.arange(k0, k0 + kt.shape[1])
            s = torch.where(keys < n, s, tfa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _tc(p, vt, split)
            m = m_new
        den = torch.clamp(l, min=1e-30)
        out[b] = acc / den[..., None] if n > 0 else 0.0
        lse[b] = m + torch.log(den)
    return out.transpose(1, 2), lse


def emulate_bwd(q, k, v, lengths, dout, delta, lse, split=True):
    """The fused backward kernel's arithmetic -> dq, dk, dv (float32):
    key tiles below the length, every query tile."""
    B, T, H, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    dq, dk, dv = (torch.zeros(B, H, T, Dh) for _ in range(3))
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        for k0 in range(0, n, TILE):
            kt = k[b, k0:k0 + TILE].transpose(0, 1)     # [H, keys, Dh]
            vt = v[b, k0:k0 + TILE].transpose(0, 1)
            kvalid = (torch.arange(k0, k0 + kt.shape[1]) < n)[:, None]
            for q0 in range(0, T, TILE):
                qt = q[b, q0:q0 + TILE].transpose(0, 1)  # [H, queries, Dh]
                gt = dout[b, q0:q0 + TILE].transpose(0, 1)
                lse_t = lse[b, :, q0:q0 + TILE][:, None, :]
                del_t = delta[b, q0:q0 + TILE].transpose(0, 1)[:, None, :]
                st = (kt @ qt.transpose(1, 2)) * scale   # S^T [H, keys, q]
                pt = torch.where(kvalid, torch.exp(st - lse_t), 0.0)
                dv[b, :, k0:k0 + TILE] += _tc(pt, gt, split)
                dpt = vt @ gt.transpose(1, 2)
                dst = pt * (dpt - del_t)
                dk[b, :, k0:k0 + TILE] += _tc(dst, qt, split)
                dq[b, :, q0:q0 + TILE] += _tc(dst.transpose(1, 2), kt, split)
    return tuple(x.transpose(1, 2) for x in (dq * scale, dk * scale, dv))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_fwd(q, k, v, ln, raw=False):
    """``_flash_fwd_impl`` in float32 (interpret mode) -> out, lse
    [B, H, T] as torch (and its own lse [B H, padded T] when ``raw``)."""
    B, T, H, _ = q.shape
    out, j_lse = jfa._flash_fwd_impl(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(ln.numpy()),
        512, 512, None, return_lse=True)
    lse = np.array(j_lse)[:, :T].reshape(B, H, T)
    res = torch.from_numpy(np.array(out)), torch.from_numpy(lse)
    return (*res, j_lse) if raw else res


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_split_keeps_the_float32_function(case):
    (q, k, v, _), ln = _inputs(case, seed=case[1])
    out, lse = emulate_fwd(q, k, v, ln)
    want, lse_w = tfa.flash_fwd_reference(q, k, v, ln, return_lse=True)
    j_out, j_lse = _jax_fwd(q, k, v, ln)
    live = ln > 0
    for ref, ref_lse in ((want, lse_w), (j_out, j_lse)):
        assert _rel(out, ref) <= LIMIT
        assert _rel(lse[live], ref_lse[live]) <= LIMIT
    for b in np.flatnonzero(~live.numpy()):
        assert torch.all(out[b] == 0.0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_single_rounding_breaks_the_limit(case):
    (q, k, v, _), ln = _inputs(case, seed=case[1])
    out, _ = emulate_fwd(q, k, v, ln, split=False)
    assert _rel(out, tfa.flash_fwd_reference(q, k, v, ln)) > LIMIT


def _bwd_case(case, with_jax=True):
    """Inputs of the backward with the JAX forward's out and lse, and the
    JAX fused backward's dq, dk, dv (float32, interpret mode); without JAX,
    the plain forward's out and lse and no JAX result."""
    (q, k, v, g), ln = _inputs(case, seed=case[1] + 1)
    if not with_jax:
        out, lse = tfa.flash_fwd_reference(q, k, v, ln, return_lse=True)
        return (q, k, v, ln, *tfa.bwd_inputs(out, g, ln), lse), None
    out, lse, j_lse = _jax_fwd(q, k, v, ln, raw=True)
    gg, delta = tfa.bwd_inputs(out, g, ln)
    want_j = jfa._flash_bwd_fused_impl(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(ln.numpy()),
        jnp.asarray(out.numpy()), j_lse, jnp.asarray(gg.numpy()), 512, 512,
        None)
    return (q, k, v, ln, gg, delta, lse), [np.asarray(x) for x in want_j]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_backward_split_keeps_the_float32_function(case):
    args, want_j = _bwd_case(case)
    got = emulate_bwd(*args)
    want = tfa._bwd_reference(*args)
    for ref in (want, want_j):
        for a, b in zip(got, ref):
            assert _rel(a, b) <= LIMIT
    ln = args[3]
    for b in np.flatnonzero((ln == 0).numpy()):
        assert all(torch.all(x[b] == 0.0) for x in got)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_backward_single_rounding_breaks_the_limit(case):
    args, _ = _bwd_case(case, with_jax=False)
    got = emulate_bwd(*args, split=False)
    want = tfa._bwd_reference(*args)
    assert max(_rel(a, b) for a, b in zip(got, want)) > LIMIT
