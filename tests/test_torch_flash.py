"""The port's flash attention (``lipreading_tpu_torch.ops.flash_attention``)
against the JAX package's on the CPU, where the Pallas kernels run in
interpret mode (as ``tests/test_flash_attention.py`` runs them) and the
port's wrappers take their plain versions.

Tolerances, as max|port - JAX| / max|JAX| of each output:

* float32: 2e-5, the JAX tests' limit. Both sides form the scores in
  float32 from the same inputs; only the order of the sums differs.
* bf16, the forward and the kernels' backwards: 1e-2. Both compute in
  float32 and round the outputs to bf16, so an output can land one bf16
  ulp (2^-8 of its size) apart, and the backward's delta = rowsum(dO * O)
  is a bf16 sum on both sides, rounded where each framework rounds.
* bf16, the ``xla`` backward: 3e-2. There the einsums themselves run in
  bf16, each side rounding its products and sums in its own places, and
  the differences add up through the softmax's backward.

The encoder, the training entry and the release with flash on are held in
``tests/test_torch_flash_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.ops import flash_attention as jfa
from lipreading_tpu_torch.ops import flash_attention as tfa

F32, BF16 = 2e-5, 1e-2
BF16_EINSUM = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (B, T, H, Dh, lengths): the cases of tests/test_flash_attention.py, each
# with a sample of length 0 beside them
CASES = {
    "full": (2, 40, 2, 16, [40, 40]),
    "ragged": (2, 40, 2, 16, [40, 23]),
    "short": (2, 40, 2, 16, [17, 1]),
    "odd": (1, 13, 3, 8, [11]),
    "zero": (3, 24, 2, 16, [24, 0, 9]),
}


def _case(name, dtype, seed=0):
    """q, k, v and a cotangent w from a seed, as numpy float32 rounded to
    ``dtype``, and the lengths."""
    B, T, H, Dh, lengths = CASES[name]
    rng = np.random.default_rng(seed)
    jd, _ = DTYPES[dtype]
    xs = [np.asarray(jnp.asarray(rng.normal(0, 1, (B, T, H, Dh)), jd)
                     .astype(jnp.float32)) for _ in range(4)]
    return xs, np.asarray(lengths, np.int32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _j(x, dtype):
    return jnp.asarray(x, DTYPES[dtype][0])


def _t(x, dtype):
    return torch.from_numpy(np.array(x)).to(DTYPES[dtype][1])


def _f(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.detach().float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_lse_match_jax(case, dtype):
    """The plain forward against ``flash_attention``, and with lse against
    ``_flash_fwd_impl(return_lse=True)``; a sample of length 0 gives exact
    zeros on both sides."""
    (q, k, v, _), ln = _case(case, dtype)
    jq, jk, jv = (_j(x, dtype) for x in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, jnp.asarray(ln))
    _, jlse = jfa._flash_fwd_impl(jq, jk, jv, jnp.asarray(ln), 512, 512,
                                  None, return_lse=True)
    tq, tk, tv = (_t(x, dtype) for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, torch.from_numpy(ln))
    out, lse = tfa.flash_fwd(tq, tk, tv, torch.from_numpy(ln),
                             return_lse=True)
    tol = F32 if dtype == "float32" else BF16
    assert got.dtype == tq.dtype and _rel(_f(got), _f(want)) <= tol
    assert torch.equal(out, got)
    B, T, H, _ = q.shape
    jlse = np.asarray(jlse)[:, :T].reshape(B, H, T)
    live = ln > 0
    assert _rel(lse.numpy()[live], jlse[live]) <= F32
    np.testing.assert_array_equal(lse.numpy()[~live], jlse[~live])
    for b in np.flatnonzero(~live):
        assert np.all(_f(got)[b] == 0.0) and np.all(_f(want)[b] == 0.0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bwd", ["xla", "pallas", "fused"])
@pytest.mark.parametrize("case", ["odd", "zero"])
def test_gradients_match_jax_grad(case, bwd, dtype):
    """dq, dk, dv of sum(flash_attention(q, k, v) * w) under each backward
    policy against ``jax.grad`` with the same policy; exact zeros for a
    sample of length 0."""
    (q, k, v, w), ln = _case(case, dtype, seed=1)
    jw = _j(w, dtype)

    def loss(a, b, c):
        out = jfa.flash_attention(a, b, c, jnp.asarray(ln), bwd=bwd)
        return (out.astype(jnp.float32) * jw.astype(jnp.float32)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*(_j(x, dtype)
                                               for x in (q, k, v)))
    leaves = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, torch.from_numpy(ln), bwd=bwd)
    (out.float() * _t(w, dtype).float()).sum().backward()
    tol = (F32 if dtype == "float32"
           else BF16_EINSUM if bwd == "xla" else BF16)
    for got, ref in zip(leaves, want):
        assert got.grad.dtype == got.dtype
        assert _rel(_f(got.grad), _f(ref)) <= tol
        for b in np.flatnonzero(ln == 0):
            assert np.all(_f(got.grad)[b] == 0.0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_plain_versions_match_pallas_impls(dtype):
    """The fused and two-pass plain backwards against
    ``_flash_bwd_fused_impl`` and ``_flash_bwd_impl`` on the same q, k, v,
    out, lse and dO (g gated, as ``_flash_bwd`` gates it)."""
    (q, k, v, g), ln = _case("zero", dtype, seed=2)
    jq, jk, jv, jg = (_j(x, dtype) for x in (q, k, v, g))
    jl = jnp.asarray(ln)
    jout, jlse = jfa._flash_fwd_impl(jq, jk, jv, jl, 512, 512, None,
                                     return_lse=True)
    jg = jg * (jl > 0).astype(jg.dtype)[:, None, None, None]
    want_f = jfa._flash_bwd_fused_impl(jq, jk, jv, jl, jout, jlse, jg, 512,
                                       512, None)
    want_2 = jfa._flash_bwd_impl(jq, jk, jv, jl, jout, jlse, jg, 512, 512,
                                 None)
    tq, tk, tv, tg = (_t(x, dtype) for x in (q, k, v, g))
    tl = torch.from_numpy(ln)
    out, lse = tfa.flash_fwd(tq, tk, tv, tl, return_lse=True)
    gg, delta = tfa.bwd_inputs(out, tg, tl)
    fused = tfa.flash_bwd_fused(tq, tk, tv, tl, gg, delta, lse)
    two = (tfa.flash_bwd_dq(tq, tk, tv, tl, gg, delta, lse),
           *tfa.flash_bwd_dkv(tq, tk, tv, tl, gg, delta, lse))
    tol = F32 if dtype == "float32" else BF16
    for got, want in ((fused, want_f), (two, want_2)):
        for a, b in zip(got, want):
            assert _rel(_f(a), _f(b)) <= tol


def test_policy_and_checks():
    """auto picks xla below the threshold and fused from it on; unknown
    policies and wrong inputs raise."""
    T = tfa.AUTO_FUSED_MIN_T
    assert tfa.policy("auto", T - 1) == "xla"
    assert tfa.policy("auto", T) == "fused"
    assert [tfa.policy(b, 8) for b in ("xla", "pallas", "fused")] == [
        "xla", "pallas", "fused"]
    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError):
        tfa.flash_attention(x, x, x, torch.ones(1, dtype=torch.int32),
                            bwd="einsum")
    with pytest.raises(TypeError):
        tfa.flash_fwd(x, x, x, torch.ones(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        tfa.flash_fwd(x, x[:, :3], x, torch.ones(1, dtype=torch.int32))


def test_cpu_wrappers_launch_nothing():
    (q, k, v, g), ln = _case("ragged", "float32")
    before = [w.launches for w in tfa.WRAPPERS]
    leaves = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    for bwd in ("pallas", "fused"):
        tfa.flash_attention(*leaves, torch.from_numpy(ln),
                            bwd=bwd).backward(torch.tensor(g))
    assert [w.launches for w in tfa.WRAPPERS] == before
