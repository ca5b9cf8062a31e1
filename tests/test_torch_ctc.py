"""The port's CTC loss (``lipreading_tpu_torch.ops.ctc``) against the JAX
package on the CPU: the plain ``ctc_loss`` against the ``lax.scan`` loss, and
the lattice kernels' plain versions (behind the autograd function
``CTCLattice``) against the Pallas lattice kernels in interpret mode, as
``tests/test_ctc_pallas.py`` runs them.

Tolerances are those of ``tests/test_ctc_pallas.py``: values rtol 1e-5 (the
two sides add the same terms in another order), gradients rtol 1e-3 /
atol 1e-5 (they come out of differently ordered logaddexp chains). An
infeasible sample (T < 2L + 1) gives a finite NLL near 1e30 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.ops import ctc as jctc
from lipreading_tpu.ops import ctc_pallas as jpallas
from lipreading_tpu_torch.ops import ctc as tctc

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)


def _case(seed, B=4, T=20, V=12, L=6, in_lens=None, lab_lens=None):
    """Random logits and labels with a repeated label (no skip there)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (B, T, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    labels[:, 2] = labels[:, 1]
    in_lens = np.asarray(in_lens if in_lens is not None else [T] * B, np.int32)
    lab_lens = np.asarray(lab_lens if lab_lens is not None else [L] * B,
                          np.int32)
    return logits, labels, in_lens, lab_lens


# (input lengths, label lengths): full; label length 0; input length < T;
# one infeasible sample (T_b = 5 < 2 * 6 + 1)
CASES = {
    "full": ([20, 20, 20, 20], [6, 6, 6, 6]),
    "mixed": ([20, 17, 14, 9], [6, 3, 0, 1]),
    "short_inputs": ([16, 13, 12, 3], [5, 2, 3, 1]),
    "infeasible": ([20, 5, 18, 20], [6, 6, 2, 0]),
}


def _jax_args(logits, labels, inl, lab):
    return [jnp.asarray(a) for a in (logits, labels, inl, lab)]


def _torch_args(logits, labels, inl, lab):
    return [torch.from_numpy(a) for a in (logits, labels, inl, lab)]


def test_extend_labels_matches_jax():
    labels = np.asarray([[3, 3, 7], [1, 0, 0]], np.int32)
    want = np.asarray(jctc.extend_labels(jnp.asarray(labels)))
    got = tctc.extend_labels(torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_ctc_loss_matches_jax(case):
    """Values and logit gradients of the plain loss against the scan loss."""
    logits, labels, inl, lab = _case(1, in_lens=CASES[case][0],
                                     lab_lens=CASES[case][1])
    ja = _jax_args(logits, labels, inl, lab)
    want = np.asarray(jctc.ctc_loss(*ja))
    x = torch.from_numpy(logits).requires_grad_()
    got = tctc.ctc_loss(x, *_torch_args(logits, labels, inl, lab)[1:])
    assert np.isfinite(got.detach().numpy()).all()
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    feasible = 2 * lab + 1 <= inl
    got.sum().backward()
    gw = np.asarray(jax.grad(lambda z: jctc.ctc_loss(z, *ja[1:]).sum())(ja[0]))
    np.testing.assert_allclose(x.grad.numpy()[feasible], gw[feasible], **GRAD)
    assert np.isfinite(x.grad.numpy()).all()
    if case == "infeasible":
        assert got[1].item() > 1e29 and want[1] > 1e29


@pytest.mark.parametrize("case", sorted(CASES))
def test_lattice_loss_matches_pallas_interpret(case):
    """The autograd lattice loss (plain versions of both kernels on the CPU)
    against ``ctc_loss_pallas`` in interpret mode: values and gradients,
    and gradients exactly 0 past each input length."""
    logits, labels, inl, lab = _case(2, in_lens=CASES[case][0],
                                     lab_lens=CASES[case][1])
    ja = _jax_args(logits, labels, inl, lab)
    want = np.asarray(jpallas.ctc_loss_pallas(*ja))
    x = torch.from_numpy(logits).requires_grad_()
    got = tctc.ctc_loss_lattice(x, *_torch_args(logits, labels, inl, lab)[1:])
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    got.sum().backward()
    gw = np.asarray(jax.grad(
        lambda z: jpallas.ctc_loss_pallas(z, *ja[1:]).sum())(ja[0]))
    feasible = 2 * lab + 1 <= inl
    np.testing.assert_allclose(x.grad.numpy()[feasible], gw[feasible], **GRAD)
    for b in range(len(inl)):
        assert np.abs(x.grad.numpy()[b, inl[b]:]).sum() == 0.0


def test_lattice_backward_clamps_input_length_above_t():
    """An input length above T counts as T, as the kernel and the scan loss
    take it: the lattice loss's plain backward gives the gradient of
    ``jax.grad`` of the scan ``ctc_loss`` (not zeros), and the plain forward
    the scan's value."""
    logits, labels, inl, lab = _case(4, in_lens=[20, 27, 14, 21],
                                     lab_lens=[6, 4, 2, 0])
    ja = _jax_args(logits, labels, inl, lab)
    want = np.asarray(jctc.ctc_loss(*ja))
    gw = np.asarray(jax.grad(lambda z: jctc.ctc_loss(z, *ja[1:]).sum())(ja[0]))
    x = torch.from_numpy(logits).requires_grad_()
    got = tctc.ctc_loss_lattice(x, *_torch_args(logits, labels, inl, lab)[1:])
    np.testing.assert_allclose(got.detach().numpy(), want, **VAL)
    got.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), gw, **GRAD)
    for b in (1, 3):                    # the long samples' gradients live
        assert np.abs(x.grad.numpy()[b]).sum() > 0.1


def test_lattice_kernels_plain_versions_match_pallas_kernels():
    """alpha, nll and d nll / d lp_ext of the kernels' plain versions against
    the Pallas forward and backward kernels (interpret mode) on the same
    lattice inputs, with an upstream gradient that differs per sample."""
    logits, labels, inl, lab = _case(3, in_lens=[20, 11, 16, 20],
                                     lab_lens=[6, 2, 0, 4])
    lp_ext, skip = tctc._lattice_inputs(torch.from_numpy(logits),
                                        torch.from_numpy(labels), 0)
    tin, tlab = torch.from_numpy(inl), torch.from_numpy(lab)
    nll, alpha = tctc.ctc_lattice_fwd(lp_ext, skip, tin, tlab)
    jl = [jnp.asarray(lp_ext.numpy()), jnp.asarray(skip.numpy()),
          jnp.asarray(inl), jnp.asarray(lab)]
    jnll, jalpha = jpallas._ctc_lattice_fwd_impl(*jl)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), **VAL)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=1e-5,
                               atol=1e-4)
    g = np.asarray([1.0, 0.5, 2.0, 0.25], np.float32)
    grad = tctc.ctc_lattice_bwd(lp_ext, skip, tin, tlab, alpha, nll,
                                torch.from_numpy(g))
    jgrad = jpallas._ctc_lattice_bwd(
        (*jl[:2], *jl[2:], jalpha, jnll), jnp.asarray(g))[0]
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD)


def test_matches_torch_ctc_loss():
    logits, labels, inl, lab = _case(4, B=3, T=18, V=10, L=4,
                                     in_lens=[18, 15, 11], lab_lens=[4, 2, 3])
    lp = torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1)
    want = torch.nn.CTCLoss(blank=0, reduction="none")(
        lp, torch.from_numpy(labels), torch.from_numpy(inl),
        torch.from_numpy(lab))
    got = tctc.ctc_loss(*_torch_args(logits, labels, inl, lab))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_ctc_loss_mean_matches_jax():
    logits, labels, inl, lab = _case(5, in_lens=[20, 17, 14, 9],
                                     lab_lens=[6, 3, 0, 1])
    want = float(jctc.ctc_loss_mean(*_jax_args(logits, labels, inl, lab)))
    got = float(tctc.ctc_loss_mean(*_torch_args(logits, labels, inl, lab)))
    assert got == pytest.approx(want, rel=1e-5)


def test_best_takes_the_plain_route_on_the_cpu():
    """On CPU tensors ``ctc_loss_best`` is the plain loss and launches
    nothing; the wrappers count no launch for their plain versions."""
    logits, labels, inl, lab = _case(6)
    args = _torch_args(logits, labels, inl, lab)
    before = (tctc.ctc_lattice_fwd.launches, tctc.ctc_lattice_bwd.launches)
    torch.testing.assert_close(tctc.ctc_loss_best(*args),
                               tctc.ctc_loss(*args), rtol=0, atol=0)
    x = args[0].clone().requires_grad_()
    tctc.ctc_loss_lattice(x, *args[1:]).sum().backward()
    assert (tctc.ctc_lattice_fwd.launches,
            tctc.ctc_lattice_bwd.launches) == before


def test_lattice_wrappers_check_their_inputs():
    lp = torch.zeros((2, 5, 7))
    skip = torch.zeros((2, 7), dtype=torch.bool)
    n = torch.full((2,), 5, dtype=torch.int32)
    with pytest.raises(TypeError):
        tctc.ctc_lattice_fwd(lp.double(), skip, n, n)
    with pytest.raises(TypeError):
        tctc.ctc_lattice_fwd(lp, skip, n.long(), n)
    with pytest.raises(ValueError):
        tctc.ctc_lattice_fwd(lp, skip[:, :3], n, n)
    nll, alpha = tctc.ctc_lattice_fwd(lp, skip, n, n)
    with pytest.raises(ValueError):
        tctc.ctc_lattice_bwd(lp, skip, n, n, alpha[:, :2], nll, nll)


PLAN_S = (1, 3, 31, 33, 81, 129, 301, 513, 1025, 2049, 4097)


@pytest.mark.parametrize("S", PLAN_S)
def test_lattice_plan_covers_every_state_once(S):
    """Lane j of warp w owns states (32 w + j) K + k: every state below S
    belongs to exactly one (warp, lane, k), K is one the kernels are built
    for, no warp lies wholly past S, and the block fits the card."""
    W, K = tctc.lattice_plan(S)
    assert K in tctc.LATTICE_K and 1 <= W <= tctc.LATTICE_MAX_WARPS
    owner = {}
    for w in range(W):
        for j in range(32):
            for k in range(K):
                owner.setdefault((32 * w + j) * K + k, []).append((w, j, k))
    assert all(len(owner.get(s, [])) == 1 for s in range(S))
    assert 32 * (W - 1) * K < S <= 32 * W * K


def test_lattice_plan_refuses_s_above_the_limit():
    assert tctc.LATTICE_MAX_S > 4097
    tctc.lattice_plan(tctc.LATTICE_MAX_S)
    with pytest.raises(ValueError, match=str(tctc.LATTICE_MAX_S)):
        tctc.lattice_plan(tctc.LATTICE_MAX_S + 1)
    with pytest.raises(ValueError):
        tctc.lattice_plan(0)


@pytest.mark.parametrize("wrapper", ["fwd", "bwd"])
def test_lattice_wrappers_refuse_s_above_the_limit(monkeypatch, wrapper):
    """On the card's route (the device check passed) a wrapper plans the
    launch before anything else and names the limit; no kernel is built."""
    monkeypatch.setattr(tctc, "_check_lattice", lambda *a: True)
    monkeypatch.setattr(tctc.kernels, "lib", lambda: pytest.fail("built"))
    S = tctc.LATTICE_MAX_S + 2
    lp = torch.zeros((1, 2, S))
    skip = torch.zeros((1, S), dtype=torch.bool)
    n = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match=str(tctc.LATTICE_MAX_S)):
        if wrapper == "fwd":
            tctc.ctc_lattice_fwd(lp, skip, n, n)
        else:
            tctc.ctc_lattice_bwd(lp, skip, n, n, lp, lp[:, 0, 0], lp[:, 0, 0])


def test_lattice_kernels_read_the_bool_flags_in_place():
    """The wrappers hand the kernels the bool skip flags' own bytes as uint8
    (a view: no copy, no launch); ``CTCLattice`` saves the bool flags for
    the backward, and the loss and its gradient are the plain versions'."""
    logits, labels, inl, lab = _case(8, in_lens=[20, 17, 14, 9],
                                     lab_lens=[6, 3, 0, 1])
    lp_ext, skip = tctc._lattice_inputs(torch.from_numpy(logits),
                                        torch.from_numpy(labels), 0)
    flags = tctc._skip_bytes(skip)
    assert flags.dtype == torch.uint8 and flags.data_ptr() == skip.data_ptr()
    assert torch.equal(flags, skip.to(torch.uint8))
    x = lp_ext.clone().requires_grad_()
    tin, tlab = torch.from_numpy(inl), torch.from_numpy(lab)
    nll = tctc.CTCLattice.apply(x, skip, tin, tlab)
    saved = nll.grad_fn.saved_tensors
    assert saved[1].dtype == torch.bool and torch.equal(saved[1], skip)
    nll.sum().backward()
    nll_w, alpha_w = tctc.ctc_lattice_fwd_reference(lp_ext, skip, tin, tlab)
    grad_w = tctc.ctc_lattice_bwd_reference(lp_ext, skip, tin, tlab, alpha_w,
                                            nll_w, torch.ones(4))
    torch.testing.assert_close(nll.detach(), nll_w, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, grad_w, rtol=0, atol=0)


@pytest.mark.parametrize("seed,in_lens,lab_lens",
                         [(9, [20, 11, 16, 20], [6, 2, 0, 4]),
                          (10, [20, 20, 8, 19], [6, 6, 3, 1])])
def test_lattice_plain_versions_take_bool_skip(seed, in_lens, lab_lens):
    """The plain versions take the bool flags that ``_lattice_inputs``
    makes, through the wrappers and alone, and match the Pallas kernels in
    interpret mode."""
    logits, labels, inl, lab = _case(seed, in_lens=in_lens, lab_lens=lab_lens)
    lp_ext, skip = tctc._lattice_inputs(torch.from_numpy(logits),
                                        torch.from_numpy(labels), 0)
    assert skip.dtype == torch.bool
    tin, tlab = torch.from_numpy(inl), torch.from_numpy(lab)
    g = torch.tensor([1.0, 0.5, 2.0, 0.25])
    nll, alpha = tctc.ctc_lattice_fwd(lp_ext, skip, tin, tlab)
    grad = tctc.ctc_lattice_bwd(lp_ext, skip, tin, tlab, alpha, nll, g)
    jl = [jnp.asarray(lp_ext.numpy()), jnp.asarray(skip.numpy()),
          jnp.asarray(inl), jnp.asarray(lab)]
    jnll, jalpha = jpallas._ctc_lattice_fwd_impl(*jl)
    jgrad = jpallas._ctc_lattice_bwd((*jl, jalpha, jnll),
                                     jnp.asarray(g.numpy()))[0]
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), **VAL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **GRAD)
    nll_b, _ = tctc.ctc_lattice_fwd_reference(lp_ext, skip, tin, tlab)
    torch.testing.assert_close(nll, nll_b, rtol=0, atol=0)


@pytest.mark.parametrize("wrapper", ["fwd", "bwd"])
def test_lattice_wrappers_refuse_uint8_skip(wrapper):
    """The skip flags are bool: a uint8 tensor is refused, not read."""
    lp = torch.zeros((1, 4, 3))
    skip = torch.zeros((1, 3), dtype=torch.uint8)
    n = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(TypeError, match="bool skip"):
        if wrapper == "fwd":
            tctc.ctc_lattice_fwd(lp, skip, n, n)
        else:
            tctc.ctc_lattice_bwd(lp, skip, n, n, lp, lp[:, 0, 0], lp[:, 0, 0])
