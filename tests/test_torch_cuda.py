"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a CUDA device (or without nvcc) each test
skips with its reason, decided inside the ``cuda`` fixture, never at import.

    python -m pytest --noconftest tests/test_torch_cuda.py   # on the GPU machine

Off the card the one test that runs is the build's refusal to fall back."""

import numpy as np
import pytest
import torch

from lipreading_tpu_torch import kernels
from lipreading_tpu_torch.ops import ctc, decode, roi


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the GPU")
    kernels.lib()          # builds with nvcc at first use; raises on failure
    return torch.device("cuda")


def _gray_and_boxes(seed, n, subpixel, H=160, W=160):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 255, size=(n, H, W)).astype(np.float32)
    s = rng.uniform(4, 100, size=n)
    x = rng.uniform(-6, W - 4, size=n)
    y = rng.uniform(-6, H - 4, size=n)
    b = np.stack([x, y, s], 1)
    if not subpixel:
        b = np.floor(b).astype(np.int32)
        b[:, 2] = np.maximum(b[:, 2], 2)
        b[0] = (0, 0, 2)
        b[1] = (W - 3, H - 3, 3)
    return torch.from_numpy(g), torch.from_numpy(b.astype(
        np.float32 if subpixel else np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("n,R", [(512, 96), (3, 32)])
def test_roi_kernel_matches_plain(cuda, subpixel, n, R):
    """Tolerance 1e-5 on normalised values (1e-4 on raw pixel values in
    0..255): the kernel adds the two taps in another order than the dense
    float32 product, and the product may fuse a multiply-add."""
    g, b = _gray_and_boxes(n, n, subpixel)
    g, b = g.to(cuda), b.to(cuda)
    for normalize, tol in ((True, 1e-5), (False, 1e-4)):
        before = roi.sample_rois.launches
        got = roi.sample_rois(g, b, R, normalize=normalize, subpixel=subpixel)
        assert roi.sample_rois.launches == before + 1
        want = roi.sample_rois_reference(g, b, R, normalize=normalize,
                                         subpixel=subpixel)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V", [(8, 96, 31), (3, 1, 31), (4, 16, 31),
                                   (2, 128, 31), (3, 1000, 31), (2, 300, 7)])
def test_greedy_kernel_matches_plain(cuda, B, T, V):
    g = torch.Generator().manual_seed(T)
    logits = torch.randint(0, 3, (B, T, V), generator=g).float()
    lengths = torch.randint(0, T + 1, (B,), generator=g, dtype=torch.int32)
    lengths[0], lengths[-1] = 0, T
    want = decode.ctc_greedy_ids_reference(logits, lengths)
    before = decode.ctc_greedy_ids.launches
    got = decode.ctc_greedy_ids(logits.to(cuda), lengths.to(cuda))
    assert decode.ctc_greedy_ids.launches == before + 1
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)


@pytest.mark.cuda
def test_kernels_reject_mixed_devices(cuda):
    with pytest.raises(ValueError):
        roi.sample_rois(torch.zeros((1, 8, 8), device=cuda),
                        torch.zeros((1, 3), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        decode.ctc_greedy_ids(torch.zeros((1, 4, 5), device=cuda),
                              torch.zeros((1,), dtype=torch.int32))


def _lattice_case(seed, B, T, V, L, infeasible=False):
    """Log-probs on the lattice of random labels (with repeats), mixed input
    lengths (one < T, one = T) and label lengths (one 0)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (B, T, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    labels[:, 1] = labels[:, 0]                       # a repeat: no skip
    lab = rng.integers(0, L + 1, B).astype(np.int32)
    lab[0], lab[-1] = 0, L
    inl = np.maximum(2 * lab + 1, rng.integers(1, T + 1, B)).astype(np.int32)
    inl = np.minimum(inl, T)
    inl[-1], inl[0] = T, max(1, T // 3)
    if infeasible:
        lab[1], inl[1] = L, max(1, min(T, 2 * L) // 2)
    lp_ext, skip = ctc._lattice_inputs(torch.from_numpy(logits),
                                       torch.from_numpy(labels), 0)
    return (lp_ext, skip, torch.from_numpy(inl), torch.from_numpy(lab),
            logits, labels)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V,L", [(8, 128, 31, 40), (3, 1, 31, 4),
                                     (4, 20, 12, 6), (2, 300, 31, 150)])
@pytest.mark.parametrize("infeasible", [False, True])
def test_ctc_lattice_kernels_match_plain(cuda, B, T, V, L, infeasible):
    """nll rtol 1e-5 (the kernel and the plain version add the same terms in
    the same order; expf and log1pf differ from the CPU's libm by ulps over
    T steps); grads rtol 1e-3 / atol 1e-5, the limits of
    tests/test_ctc_pallas.py. S = 301 (L = 150) takes two chunks of the
    256-thread block."""
    lp, skip, inl, lab, _, _ = _lattice_case(T + L, B, T, V, L, infeasible)
    nll_w, alpha_w = ctc.ctc_lattice_fwd_reference(lp, skip, inl, lab)
    g = torch.linspace(0.5, 1.5, B)
    grad_w = ctc.ctc_lattice_bwd_reference(lp, skip, inl, lab, alpha_w,
                                           nll_w, g)
    before = (ctc.ctc_lattice_fwd.launches, ctc.ctc_lattice_bwd.launches)
    args = [x.to(cuda) for x in (lp, skip, inl, lab)]
    nll, alpha = ctc.ctc_lattice_fwd(*args)
    grad = ctc.ctc_lattice_bwd(*args, alpha, nll, g.to(cuda))
    torch.cuda.synchronize()
    assert (ctc.ctc_lattice_fwd.launches, ctc.ctc_lattice_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.isfinite(nll).all() and torch.isfinite(grad).all()
    torch.testing.assert_close(nll.cpu(), nll_w, rtol=1e-5, atol=1e-4)
    feasible = 2 * lab + 1 <= inl       # infeasible: nll ~1e30, grads finite
    torch.testing.assert_close(grad.cpu()[feasible], grad_w[feasible],
                               rtol=1e-3, atol=1e-5)
    for b in range(B):                  # exactly zero past the input length
        assert grad.cpu()[b, int(inl[b]):].abs().sum().item() == 0.0


@pytest.mark.cuda
def test_ctc_loss_lattice_grads_match_plain_ctc_loss(cuda):
    """The autograd function on the card against the plain ctc_loss on the
    CPU: values rtol 1e-5, logit grads rtol 1e-3 / atol 1e-5."""
    _, _, inl, lab, logits, labels = _lattice_case(7, 8, 128, 31, 40)
    x = torch.from_numpy(logits).requires_grad_()
    ctc.ctc_loss(x, torch.from_numpy(labels), inl, lab).sum().backward()
    xc = torch.from_numpy(logits).to(cuda).requires_grad_()
    nll = ctc.ctc_loss_best(xc, torch.from_numpy(labels).to(cuda),
                            inl.to(cuda), lab.to(cuda))
    nll.sum().backward()
    want = ctc.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        inl, lab)
    torch.testing.assert_close(nll.detach().cpu(), want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(xc.grad.cpu(), x.grad, rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_ctc_lattice_rejects_mixed_devices(cuda):
    lp, skip, inl, lab, _, _ = _lattice_case(0, 2, 8, 5, 2)
    with pytest.raises(ValueError):
        ctc.ctc_lattice_fwd(lp.to(cuda), skip.to(cuda), inl, lab.to(cuda))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a machine without nvcc gets an error that says
    so, not the plain version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
