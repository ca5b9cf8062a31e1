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
from lipreading_tpu_torch.ops import flash_attention as fa


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
def test_ctc_lattice_bwd_clamps_input_length_above_t(cuda):
    """An input length above T counts as T in the kernel and in its plain
    version alike: the same gradient (rtol 1e-3 / atol 1e-5), not zeros."""
    lp, skip, inl, lab, _, _ = _lattice_case(11, 4, 20, 12, 6)
    inl = torch.tensor([20, 27, 14, 21], dtype=torch.int32)
    nll_w, alpha_w = ctc.ctc_lattice_fwd_reference(lp, skip, inl, lab)
    g = torch.linspace(0.5, 1.5, 4)
    grad_w = ctc.ctc_lattice_bwd_reference(lp, skip, inl, lab, alpha_w,
                                           nll_w, g)
    args = [x.to(cuda) for x in (lp, skip, inl, lab)]
    nll, alpha = ctc.ctc_lattice_fwd(*args)
    grad = ctc.ctc_lattice_bwd(*args, alpha, nll, g.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(nll.cpu(), nll_w, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(grad.cpu(), grad_w, rtol=1e-3, atol=1e-5)
    assert grad_w[1].abs().sum() > 0.1 and grad_w[3].abs().sum() > 0.1


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


# flash attention: max|kernel - plain| / max|plain| per output. float32:
# 2e-5, the JAX tests' limit (the kernels sum in other orders, and the fused
# backward adds dq with atomics in an order that changes from run to run);
# bf16: 1e-2, the outputs are float32 sums rounded to bf16 on both sides, so
# they differ by at most about one bf16 ulp (2^-8 of the largest values)
FLASH_REL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# (2, 33, 1, 12): a 24-byte row, not a multiple of TMA's 16 bytes, so the
# bf16 wrappers take their zero-padded copy (as Dh 100 does)
FLASH_CASES = [(2, 40, 2, 16, [40, 23]), (1, 13, 3, 8, [11]),
               (3, 130, 4, 64, [130, 64, 0]), (2, 77, 2, 100, [77, 5]),
               (4, 1024, 4, 64, [1024, 1000, 517, 0]),
               (2, 33, 1, 12, [33, 20])]


def _flash_case(seed, B, T, H, D, lengths, dtype):
    rng = np.random.default_rng(seed)

    def mk():
        return torch.from_numpy(
            rng.normal(0, 1, (B, T, H, D)).astype(np.float32)).to(dtype)

    return mk(), mk(), mk(), mk(), torch.tensor(lengths, dtype=torch.int32)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,D,lengths", FLASH_CASES)
def test_flash_kernels_match_plain(cuda, dtype, B, T, H, D, lengths):
    """The forward (with and without lse), the fused backward and the
    two-pass pair against their plain versions on the same inputs; one
    launch each; exact zeros for a sample of length 0."""
    q, k, v, g, ln = (x.to(cuda) for x in _flash_case(T + D, B, T, H, D,
                                                      lengths, dtype))
    before = [w.launches for w in fa.WRAPPERS]
    out = fa.flash_fwd(q, k, v, ln)
    out2, lse = fa.flash_fwd(q, k, v, ln, return_lse=True)
    want, lse_w = fa.flash_fwd_reference(q, k, v, ln, return_lse=True)
    gg, delta = fa.bwd_inputs(out2, g, ln)
    fused = fa.flash_bwd_fused(q, k, v, ln, gg, delta, lse)
    dq = fa.flash_bwd_dq(q, k, v, ln, gg, delta, lse)
    dkv = fa.flash_bwd_dkv(q, k, v, ln, gg, delta, lse)
    grads_w = fa.flash_bwd_fused_reference(q, k, v, ln, gg, delta, lse)
    torch.cuda.synchronize()
    assert [w.launches for w in fa.WRAPPERS] == [b + n for b, n in
                                                 zip(before, (2, 1, 1, 1))]
    tol = FLASH_REL[dtype]
    assert torch.equal(out, out2)
    assert _rel(out, want) <= tol
    assert _rel(lse, lse_w) <= 2e-5
    for got, w in zip((*fused, dq, *dkv), (*grads_w, *grads_w)):
        assert torch.isfinite(got.float()).all()
        assert _rel(got, w) <= tol
    for b, n in enumerate(lengths):
        if n == 0:
            for x in (out, *fused, dq, *dkv):
                assert x[b].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_fwd_long_clip_matches_plain(cuda):
    """The bf16 forward at T 8192 (the long shape of chip_smoke.py's
    [flash]) against its plain version: out within 1e-2, lse within 2e-5
    of the largest."""
    q, k, v, _, ln = (x.to(cuda) for x in _flash_case(
        8192, 2, 8192, 4, 64, [8192, 6001], torch.bfloat16))
    out, lse = fa.flash_fwd(q, k, v, ln, return_lse=True)
    want, lse_w = fa.flash_fwd_reference(q, k, v, ln, return_lse=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert _rel(out, want) <= FLASH_REL[torch.bfloat16]
    assert _rel(lse, lse_w) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("bwd", ["xla", "pallas", "fused"])
def test_flash_attention_grads_match_plain_on_the_cpu(cuda, bwd):
    """The autograd function on the card against the same function on the
    CPU (plain versions there), float32: values and grads within 2e-5 of the
    largest."""
    q, k, v, g, ln = _flash_case(3, 2, 200, 4, 64, [200, 131],
                                 torch.float32)
    res = []
    for dev in ("cpu", cuda):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves, ln.to(dev), bwd=bwd)
        out.backward(g.to(dev))
        res.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for a, b in zip(res[1], res[0]):
        assert _rel(a, b) <= 2e-5


@pytest.mark.cuda
def test_flash_rejects_mixed_devices(cuda):
    q, k, v, _, ln = _flash_case(0, 1, 8, 1, 8, [8], torch.float32)
    with pytest.raises(ValueError):
        fa.flash_fwd(q.to(cuda), k.to(cuda), v.to(cuda), ln)
    with pytest.raises(TypeError):
        fa.flash_fwd(*(x.to(cuda) for x in (q, k, v)), ln.to(cuda)[:0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,D,lengths",
                         [(4, 1024, 4, 64, [1024, 1000, 517, 0]),
                          (2, 77, 2, 100, [77, 5])])
def test_flash_two_pass_is_bit_identical(cuda, dtype, B, T, H, D, lengths):
    """The two-pass backward writes dq, dk and dv without atomics, in a
    fixed order: two launches on the same inputs give the same bytes."""
    q, k, v, g, ln = (x.to(cuda) for x in _flash_case(T + D, B, T, H, D,
                                                      lengths, dtype))
    out, lse = fa.flash_fwd(q, k, v, ln, return_lse=True)
    gg, delta = fa.bwd_inputs(out, g, ln)
    runs = [(fa.flash_bwd_dq(q, k, v, ln, gg, delta, lse),
             *fa.flash_bwd_dkv(q, k, v, ln, gg, delta, lse))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,D,lengths", [(2, 33, 1, 12, [33, 20]),
                                             (2, 77, 2, 100, [77, 5])])
def test_flash_pallas_policy_takes_the_padded_copy(cuda, B, T, H, D, lengths):
    """bf16 head dims whose rows are not a multiple of 16 bytes (Dh 12) or
    that end mid-box (Dh 100), through the autograd function with
    ``bwd="pallas"``: one launch of each pass, grads within 1e-2 of the
    plain backward on the forward kernel's out and lse."""
    q, k, v, g, ln = (x.to(cuda) for x in _flash_case(T + D, B, T, H, D,
                                                      lengths,
                                                      torch.bfloat16))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = [w.launches for w in fa.WRAPPERS]
    fa.flash_attention(*leaves, ln, bwd="pallas").backward(g)
    torch.cuda.synchronize()
    assert [w.launches for w in fa.WRAPPERS] == [b + n for b, n in
                                                 zip(before, (1, 0, 1, 1))]
    out, lse = fa.flash_fwd(q, k, v, ln, return_lse=True)
    gg, delta = fa.bwd_inputs(out, g, ln)
    want = fa._bwd_reference(q, k, v, ln, gg, delta, lse)
    for x, w in zip(leaves, want):
        assert x.grad.shape == w.shape
        assert torch.isfinite(x.grad.float()).all()
        assert _rel(x.grad, w) <= FLASH_REL[torch.bfloat16]


@pytest.mark.cuda
def test_flash_two_pass_long_clip_matches_plain(cuda):
    """The bf16 two-pass backward at T 8192 (the long shape of
    chip_smoke.py's [flash]) against its plain versions: dq, dk, dv within
    1e-2 of the largest."""
    q, k, v, g, ln = (x.to(cuda) for x in _flash_case(
        8193, 2, 8192, 4, 64, [8192, 6001], torch.bfloat16))
    out, lse = fa.flash_fwd(q, k, v, ln, return_lse=True)
    gg, delta = fa.bwd_inputs(out, g, ln)
    got = (fa.flash_bwd_dq(q, k, v, ln, gg, delta, lse),
           *fa.flash_bwd_dkv(q, k, v, ln, gg, delta, lse))
    want = fa._bwd_reference(q, k, v, ln, gg, delta, lse)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.isfinite(a.float()).all()
        assert _rel(a, w) <= FLASH_REL[torch.bfloat16]
