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
@pytest.mark.parametrize("n", [960, 1536])
def test_roi_kernel_at_the_face_crop_shape(cuda, n):
    """The conv landmarker's crop: R 64, integer face boxes of 40-160 px,
    normalize=0 (raw pixel values, tolerance 1e-4 as above)."""
    rng = np.random.default_rng(n)
    g = torch.from_numpy(rng.uniform(0, 255, (n, 160, 160)).astype(
        np.float32)).to(cuda)
    s = rng.integers(40, 161, n)
    b = np.stack([rng.integers(0, 161 - s), rng.integers(0, 161 - s), s], 1)
    b = torch.from_numpy(b.astype(np.int32)).to(cuda)
    before = roi.sample_rois.launches
    got = roi.sample_rois(g, b, 64, normalize=False)
    assert roi.sample_rois.launches == before + 1
    want = roi.sample_rois_reference(g, b, 64, normalize=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_tracked_conv_preprocess_on_the_card_matches_the_cpu(cuda):
    """Tracked preprocessing with the conv landmarker on the cutaway and
    second-face clips: valid equal, face boxes within 1e-3 px, ROIs within
    1e-4; two ROI launches a call."""
    from lipreading_tpu_torch import io
    from lipreading_tpu_torch.config import PreprocessConfig
    from lipreading_tpu_torch.fixtures import (
        blank_out_frames,
        make_clip,
        paste_second_face,
    )
    from lipreading_tpu_torch.ops import detector, landmarker, preprocess

    frames = np.stack([blank_out_frames(make_clip(61), [4, 5, 6], seed=2)[:12],
                       paste_second_face(make_clip(62), donor_seed=901)[:12]])
    det_np, _ = io.load_assets()
    cfg = PreprocessConfig(landmarker="conv")
    out = {}
    for dev in (torch.device("cpu"), cuda):
        before = roi.sample_rois.launches
        out[dev.type] = preprocess.preprocess_clips_tracked(
            detector.params_to_torch(det_np, dev),
            detector.params_to_torch(io.load_presence(), dev),
            landmarker.params_to_torch(io.load_landmarker(), dev),
            torch.as_tensor(frames, device=dev), cfg, return_aux=True)
        if dev.type == "cuda":
            assert roi.sample_rois.launches == before + 2
    (cr, cv, ca), (gr, gv, ga) = out["cpu"], out["cuda"]
    assert torch.equal(gv.cpu(), cv)
    assert cv[0].tolist() == [t not in (4, 5, 6) for t in range(12)]
    torch.testing.assert_close(ga["face_boxes"].cpu(), ca["face_boxes"],
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(gr.cpu(), cr, rtol=0, atol=1e-4)


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


# (N, H, W, R): the long-clip batch (N 4096), an R that is not a multiple
# of 4 on frames whose rows are not 16-byte aligned (W 161), R 1 and 2
ROI_EDGE_SHAPES = [(4096, 160, 160, 96), (64, 120, 161, 97), (16, 160, 161, 1),
                   (8, 33, 161, 2)]


def _edge_boxes(seed, n, subpixel, H, W):
    """Random boxes plus boxes on and past every edge of the frame."""
    g, b = _gray_and_boxes(seed, n, subpixel, H, W)
    edges = [(0, 0, 2), (W - 3, H - 3, 3), (-4, H - 10, 12), (W - 10, -4, 12),
             (0, 0, min(H, W)), (W - 2, 0, 2)]
    if subpixel:
        edges += [(-10.5, -10.5, 30.0), (W - 5.25, H - 5.25, 30.0)]
    for i, e in enumerate(edges[:n]):
        b[-1 - i] = torch.tensor(e, dtype=b.dtype)
    return g, b


@pytest.mark.cuda
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("N,H,W,R", ROI_EDGE_SHAPES)
def test_roi_kernel_edge_shapes_match_plain(cuda, subpixel, N, H, W, R):
    """The limits of test_roi_kernel_matches_plain; two launches give the
    same bytes (no atomics)."""
    g, b = _edge_boxes(N + R, N, subpixel, H, W)
    g, b = g.to(cuda), b.to(cuda)
    for normalize, tol in ((True, 1e-5), (False, 1e-4)):
        got = roi.sample_rois(g, b, R, normalize=normalize, subpixel=subpixel)
        again = roi.sample_rois(g, b, R, normalize=normalize,
                                subpixel=subpixel)
        want = roi.sample_rois_reference(g, b, R, normalize=normalize,
                                         subpixel=subpixel)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_roi_div255_equals_the_division(cuda):
    """The kernel's / 255 (a reciprocal and one fused correction) gives the
    bits of __fdiv_rn(x, 255) on every float (two NaNs count as equal)."""
    differ = torch.zeros(3, dtype=torch.int32, device=cuda)
    kernels.check(kernels.lib().roi_div255_check(
        differ.data_ptr(), kernels.stream_ptr(cuda)), "roi_div255_check")
    assert differ.tolist() == [0, 0, 0]


# (B, T, V): the long clips (T 1024, one chunk), a chunk and one frame
# (T 1025), double-buffered chunks (T 4096), utterance starts that are not
# 16-byte aligned (B 5 x T 3 x V 7), an even V (a padded row), and V 2000
# (a warp a frame)
GREEDY_EDGE_SHAPES = [(4, 1024, 31), (3, 1025, 31), (2, 4096, 31), (5, 3, 7),
                      (3, 200, 8), (3, 40, 2000), (2, 1100, 2000)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V", GREEDY_EDGE_SHAPES)
def test_greedy_kernel_edge_shapes_match_plain(cuda, B, T, V):
    """Exact ids and counts with many ties and rows holding NaN (the first
    NaN counts as the maximum, as in torch.argmax); two launches give the
    same bytes."""
    g = torch.Generator().manual_seed(B * T + V)
    logits = torch.randint(0, 3, (B, T, V), generator=g).float()
    nan_t = torch.randint(0, T, (B, max(1, T // 7)), generator=g)
    nan_v = torch.randint(0, V, nan_t.shape, generator=g)
    logits[torch.arange(B)[:, None], nan_t, nan_v] = float("nan")
    lengths = torch.randint(0, T + 1, (B,), generator=g, dtype=torch.int32)
    lengths[0], lengths[-1] = 0, T
    want = decode.ctc_greedy_ids_reference(logits, lengths)
    got = decode.ctc_greedy_ids(logits.to(cuda), lengths.to(cuda))
    again = decode.ctc_greedy_ids(logits.to(cuda), lengths.to(cuda))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_c_entries_refuse_a_bad_plan(cuda):
    """A plan that would miss a pixel or a frame, break the carry between
    chunks or overrun shared memory is refused before any launch."""
    lib, st = kernels.lib(), kernels.stream_ptr(cuda)
    g, b = _gray_and_boxes(0, 4, False, 160, 160)
    g, b = g.to(cuda), b.to(cuda)
    out = torch.empty((4, 96, 96), device=cuda)
    p = roi.roi_plan(4, 96)

    def roi_entry(tpr, rpp, band, threads, smem):
        return lib.roi_sample(g.data_ptr(), b.data_ptr(), out.data_ptr(), 4,
                              160, 160, 96, 0.421, 0.165, 1, 0, tpr, rpp,
                              band, threads, smem, st)

    assert roi_entry(p.tpr, p.rpp, p.band, p.threads, p.smem) == 0
    for bad in ((p.tpr, p.rpp + 1, p.band, p.threads, p.smem),   # a row
                (p.tpr, p.rpp, p.band, 512, p.smem),         # launch bound
                (p.tpr, p.rpp, p.band, p.threads, 64)):      # no tap room
        assert roi_entry(*bad) < 0, bad
    lg = torch.zeros((2, 100, 31), device=cuda)
    ln = torch.full((2,), 100, dtype=torch.int32, device=cuda)
    ids = torch.empty((2, 100), dtype=torch.int32, device=cuda)
    cnt = torch.empty((2,), dtype=torch.int32, device=cuda)
    q = decode.greedy_plan(100, 31)

    def greedy_entry(sV, chunk, nbuf, buf, threads, smem):
        return lib.ctc_greedy(lg.data_ptr(), ln.data_ptr(), ids.data_ptr(),
                              cnt.data_ptr(), 2, 100, 31, 0, sV, chunk, nbuf,
                              buf, threads, smem, st)

    assert greedy_entry(*q) == 0
    for bad in ((32, *q[1:]),                            # odd V, padded
                (q.sV, 64, 1, q.buf_floats, 64, q.smem),  # one buffer, 2 chunks
                (q.sV, 40, 2, q.buf_floats, 64, q.smem),  # carry, partial chunk
                (q.sV, q.chunk, 1, 8, q.threads, q.smem),  # buffer too small
                (*q[:5], 4 * q.buf_floats - 4)):           # smem too small
        assert greedy_entry(*bad) < 0, bad
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_noop_kernel_launches(cuda):
    kernels.check(kernels.lib().noop_kernel(kernels.stream_ptr(cuda)),
                  "noop_kernel")
    torch.cuda.synchronize()


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


# (B, T, V, L): the release's training shape (S 81, two warps of K 2); a
# single frame and a small vocabulary (one warp); S 121, 301, 601 and the
# long-clip fine-tuning shape B 4 x T 1024 x S 513 (skips across lanes and
# warps); S 1025 (17 warps of K 2), 2049 (K 4), 4097 (K 6) and 6143, the
# largest S the plans reach (32 warps of K 6, the backward's largest ring)
LATTICE_SHAPES = [(8, 128, 31, 40), (3, 1, 31, 4), (4, 20, 12, 6),
                  (3, 160, 31, 60), (2, 300, 31, 150), (3, 700, 31, 300),
                  (4, 1024, 31, 256), (2, 1100, 31, 512), (2, 2100, 31, 1024),
                  (2, 4200, 31, 2048), (2, 6200, 31, 3071)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V,L", LATTICE_SHAPES)
@pytest.mark.parametrize("infeasible", [False, True])
def test_ctc_lattice_kernels_match_plain(cuda, B, T, V, L, infeasible):
    """nll rtol 1e-5 (the kernel and the plain version add the same terms in
    the same order; expf and log1pf differ from the CPU's libm by ulps over
    T steps); grads rtol 1e-3 / atol 1e-5, the limits of
    tests/test_ctc_pallas.py. Every K of ``ctc.lattice_plan`` is here, with
    one warp and with several."""
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
@pytest.mark.parametrize("B,T,V,L", [(4, 60, 12, 20), (2, 400, 31, 200)])
def test_ctc_lattice_kernels_take_any_skip_flags(cuda, B, T, V, L):
    """Skip flags on blank states too (which ``_lattice_inputs`` never sets;
    the kernels then take their second copy of the step loop): kernel
    against plain, the limits of ``test_ctc_lattice_kernels_match_plain``."""
    lp, skip, inl, lab, _, _ = _lattice_case(B * L, B, T, V, L)
    skip = skip.clone()
    skip[:, 2::6] = True                                 # blank states
    g = torch.linspace(0.5, 1.5, B)
    nll_w, alpha_w = ctc.ctc_lattice_fwd_reference(lp, skip, inl, lab)
    grad_w = ctc.ctc_lattice_bwd_reference(lp, skip, inl, lab, alpha_w,
                                           nll_w, g)
    args = [x.to(cuda) for x in (lp, skip, inl, lab)]
    nll, alpha = ctc.ctc_lattice_fwd(*args)
    grad = ctc.ctc_lattice_bwd(*args, alpha, nll, g.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(nll.cpu(), nll_w, rtol=1e-5, atol=1e-4)
    feasible = 2 * lab + 1 <= inl
    torch.testing.assert_close(grad.cpu()[feasible], grad_w[feasible],
                               rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,V,L", [(8, 128, 31, 40), (4, 1024, 31, 256)])
def test_ctc_lattice_is_bit_identical(cuda, B, T, V, L):
    """No atomics: two launches of each kernel give the same bytes."""
    lp, skip, inl, lab, _, _ = _lattice_case(B + L, B, T, V, L)
    args = [x.to(cuda) for x in (lp, skip, inl, lab)]
    g = torch.linspace(0.5, 1.5, B, device=cuda)
    outs = []
    for _ in range(2):
        nll, alpha = ctc.ctc_lattice_fwd(*args)
        outs.append((nll, alpha, ctc.ctc_lattice_bwd(*args, alpha, nll, g)))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
def test_ctc_lattice_refuses_plans_it_was_not_built_for(cuda):
    """Above ``LATTICE_MAX_S`` the wrappers raise and name the limit; the C
    entries refuse a K they were not built for, or too few warps for S,
    and the check raises on that."""
    S = ctc.LATTICE_MAX_S + 2
    lp = torch.zeros((1, 2, S), device=cuda)
    skip = torch.zeros((1, S), dtype=torch.bool, device=cuda)
    n = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=str(ctc.LATTICE_MAX_S)):
        ctc.ctc_lattice_fwd(lp, skip, n, n)
    lp, skip, inl, lab, _, _ = _lattice_case(3, 2, 10, 12, 6)
    lp, skip, inl, lab = (x.to(cuda) for x in (lp, skip, inl, lab))
    out = torch.empty_like(lp)
    nll = torch.empty((2,), device=cuda)
    for W, K in ((1, 3), (1, 8), (0, 2), (33, 2)):
        err = kernels.lib().ctc_lattice_fwd(
            lp.data_ptr(), skip.view(torch.uint8).data_ptr(),
            inl.data_ptr(), lab.data_ptr(), out.data_ptr(), nll.data_ptr(),
            2, 10, 13, W, K, kernels.stream_ptr(cuda))
        with pytest.raises(RuntimeError, match="plan"):
            kernels.check(err, "ctc_lattice_fwd")


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


@pytest.mark.cuda
def test_cascade_on_the_card_matches_the_cpu(cuda):
    """The universal4 cascade (beam 8, LM 0.4) on two fixture clips, from
    frames: every clip through the joint beam (margin=inf) and at the
    default margins, card against CPU; a cascade call launches the greedy
    kernel once and no CTC lattice kernel."""
    from lipreading_tpu_torch import infer, io
    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch
    from lipreading_tpu_torch.ops.preprocess import preprocess_clips

    clips = [make_clip(s) for s in (101, 107)]
    T = -(-max(len(c.frames) for c in clips) // 32) * 32
    frames = np.zeros((2, T) + clips[0].frames.shape[1:], np.uint8)
    for b, c in enumerate(clips):
        frames[b, :len(c.frames)] = c.frames
    lengths = np.asarray([len(c.frames) for c in clips], np.int32)
    det_np, ert_np = io.load_assets()
    out = {}
    for dev in (torch.device("cpu"), cuda):
        model, cfg = io.load_release_model(device=dev)
        rois = preprocess_clips(params_to_torch(det_np, dev),
                                model_to_torch(ert_np, dev),
                                torch.as_tensor(frames, device=dev),
                                cfg.preprocess)
        for margin in (float("inf"), 8.0):
            greedy = decode.ctc_greedy_ids.launches
            lattice = (ctc.ctc_lattice_fwd.launches
                       + ctc.ctc_lattice_bwd.launches)
            texts, flags = infer.transcribe_cascade(
                model, cfg, rois, lengths, beam=8, lm_weight=0.4,
                margin=margin, return_flags=True)
            if dev.type == "cuda":
                assert decode.ctc_greedy_ids.launches == greedy + 1
                assert (ctc.ctc_lattice_fwd.launches
                        + ctc.ctc_lattice_bwd.launches) == lattice
            out[dev.type, margin] = (texts, flags.tolist())
    for margin in (float("inf"), 8.0):
        assert out["cuda", margin] == out["cpu", margin]
    assert out["cuda", 8.0][0] == out["cuda", float("inf")][0]


@pytest.mark.cuda
def test_viterbi_on_the_card_matches_the_cpu(cuda):
    """``ctc_viterbi_align`` on a seeded batch with repeated labels and
    ragged input and label lengths (one of 0, one infeasible): the card's
    paths equal the CPU's exactly."""
    g = torch.Generator().manual_seed(3)
    B, T, V, L = 5, 64, 31, 24
    lp = torch.log_softmax(2 * torch.randn(B, T, V, generator=g), -1)
    labels = torch.randint(3, V, (B, L), generator=g, dtype=torch.int32)
    labels[:, 2] = labels[:, 1]
    in_len = torch.tensor([64, 40, 17, 64, 9], dtype=torch.int32)
    lab_len = torch.tensor([24, 10, 0, 5, 12], dtype=torch.int32)
    want = ctc.ctc_viterbi_align(lp, labels, in_len, lab_len)
    got = ctc.ctc_viterbi_align(lp.to(cuda), labels.to(cuda),
                                in_len.to(cuda), lab_len.to(cuda))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_stream_on_the_card_matches_the_cpu(cuda):
    """The quality stream of ``stream_latency`` (universal4, tracked with
    ``cut_flush``, beam 4, LM 0.4, window 64, chunks of 8, robust assets)
    over make_clip(33001) and (33002) back to back: every feed's
    transcript card equal to CPU; one ROI launch a chunk and one more a
    re-acquire at the cut."""
    from lipreading_tpu_torch import io, stream_latency
    from lipreading_tpu_torch.fixtures import make_clip

    frames = np.concatenate([make_clip(s).frames for s in (33001, 33002)])
    out = {}
    for dev in (torch.device("cpu"), cuda):
        model, cfg = io.load_release_model(device=dev)
        prep = io.load_preprocessors(cfg.preprocess.landmarker, "robust",
                                     tracked=True, device=dev)
        st = stream_latency.build("quality", model, cfg, prep, 64, 8, 4, 0.4)
        before = roi.sample_rois.launches
        text, _, _, hyps = stream_latency.run_stream(st, frames, 8)
        out[dev.type] = (text, hyps)
        if dev.type == "cuda":
            assert st.cut_events == 1
            assert (roi.sample_rois.launches - before
                    == len(hyps) + st.cut_events)
    assert out["cuda"] == out["cpu"]


def _weights_rel(a: dict, b: dict) -> float:
    """|a - b| / |b| over all the weights of two numpy dicts."""
    num = sum(float(((a[k] - b[k]).astype(np.float64) ** 2).sum()) for k in b)
    den = sum(float((b[k].astype(np.float64) ** 2).sum()) for k in b)
    return (num / den) ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("trainer", ["detector", "presence", "landmarker",
                                     "landmarker_roi"])
def test_preproc_trainers_first_steps_match_the_cpu(cuda, trainer):
    """3 steps of each preprocessor trainer at batch 64 (the presence head
    full batch) from one start and the same numpy indices: the weights card
    against CPU within 1e-4 of their norm (float32 sums in other orders; a
    step moves them ~1e-3 to 1e-2 of their norm), and the landmarker's
    teacher pass one ROI launch a 512 frames."""
    from lipreading_tpu_torch import io
    from lipreading_tpu_torch import preproc_training as pt
    from lipreading_tpu_torch.fixtures import make_clip, render_faceless_frames

    det, ert = io.load_assets()
    clips = [make_clip(9100 + i) for i in range(2)]
    if trainer == "detector":
        gray, boxes, _ = pt._collect_frames(clips, stride=1)

        def run(d):
            return pt.train_detector(gray, boxes, steps=3, device=d)
    elif trainer == "presence":
        gray, boxes, _ = pt._collect_frames(clips, stride=2)
        neg = render_faceless_frames(5, 12).astype(np.float32).mean(-1)

        def run(d):
            feats, y = pt.presence_features(det, gray, neg, boxes, d)
            init = pt.init_presence_head(feats.shape[-1], 0)
            return pt.fit_presence_head(init, feats, y, steps=3)
    else:
        w = 1.0 if trainer == "landmarker_roi" else 0.0

        def run(d):
            return pt.train_conv_landmarker(det, ert, clips, steps=3,
                                            roi_loss_weight=w, verbose=False,
                                            device=d)
    before = roi.sample_rois.launches
    got = run("cuda")
    launched = roi.sample_rois.launches - before
    frames = sum(c.num_frames for c in clips)
    assert launched == (-(-frames // pt.TEACHER_CHUNK)
                        if trainer.startswith("landmarker") else 0)
    assert _weights_rel(got, run("cpu")) <= 1e-4


@pytest.mark.cuda
def test_dp2_tp2_ranks_sharing_the_card_match_one_process(cuda, tmp_path):
    """4 ranks on cuda:0 over gloo (host-staged collectives), DP 2 x TP 2,
    3 steps of the small patchify model on ragged batches, against the
    one-process trainer on the card: gradients per leaf within 1e-4 of the
    leaf's largest entry plus 1e-7 (the CPU tests' 1e-5 is too tight here:
    cuDNN's weight gradient of the stem's convolutions sums 4 rows and 8 in
    other orders, 2.6e-5 apart on the card), losses and norms within 1e-5,
    the parameters after (the k biases aside: their true gradient is 0),
    the ranks' parameters byte-equal; the checkpoint restores the whole
    state to the byte, and a step from it stays within 1e-4 of an
    uninterrupted one (on the card two runs of one step are not bitwise
    equal: 1.58e-5 apart with cuDNN deterministic; the CPU test holds the
    resume bit-identical)."""
    # the tests' directory is on sys.path (pytest's prepend import mode):
    # a package named ``tests`` elsewhere may shadow the repo's
    from torch_dist_work import (
        ragged_batch,
        run_steps,
        small_cfg,
        spawn,
        trainer_cases,
    )

    from lipreading_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = small_cfg()
    batches = [ragged_batch(i) for i in range(3)]
    ranks = spawn(4, trainer_cases,
                  (cfg.to_dict(), batches, str(tmp_path / "ranks"), None,
                   "cuda:0", ("dp2tp2",)), str(tmp_path / "spawn"))
    ref = run_steps(Trainer(cfg, str(tmp_path / "one"), device="cuda"),
                    batches)
    for o in ranks:
        got = o["dp2tp2"]
        for name, want in ref["grads"].items():
            err = np.abs(got["grads"][name] - want).max()
            assert err <= 1e-4 * np.abs(want).max() + 1e-7, (name, err)
        for name, want in ref["params"].items():
            if not name.endswith(".k.b"):
                err = np.abs(got["params"][name] - want).max()
                assert err <= 1e-4 * np.abs(want).max() + 1e-7, (name, err)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
        assert got["digest"] == ranks[0]["dp2tp2"]["digest"]
        assert o["resume_state_equal"]
        assert o["resume_rel"] <= 1e-4, o["resume_rel"]


def _smoke():
    """``chip_smoke.py`` (the repository root is on the path under
    ``python -m pytest``)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_parity_gate_release_and_seeded_legs_on_the_card(cuda):
    """``[parity-gate]``: the full-width float32 ``bigru_ctc`` release
    through the reference-shaped model, greedy (kernel 2) and prefix beam 16
    string-identical to the reference on the CPU, the four seeded legs, the
    swapped-gate fault caught; kernel 2 launched once a greedy call."""
    smoke = _smoke()
    rows = [{"name": "ctc_greedy"}]
    tf32 = torch.backends.cudnn.allow_tf32
    smoke.phase_parity_gate(rows)
    assert rows[0]["launches_by_path"]["parity-gate"] == 2
    assert torch.backends.cudnn.allow_tf32 == tf32       # restored


@pytest.mark.cuda
def test_oracle_leg_on_the_card(cuda):
    """``[oracle]``: the golden dump exactly, the card's preprocess (kernel
    1) against the per-frame oracle with the shifted-box fault caught, the
    host C++ oracle, a capture naming the ROI kernel."""
    smoke = _smoke()
    rows = [{"name": "roi_sampler"}]
    smoke.phase_oracle("", rows)
    assert rows[0]["launches_by_path"]["oracle"] == 1


@pytest.mark.cuda
def test_card_timing_helpers(cuda):
    """``profiling.cuda_ms`` and ``device_kernels`` on a matrix product:
    positive device time, at least one device kernel recorded and within
    the call's wall time, CPU tensors refused."""
    from lipreading_tpu_torch import profiling

    a = torch.randn(1024, 1024, device=cuda)
    ms = profiling.cuda_ms(torch.matmul, a, a, reps=5)
    assert 0 < ms < 100
    wall, split = profiling.device_kernels(torch.matmul, a, a)
    assert 0 < sum(split.values()) <= wall
    with pytest.raises(ValueError):
        profiling.cuda_ms(torch.matmul, a.cpu(), a.cpu())


# (B, T, H, W, kernel, Cin, Cout): ragged last blocks, channels padded to 8,
# every N tile, a Cout chunk cut short, kernels without spatial or time
# taps, then the stems' four shapes at a cut batch
DGRAD_CASES = [(1, 5, 7, 9, (3, 5, 5), 8, 16), (2, 3, 5, 5, (3, 3, 3), 24, 40),
               (1, 4, 6, 6, (1, 1, 1), 300, 72),
               (3, 2, 4, 3, (3, 1, 3), 96, 200), (1, 7, 3, 2, (5, 1, 1), 5, 3),
               (2, 8, 24, 24, (3, 5, 5), 32, 64),
               (2, 8, 12, 12, (3, 3, 3), 64, 96),
               (2, 8, 6, 6, (3, 3, 3), 256, 256),
               (2, 8, 3, 3, (3, 3, 3), 256, 256)]


def _dgrad_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,W,kernel,cin,cout", DGRAD_CASES)
def test_conv3d_dgrad_matches_plain(cuda, B, T, H, W, kernel, cin, cout):
    """The kernel against the plain version (float32 sums of the same bf16
    operands, in another order): within 2^-6 of the largest value. Each
    side rounds its float32 sum to bf16 once, so the two are at most one
    bf16 ulp apart, which is at most 2^-7 of the largest value; twice that
    for room. Two launches the same bytes, one launch counted."""
    from lipreading_tpu_torch.models import nn as lnn

    g = torch.Generator().manual_seed(B * 1000 + H * 10 + cin)
    dy = torch.randn((B, T, H, W, cout), generator=g).to(torch.bfloat16)
    w = (torch.randn((*kernel, cin, cout), generator=g) * 0.1).to(
        torch.bfloat16)
    dy, w = dy.to(cuda), w.to(cuda)
    before = lnn.conv3d_dgrad.launches
    got = lnn.conv3d_dgrad(dy, w)
    assert lnn.conv3d_dgrad.launches == before + 1
    again = lnn.conv3d_dgrad(dy, w)
    want = lnn.conv3d_dgrad_plain(dy, w)
    torch.cuda.synchronize()
    assert got.shape == (B, T, H, W, cin) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    assert _dgrad_err(got, want) <= 2.0 ** -6


@pytest.mark.cuda
def test_conv3d_routes_bf16_input_gradients_through_the_kernel(cuda):
    """nn.conv3d in bf16 on an input that needs a gradient: the forward and
    the weight gradient the same bytes as autograd's through the same
    cuDNN convolution, the input gradient the kernel's (one launch); no
    launch without grad mode."""
    from lipreading_tpu_torch.models import nn as lnn

    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, 24, 24, 32), generator=g).to(torch.bfloat16)
    w = torch.randn((3, 5, 5, 32, 64), generator=g) * 0.05
    b = torch.randn((64,), generator=g) * 0.1
    gy = torch.randn((2, 8, 24, 24, 64), generator=g).to(torch.bfloat16)
    x, w, b, gy = x.to(cuda), w.to(cuda), b.to(cuda), gy.to(cuda)
    out = {}
    for path in ("old", "new"):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = lnn.conv3d_dgrad.launches
        if path == "old":
            y = (lnn._conv(xr, wr.to(torch.bfloat16), (1, 1, 1))[0]
                 + b.to(torch.bfloat16))
        else:
            y = lnn.conv3d(xr, wr, b, (1, 1, 1), torch.bfloat16)
        dx, dw = torch.autograd.grad(y, (xr, wr), gy)
        out[path] = (y, dx, dw, lnn.conv3d_dgrad.launches - before)
    assert torch.equal(out["old"][0], out["new"][0])
    assert torch.equal(out["old"][2], out["new"][2])
    assert (out["old"][3], out["new"][3]) == (0, 1)
    plain = lnn.conv3d_dgrad_plain(gy, w.to(torch.bfloat16))
    assert _dgrad_err(out["new"][1], plain) <= 2.0 ** -6
    before = lnn.conv3d_dgrad.launches
    with torch.no_grad():
        lnn.conv3d(x.clone().requires_grad_(), w, b, (1, 1, 1), torch.bfloat16)
    assert lnn.conv3d_dgrad.launches == before
