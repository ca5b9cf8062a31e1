"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a CUDA device (or without nvcc) each test
skips with its reason, decided inside the ``cuda`` fixture, never at import.

    python -m pytest --noconftest tests/test_torch_cuda.py   # on the GPU machine

Off the card the one test that runs is the build's refusal to fall back."""

import numpy as np
import pytest
import torch

from lipreading_tpu_torch import kernels
from lipreading_tpu_torch.ops import decode, roi


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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a machine without nvcc gets an error that says
    so, not the plain version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
