"""The launches of the ROI and greedy kernels (``roi_plan``,
``greedy_plan``, which the wrappers hand to the C entries): every output
pixel and every frame is taken by exactly one thread, within the block and
shared-memory limits of the H100 and the rules the C entries check before
they launch (``tests/test_torch_cuda.py`` holds that they refuse a plan that
breaks them)."""

import numpy as np
import pytest

from lipreading_tpu_torch.ops.decode import (GREEDY_MAX_THREADS,
                                             GREEDY_SMEM_FLOATS, greedy_plan)
from lipreading_tpu_torch.ops.roi import ROI_THREADS, roi_plan

SMEM_LIMIT = 227 * 1024   # the H100's dynamic shared memory a block


def _roi_frame_counts(p, R: int) -> np.ndarray:
    """How often each pixel of one frame is written, thread by thread as
    roi_sample_kernel walks its band."""
    counts = np.zeros((R, R), dtype=np.int64)
    for band_i in range(p.bands):
        r_lo = band_i * p.band
        r_hi = min(r_lo + p.band, R)
        for i in range(p.threads):
            qi, ri = i % p.tpr, i // p.tpr
            if ri >= p.rpp:
                continue
            rows = np.arange(r_lo + ri, r_hi, p.rpp)
            for q in range(qi, p.quads, p.tpr):
                cols = np.arange(4 * q, min(4 * q + 4, R))
                counts[np.ix_(rows, cols)] += 1
    return counts


@pytest.mark.parametrize("N", [1, 768, 4096])
@pytest.mark.parametrize("R", [1, 2, 30, 96, 97, 160])
def test_roi_plan_covers_every_pixel_once(N, R):
    p = roi_plan(N, R)
    assert (_roi_frame_counts(p, R) == 1).all()
    # block b takes band b % bands of frame b // bands: every band of every
    # frame once
    b = np.arange(p.blocks)
    pairs = np.unique(np.stack([b // p.bands, b % p.bands]), axis=1)
    assert p.blocks == N * p.bands and pairs.shape[1] == N * p.bands
    assert (b // p.bands).max() == N - 1
    assert p.threads % 32 == 0 and p.tpr * p.rpp <= p.threads <= ROI_THREADS
    assert p.quads == -(-R // 4) and p.bands * p.band >= R
    # the staging buffer follows the taps, 16-byte aligned
    band4 = -(-p.band // 4) * 4
    assert p.smem % 16 == 0 and p.smem // 4 - 8 * p.quads - 2 * band4 >= 0
    assert p.smem <= SMEM_LIMIT


def _greedy_frame_counts(p, T: int) -> np.ndarray:
    """How often each frame is read, as ctc_greedy_kernel walks its chunks:
    one thread a frame (staged), or a warp a frame (nbuf 0)."""
    counts = np.zeros(T, dtype=np.int64)
    warps = p.threads // 32
    for base in range(0, T, p.chunk):
        if p.nbuf:
            t = base + np.arange(min(p.threads, p.chunk))
        else:
            t = base + np.concatenate(
                [np.arange(w, p.chunk, warps) for w in range(warps)])
        np.add.at(counts, t[t < T], 1)
    return counts


@pytest.mark.parametrize("V", [1, 7, 31, 2000])
@pytest.mark.parametrize("T", [1, 96, 1000, 1024, 1025, 4096])
def test_greedy_plan_covers_every_frame_once(T, V):
    p = greedy_plan(T, V)
    assert (_greedy_frame_counts(p, T) == 1).all()
    assert p.smem <= SMEM_LIMIT
    assert p.threads % 32 == 0 and p.chunk <= p.threads <= GREEDY_MAX_THREADS
    assert p.sV % 2 == 1 and p.sV in (V, V + 1)   # odd: no bank conflicts
    if p.nbuf:
        # a chunk's rows after a head of up to 3 floats fit in its buffer,
        # the buffers in the shared memory the kernel asks for
        assert p.buf_floats % 4 == 0
        assert 3 + p.chunk * p.sV <= p.buf_floats
        assert p.nbuf * p.buf_floats <= GREEDY_SMEM_FLOATS
    if p.nbuf == 2:
        assert p.chunk % 32 == 0 and p.chunk < T
    if p.nbuf == 1:
        assert p.chunk >= T
    # every chunk but the last is full: its last warp's label carries on
    assert p.chunk >= T or p.chunk == p.threads


def test_greedy_plan_modes():
    """The serving and long-clip shapes are one chunk each; a long utterance
    takes double-buffered chunks; V 2000 leaves too little room for 32 rows
    a buffer and takes a warp a frame."""
    assert greedy_plan(96, 31).nbuf == 1
    assert greedy_plan(1024, 31)[1:3] == (1024, 1)
    assert greedy_plan(4096, 31)[2] == 2
    assert greedy_plan(28, 2000).nbuf == 1
    assert greedy_plan(1100, 2000).nbuf == 0
