"""The benchmark's frozen copies equal the program's originals at the
commit they were copied from: the fixture renderer, the vocabulary and
label arithmetic, the FLOP counts and card peaks, and the byte and
operation models of the kernels' rooflines."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from portbench.frozen import fixtures as FX
from portbench.frozen import flops as FL
from portbench.frozen import roofline as RF
from portbench.frozen import text as tx

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RELEASES = ("transformer_hybrid_universal4", "transformer_hybrid")


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 7])
def test_renderer_equals_program(seed):
    from lipreading_tpu_torch.fixtures import make_clip

    frames, text = FX.make_clip(seed)
    clip = make_clip(seed)
    assert text == clip.text
    assert np.array_equal(frames, clip.frames)


def test_lexicon_and_sample_text_equal_program():
    from lipreading_tpu_torch import fixtures

    assert FX.LEXICON == fixtures.LEXICON
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    assert [FX.sample_text(a) for _ in range(20)] == \
        [fixtures.sample_text(b) for _ in range(20)]


@pytest.mark.parametrize("frames", [1, 7, 40, 96])
def test_labels_equal_program(frames):
    from lipreading_tpu_torch.text import Vocab

    v = Vocab()
    assert tx.TOKENS == v.tokens
    text = "there will their long word"
    target, n, ids = tx.labels(text, frames, 40)
    want_ids = v.encode(text)[:38][:max((frames - 1) // 2, 1)]
    want_target, want_n = v.encode_target(v.decode(want_ids), 40)
    assert np.array_equal(ids, want_ids)
    assert np.array_equal(target, want_target) and n == want_n
    assert tx.decode(target) == v.decode(target)


@pytest.mark.parametrize("release", RELEASES)
def test_flops_equal_program(release):
    from lipreading_tpu_torch import flops, io

    cfg = io.load_release(release)[1]
    d = json.loads(json.dumps(cfg.to_dict(), default=list))
    for T, L in ((96, 20), (64, 41), (1024, 7)):
        assert FL.model_fwd_flops(d, T, L) == flops.model_fwd_flops(cfg, T, L)
        assert FL.train_step_flops(d, 64, T, L) == \
            flops.train_step_flops(cfg, 64, T, L)
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "cpu"):
        assert FL.card_peaks(name) == flops.card_peaks(name)


def test_preprocess_flops_shares_the_program_detector_terms():
    """The conv path's count keeps the program's resize and detector terms
    and the ROI at 10 operations a pixel."""
    from lipreading_tpu_torch import flops
    from lipreading_tpu_torch.config import PreprocessConfig

    pre = PreprocessConfig()
    d = {"roi_size": pre.roi_size}
    ert = (pre.ert_cascades * (2.0 * pre.ert_pool * 64 * 64
                               + pre.ert_trees * 2.0 * 16 * 136))
    dense_roi = 2.0 * 96 * 160 * 160 + 2.0 * 96 * 160 * 96
    common = flops.preprocess_flops(pre, 160, 160) - ert - dense_roi
    conv = FL.preprocess_flops_conv(d, 160, 160)
    extra = (64 * (2.0 * 32 * 16 + 2.0 * 16) + 10.0 * 64 * 64
             + 2.0 * 32 * 32 * 9 * 16 + 2.0 * 16 * 16 * 9 * 16 * 32
             + 2.0 * 8 * 8 * 9 * 32 * 64 + 2.0 * 4 * 4 * 9 * 64 * 96
             + 2.0 * 1536 * 256 + 2.0 * 256 * 136 + 10.0 * 96 * 96)
    assert conv == pytest.approx(common + extra, rel=1e-12)


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("subpixel", [False, True])
def test_roi_bytes_equal_program(smoke, subpixel):
    g = torch.Generator().manual_seed(0)
    n = 37
    size = 20 + 60 * torch.rand(n, generator=g)
    x0 = -5 + 150 * torch.rand(n, generator=g)
    y0 = -5 + 150 * torch.rand(n, generator=g)
    boxes = torch.stack([x0, y0, size], 1)
    if not subpixel:
        boxes = boxes.round().int()
    assert RF.roi_bytes_needed(boxes, subpixel, 160, 160, 96, block=8) == \
        smoke.roi_bytes_needed(boxes, subpixel, 160, 160, 96)


def test_bounds_equal_program(smoke):
    peaks = FL.card_peaks("NVIDIA H100 80GB HBM3")
    for nbytes, ops in ((1e6, 1e3), (1e3, 1e9)):
        assert RF.bound_s(nbytes, ops, peaks) * 1e3 == \
            pytest.approx(smoke.bound_ms(nbytes, ops)[0], rel=1e-12)


def test_ctc_work_equals_program(smoke):
    rng = np.random.default_rng(1)
    B, T, L = 5, 96, 40
    labels = np.zeros((B, L), np.int64)
    lab = rng.integers(3, 31, size=(B, 12))
    lab[:, 3] = lab[:, 2]                      # a repeat: no skip there
    labels[:, :12] = lab
    fl = np.asarray([96, 40, 1, 0, 77])
    S = 2 * L + 1
    ext = np.zeros((B, S), np.int64)
    ext[:, 1::2] = labels
    prev2 = np.pad(ext, ((0, 0), (2, 0)))[:, :S]
    c = {"lp_ext": torch.zeros((B, T, S)),
         "skip": torch.from_numpy((ext != 0) & (ext != prev2)),
         "inl": torch.from_numpy(fl)}
    want = smoke.ctc_work(c)
    got = RF.ctc_work(fl, labels, np.full(B, 12), T)
    for k in ("fwd", "bwd"):
        assert got[k] == want[k][:2]
