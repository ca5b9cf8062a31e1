"""Disk-video ingest in the port (``lipreading_tpu_torch/data/pipeline.py``:
``VideoDecodePool``, ``ShmVideoDecodePool.imap``, ``VideoFileIterator``)
against direct decode and the JAX package's ``VideoFileIterator``: the
pools' clips equal to in-process decode in input order, a worker's error
raised in the parent, a decode that never returns timed out; the
iterator's batches byte-equal to JAX's over the same mp4 files and seed
for two epochs, through either pool; one port ``FusedTrainer`` step on
such a batch with a finite loss, and the batches through
``PinnedPrefetcher``. Needs OpenCV (``cv2``) to write and decode the
files."""

import numpy as np
import pytest
import torch

from lipreading_tpu.config import DataConfig as JData
from lipreading_tpu.data.pipeline import VideoFileIterator as JFileIterator
from lipreading_tpu.data.video import decode_video as j_decode
from lipreading_tpu_torch.config import Config, DataConfig, ModelConfig
from lipreading_tpu_torch.config import TrainConfig
from lipreading_tpu_torch.data.pipeline import (
    PinnedPrefetcher,
    ShmVideoDecodePool,
    VideoBatch,
    VideoDecodePool,
    VideoFileIterator,
)
from lipreading_tpu_torch.data.video import decode_video, write_video
from lipreading_tpu_torch.fixtures import make_clip
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

BUCKETS = (16, 24, 32)
BATCH = 2
TIMEOUT = 120.0         # s a pool waits for one clip in these tests


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """5 mp4 files of 10-30 frames -> [(path, text)]."""
    pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("mp4")
    samples = []
    for s in range(5):
        clip = make_clip(60 + s)
        path = str(d / f"c{s}.mp4")
        write_video(path, clip.frames[: 10 + 5 * s], fps=25.0)
        samples.append((path, clip.text))
    return samples


@pytest.fixture(scope="module")
def direct(corpus):
    return [decode_video(p)[0] for p, _ in corpus]


class _InProcessPool:
    """The pool interface over the JAX package's own decode, in process."""

    def imap(self, paths, max_frames=None):
        return (j_decode(p, max_frames=max_frames)[0] for p in paths)


def _batches(it, n):
    return [next(it) for _ in range(n)]


def _assert_batches_equal(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        for f in ("frames", "frame_lengths", "targets", "target_lengths",
                  "ctc_labels", "ctc_lengths"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (k, f)
            assert np.array_equal(a, b), (k, f)
        assert g.texts == w.texts, k


def test_decode_pools_match_direct_decode(corpus, direct):
    """Both pools yield in input order what in-process decode gives, which
    is what the JAX package's decode gives; ``max_frames`` cuts."""
    paths = [p for p, _ in corpus]
    for d, (p, _) in zip(direct, corpus):
        np.testing.assert_array_equal(d, j_decode(p)[0])
    with VideoDecodePool(workers=2, prefetch=1, timeout=TIMEOUT) as pool:
        got = list(pool.imap(paths * 2))
        cut = list(pool.imap(paths, max_frames=12))
    with ShmVideoDecodePool(workers=2, slot_frames=32,
                            timeout=TIMEOUT) as shm:
        got_shm = list(shm.imap(paths * 2))
        cut_shm = list(shm.imap(paths, max_frames=12, copy=False))
    for out in (got, got_shm):
        assert len(out) == 10
        for d, g in zip(direct * 2, out):
            np.testing.assert_array_equal(d, g)
    for out in (cut, cut_shm):
        for d, g in zip(direct, out):
            np.testing.assert_array_equal(d[:12], g)


def test_decode_pools_raise_a_workers_error(corpus, tmp_path):
    good = corpus[0][0]
    missing = str(tmp_path / "missing.mp4")
    with VideoDecodePool(workers=1, timeout=TIMEOUT) as pool:
        it = pool.imap([good, missing])
        next(it)
        with pytest.raises(OSError, match="missing.mp4"):
            next(it)
    with ShmVideoDecodePool(workers=1, slot_frames=32,
                            timeout=TIMEOUT) as shm:
        with pytest.raises(RuntimeError, match="missing.mp4"):
            list(shm.imap([good, missing]))
    with ShmVideoDecodePool(workers=1, slot_frames=2,
                            timeout=TIMEOUT) as shm:     # a slot too small
        with pytest.raises(RuntimeError, match="slot"):
            next(shm.imap([good]))


def test_decode_pools_time_out_on_a_stalled_clip(tmp_path):
    """A file whose decode never returns (OpenCV opening a FIFO no one
    writes blocks) raises TimeoutError after the pool's timeout, and the
    pool still closes: no wait blocks forever."""
    import os
    import time

    stalled = str(tmp_path / "stalled.mp4")
    os.mkfifo(stalled)
    for pool in (VideoDecodePool(workers=1, timeout=2.0),
                 ShmVideoDecodePool(workers=1, slot_frames=8, timeout=2.0)):
        t0 = time.monotonic()
        with pool:
            with pytest.raises(TimeoutError):
                next(pool.imap([stalled]))
        assert time.monotonic() - t0 < 60.0, type(pool).__name__


@pytest.fixture(scope="module")
def jax_batches(corpus):
    """Two epochs (2 batches each) of the JAX package's iterator."""
    it = JFileIterator(corpus, JData(time_buckets=BUCKETS), BATCH,
                       _InProcessPool(), seed=3)
    return _batches(it, 4)


@pytest.mark.parametrize("kind", ["pipe", "shm"])
def test_file_iterator_equals_jax_for_two_epochs(corpus, jax_batches, kind):
    cfg = DataConfig(time_buckets=BUCKETS)
    pool = (VideoDecodePool(workers=2, timeout=TIMEOUT) if kind == "pipe"
            else ShmVideoDecodePool(workers=2, slot_frames=max(BUCKETS),
                                    timeout=TIMEOUT))
    with pool:
        it = VideoFileIterator(corpus, cfg, BATCH, pool, seed=3)
        got = _batches(it, 4)
        assert it.epoch == 1
    assert all(isinstance(b, VideoBatch) for b in got)
    assert got[0].frames.shape == (BATCH, max(BUCKETS), 160, 160, 3)
    _assert_batches_equal(got, jax_batches)


def test_file_iterator_feeds_the_fused_step_and_the_prefetcher(
        corpus, jax_batches, tmp_path):
    from lipreading_tpu_torch.io import load_preprocessors
    from lipreading_tpu_torch.train.loop import FusedTrainer

    model = dict(frontend="patchify", patch_dim=16, frontend_dim=24,
                 tf_dim=32, tf_heads=2, tf_mlp=64, tf_layers=1,
                 tf_dec_layers=1, highway_layers=1, dtype="float32")
    cfg = Config(encoder="transformer", decoder="hybrid",
                 data=DataConfig(time_buckets=BUCKETS, batch_size=BATCH),
                 model=ModelConfig(**model),
                 train=TrainConfig(warmup_steps=0, log_every=1,
                                   checkpoint_every=0, eval_every=0))
    det, lmk, _ = load_preprocessors("ert", device="cpu")
    trainer = FusedTrainer(cfg, str(tmp_path / "run"), det, lmk,
                           device="cpu")
    with ShmVideoDecodePool(workers=2, slot_frames=max(BUCKETS),
                            timeout=TIMEOUT) as pool:
        it = VideoFileIterator(corpus, cfg.data, BATCH, pool, seed=3)
        batch = next(it)
        m = trainer.train_step(batch)
        assert np.isfinite(float(m["loss"]))
        assert trainer.step == 1
        pf = PinnedPrefetcher(((b.frames, b.frame_lengths, b)
                               for b in _batches(it, 3)), "cpu",
                              timeout=TIMEOUT)
        try:
            staged = list(pf)
        finally:
            pf.close()
    assert len(staged) == 3
    for ((frames, lens), events, host), want in zip(staged, jax_batches[1:]):
        assert events == (None, None)
        assert torch.equal(frames, torch.from_numpy(want.frames))
        assert torch.equal(lens, torch.from_numpy(want.frame_lengths))
        assert host[2].texts == want.texts
