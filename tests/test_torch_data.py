"""The port's fixture captions and raw-frame training batches against the
JAX package on the CPU: WebVTT text and parsing, ``FixtureVideoDataset``
samples and ``VideoBatchIterator``'s batches (same seeds, same bytes, same
order), and the iterator's resume. Exact equality throughout: both sides
are the same numpy arithmetic."""

import dataclasses

import numpy as np
import pytest
import torch

from lipreading_tpu import fixtures as jfix
from lipreading_tpu import vtt as jvtt
from lipreading_tpu.config import DataConfig as JData
from lipreading_tpu.data import pipeline as jpipe
from lipreading_tpu_torch import fixtures as tfix
from lipreading_tpu_torch import vtt as tvtt
from lipreading_tpu_torch.config import DataConfig
from lipreading_tpu_torch.data import pipeline as tpipe

FIELDS = ("frames", "frame_lengths", "targets", "target_lengths",
          "ctc_labels", "ctc_lengths")


@pytest.fixture(scope="module")
def datasets():
    """2 clips from data seed 1 through both packages."""
    return (tpipe.FixtureVideoDataset(2, seed=1, cfg=DataConfig()),
            jpipe.FixtureVideoDataset(2, seed=1, cfg=JData()))


@pytest.mark.parametrize("seed", [0, 7])
def test_clip_vtt_matches_jax(seed):
    got, want = tfix.make_clip(seed), jfix.make_clip(seed)
    assert got.vtt == want.vtt and got.text == want.text
    assert got.frames.tobytes() == want.frames.tobytes()


@pytest.mark.parametrize("text", ["the and you", "a", "their time will way"])
def test_make_vtt_matches_jax(text):
    for fpc, fps in ((4, 25.0), (3, 30.0)):
        assert tfix._make_vtt(text, fpc, fps) == jfix._make_vtt(text, fpc, fps)


def test_parse_and_align_match_jax():
    doc = ("WEBVTT\n\nNOTE a comment\nstill the note\n\n1\n"
           "00:00:00.000 --> 00:00:00.480 align:start\n<c>hello</c> there\n\n"
           "01:02.500 --> 01:03,000\n<v Speaker>Two</v>\nlines!\n\n"
           "00:00:09.000 --> 00:00:12.000\nout of range\n\n"
           "00:00:01.000 --> 00:00:01.010\n,,\n")
    got, want = tvtt.parse_vtt(doc), jvtt.parse_vtt(doc)
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]
    assert tvtt.align_cues_to_frames(got, 25.0, 200) == \
        jvtt.align_cues_to_frames(want, 25.0, 200)
    assert tvtt.write_vtt(got) == jvtt.write_vtt(want)


def test_dataset_matches_jax(datasets):
    got, want = datasets
    assert len(got) == len(want)
    for (gf, gt), (wf, wt) in zip(got.samples, want.samples):
        assert gt == wt and gf.tobytes() == wf.tobytes()


def test_iterator_batches_match_jax(datasets):
    """Batch size 2 over 7 samples: the plans of two epochs, batch by batch."""
    got, want = datasets
    ti = tpipe.VideoBatchIterator(got, 2, seed=3)
    ji = jpipe.VideoBatchIterator(want, 2, seed=3)
    for _ in range(6):
        a, b = next(ti), next(ji)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert a.texts == b.texts
        assert ti.state == ji.state
    assert ti.epoch >= 1


def test_iterator_resumes_from_state(datasets):
    ds = datasets[0]
    it = tpipe.VideoBatchIterator(ds, 2, seed=5)
    for _ in range(3):
        next(it)
    resumed = tpipe.VideoBatchIterator.from_state(ds, 2, it.state)
    for _ in range(3):
        a, b = next(it), next(resumed)
        np.testing.assert_array_equal(a.frames, b.frames)
        assert a.texts == b.texts


def test_video_batch_to_device(datasets):
    batch = datasets[0].batch([0, 1], 32)
    dev = tpipe.video_batch_to_device(batch, "cpu")
    assert sorted(dev) == sorted(FIELDS)
    assert dev["frames"].dtype == torch.uint8
    assert tuple(dev["frames"].shape) == (2, 32, 160, 160, 3)
    assert dev["frame_lengths"].dtype == torch.int32
