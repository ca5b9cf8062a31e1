"""The tracked ``streaming.StreamingTranscriber`` against the JAX
package's on the CPU (the untracked configs, the models and the helpers
are in ``tests/test_torch_streaming.py``): a faceless gap between two clips
(``gap_flush``), a hard cut of two clips back to back (``cut_flush`` and
the re-acquire of the track), a gap across a chunk seam (the track's state
carried over it), the conv landmarker's integer tracked boxes, and the
joint beam over each segment of a tiny ``hybrid`` model (its beams on the
gap are in ``tests/test_torch_streaming_beam.py``). After every
``feed`` the transcript, the committed text, ``_ctx``, the buffer's length
and ``cut_events`` are equal (exact)."""

import numpy as np
import pytest
import torch

from lipreading_tpu.fixtures import make_clip
from lipreading_tpu_torch.ops.preprocess import preprocess_frames
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_streaming import (  # noqa: F401
    _streams,
    _video,
    check_config,
    models,
    prep,
    two_torch_threads,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard")

# (model, video, chunk sizes (None: 16s), transcriber kwargs, counts that
# must be > 0)
CONFIGS = {
    "gap_flush": ("bigru", "gap", None,
                  dict(window=64, tracked=True, gap_flush=25), ("flushes",)),
    "hard_cut": ("bigru", "cut", None, dict(window=64, tracked=True),
                 ("flushes",)),
    "hard_cut_hybrid": ("hybrid", "cut", [8] * 8,
                        dict(window=64, decode_every=12, chunk_bucket=8,
                             tracked=True, beam=3),
                        ("flushes", "segment")),
    "gap_over_chunk_seam": ("bigru", "seam", None,
                            dict(window=64, tracked=True), ()),
    "conv_landmarker": ("bigru", "cut", None,
                        dict(window=64, tracked=True, landmarker="conv"),
                        ("flushes",)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tracked_stream_matches_jax_after_every_feed(models, prep, name):
    check_config(models, prep, CONFIGS[name])


def test_tracked_chunk_samples_integer_boxes_with_the_conv_landmarker(
        models, prep):
    """The tracked chunk samples integer mouth boxes with the conv
    landmarker too (the JAX package's choice), where the untracked path's
    ``preprocess_frames`` samples sub-pixel boxes: its ROIs equal the JAX
    tracked chunk's (1e-4, a conv landmark's float32 ulps) and differ from
    sub-pixel ones."""
    js, ps = _streams(models, prep, "bigru", landmarker="conv", tracked=True)
    frames = make_clip(6601).frames[:16]
    got, valid, _ = ps._pre_tracked(torch.as_tensor(frames),
                                    *ps._fresh_track_state())
    want, jvalid, _ = js._pre_tracked(frames, *js._track_state)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    with torch.inference_mode():
        sub = preprocess_frames(prep["port"]["det"], prep["port"]["conv"],
                                torch.as_tensor(frames), ps.cfg.preprocess)
    assert (sub - got).abs().max() > 1e-2


def test_tracked_preprocessing_calls_match_jax(models, prep):
    """Every call of the tracked chunk preprocessing, in both packages, on
    the hard cut: the same padded frames and the same carried track state
    (boxes within 1e-3 px); the cut's re-acquire runs on the frames from
    the cut on, padded to the chunk's shape by repeating the last real one,
    from a fresh state, and its state replaces the carried one."""
    C = 12                      # the cut (frame 32) falls mid-chunk
    js, ps = _streams(models, prep, "bigru", tracked=True, window=64,
                      chunk_bucket=C)
    calls = {"jax": [], "port": []}

    def spy(store, fn, to_np):
        def run(frames, have, box):
            store.append((to_np(frames), to_np(have), to_np(box)))
            out = fn(frames, have, box)
            store.append(("out", to_np(out[2][0]), to_np(out[2][1])))
            return out
        return run

    js._pre_tracked = spy(calls["jax"], js._pre_tracked, np.asarray)
    ps._pre_tracked = spy(calls["port"], ps._pre_tracked,
                          lambda x: x.cpu().numpy())
    frames = _video("cut")
    n0 = make_clip(6601).frames.shape[0]
    for lo in range(0, len(frames), C):
        js.feed(frames[lo:lo + C])
        ps.feed(frames[lo:lo + C])
    assert ps.cut_events == js.cut_events == 1
    chunks = -(-len(frames) // C)
    assert len(calls["port"]) == len(calls["jax"]) == 2 * (chunks + 1)
    for a, b in zip(calls["port"], calls["jax"]):
        if isinstance(a[0], str):
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_allclose(a[2], b[2], atol=1e-3)
        else:
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_allclose(a[2], b[2], atol=1e-3)
    # the re-acquire is the call after the cut chunk's own
    k, i = divmod(n0, C)
    assert i > 0
    cut_frames, have, box = calls["port"][2 * (k + 1)]
    want = frames[n0:C * (k + 1)]
    want = np.concatenate([want, np.repeat(want[-1:], i, axis=0)])
    np.testing.assert_array_equal(cut_frames, want)
    assert not have.any() and not box.any()
    # its state is carried into the next chunk
    np.testing.assert_array_equal(calls["port"][2 * (k + 2)][2],
                                  calls["port"][2 * (k + 1) + 1][2])
