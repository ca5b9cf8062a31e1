"""The port's serving loop (``python -m lipreading_tpu_torch.serve``) and
its input (``data.pipeline.ShmVideoDecodePool``, ``PinnedPrefetcher``,
``data.video``) on the CPU.

* The ring: the deadlock of the JAX package's ring (8 clips through 2
  workers and 4 slots, the first job slow, so later results arrive first)
  in 8 runs, each under a timeout; a work function's error and a dead
  worker raise in the parent; rendered clips equal ``make_clip``'s frames.
* The prefetcher: order, errors, the end, a timeout.
* ``serve(device=cpu, source=render, clips=2, B=2, workers=1)``: its
  transcripts equal the JAX package's ``transcribe_cascade`` over its
  ``preprocess_clips_tracked`` (conv landmarker) of the same frames, and for
  the clip with a frame without a face (``make_clip(101)``, frame 5),
  JAX's ``transcribe_segmented(cascade=True)`` of that clip. Exact, string
  for string.

Every process and thread here has a timeout."""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu_torch.data import pipeline as tpipe
from lipreading_tpu_torch.fixtures import make_clip
from lipreading_tpu_torch.serve import iter_batches, resolve_source
from tests.test_torch_helpers import file_hang_guard  # noqa: F401
from tests.test_torch_helpers import synth_frames

RUN_TIMEOUT = 60.0

pytestmark = pytest.mark.usefixtures("file_hang_guard")


def _run_with_timeout(fn, timeout=RUN_TIMEOUT):
    """fn() in a daemon thread; fails the test if it does not end in time."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # handed to the test thread
            box["err"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"did not end within {timeout} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.parametrize("run", range(8))
def test_ring_does_not_deadlock_on_out_of_order_results(run):
    """The JAX ring hung in 2 of 8 such runs: a warm worker fills every free
    slot with later clips while the consumer waits for the first."""
    jobs = [(4 + i % 3, 16, 16, 0.6 if i == 0 else 0.0) for i in range(8)]

    def go():
        with tpipe.ShmVideoDecodePool(workers=2, slot_frames=8,
                                      frame_hw=(16, 16), slots=4,
                                      work_fn=synth_frames,
                                      timeout=30) as pool:
            return list(pool.imap_jobs(jobs))

    out = _run_with_timeout(go)
    assert [o.shape for o in out] == [(j[0], 16, 16, 3) for j in jobs]
    assert all((o == 127).all() for o in out)


def test_ring_renders_fixture_clips_in_order():
    def go():
        with tpipe.ShmVideoDecodePool(workers=2, slot_frames=40,
                                      frame_hw=(160, 160),
                                      work_fn=tpipe._render_frames,
                                      timeout=60) as pool:
            return list(pool.imap_jobs([(s, 40) for s in (103, 105, 114)]))

    for s, got in zip((103, 105, 114), _run_with_timeout(go)):
        np.testing.assert_array_equal(got, make_clip(s).frames[:40])


def test_ring_raises_a_work_error_in_the_parent():
    def go():
        with tpipe.ShmVideoDecodePool(workers=1, slot_frames=2,
                                      frame_hw=(16, 16),
                                      work_fn=synth_frames,
                                      timeout=30) as pool:
            return list(pool.imap_jobs([(1, 16, 16, 0.0), (9, 16, 16, 0.0)]))

    with pytest.raises(RuntimeError, match="exceeds the ring slot"):
        _run_with_timeout(go)


def test_ring_raises_when_a_worker_dies():
    def go():
        with tpipe.ShmVideoDecodePool(workers=1, slot_frames=2,
                                      frame_hw=(16, 16),
                                      work_fn=synth_frames,
                                      timeout=30) as pool:
            pool._procs[0].terminate()
            pool._procs[0].join(timeout=10)
            return list(pool.imap_jobs([(1, 16, 16, 0.0)]))

    with pytest.raises(RuntimeError, match="a ring worker died"):
        _run_with_timeout(go)


def test_ring_times_out_with_the_workers_state():
    def go():
        with tpipe.ShmVideoDecodePool(workers=1, slot_frames=2,
                                      frame_hw=(16, 16),
                                      work_fn=synth_frames,
                                      timeout=1.0) as pool:
            return list(pool.imap_jobs([(1, 16, 16, 5.0)]))

    with pytest.raises(TimeoutError, match="alive=True"):
        _run_with_timeout(go)


def test_prefetcher_keeps_order_and_ends():
    batches = [(np.full((2, 3, 4, 4, 3), i, np.uint8),
                np.asarray([3, i], np.int32), [i]) for i in range(5)]
    pf = tpipe.PinnedPrefetcher(iter(batches), "cpu", timeout=30)
    try:
        got = _run_with_timeout(lambda: list(pf))
    finally:
        pf.close()
    assert not pf.thread.is_alive()
    assert [h[2] for _, _, h in got] == [[i] for i in range(5)]
    for (frames, lens), events, host in got:
        assert frames.dtype == torch.uint8 and events == (None, None)
        np.testing.assert_array_equal(frames.numpy(), host[0])
        np.testing.assert_array_equal(lens.numpy(), host[1])
        assert not frames.is_pinned()


def test_prefetcher_raises_the_thread_error_and_times_out():
    def bad():
        yield (np.zeros((1, 1, 1, 1, 3), np.uint8), np.zeros(1, np.int32), [])
        raise ValueError("decode went wrong")

    pf = tpipe.PinnedPrefetcher(bad(), "cpu", timeout=30)
    next(pf)
    with pytest.raises(ValueError, match="decode went wrong"):
        _run_with_timeout(lambda: next(pf))
    pf.close()

    def slow():
        time.sleep(3.0)
        yield (np.zeros((1, 1, 1, 1, 3), np.uint8), np.zeros(1, np.int32), [])

    pf = tpipe.PinnedPrefetcher(slow(), "cpu", timeout=0.5)
    with pytest.raises(TimeoutError):
        _run_with_timeout(lambda: next(pf))
    pf.close()
    assert not pf.thread.is_alive()


def test_prefetcher_stays_ended_past_its_end_and_its_error():
    """``next`` twice past the end, and twice past a surfaced error, raises
    StopIteration each time (the JAX ``Prefetcher`` blocks there)."""
    one = (np.zeros((1, 1, 1, 1, 3), np.uint8), np.zeros(1, np.int32), [])
    pf = tpipe.PinnedPrefetcher(iter([one]), "cpu", timeout=30)
    try:
        _run_with_timeout(lambda: next(pf))
        for _ in range(3):
            with pytest.raises(StopIteration):
                _run_with_timeout(lambda: next(pf))
    finally:
        pf.close()

    def bad():
        yield one
        raise ValueError("decode went wrong")

    pf = tpipe.PinnedPrefetcher(bad(), "cpu", timeout=30)
    try:
        _run_with_timeout(lambda: next(pf))
        with pytest.raises(ValueError, match="decode went wrong"):
            _run_with_timeout(lambda: next(pf))
        for _ in range(2):
            with pytest.raises(StopIteration):
                _run_with_timeout(lambda: next(pf))
    finally:
        pf.close()
    assert not pf.thread.is_alive()


def test_iter_batches_pads_the_ragged_tail():
    clips = [np.full((t, 2, 2, 3), t, np.uint8) for t in (3, 7, 5)]
    out = list(iter_batches(iter(clips), 3, 2, 6, (2, 2)))
    assert [o[2] for o in out] == [[0, 1], [2]]
    assert out[0][1].tolist() == [3, 6] and out[1][1].tolist() == [5, 5]
    assert (out[0][0][0, 3:] == 0).all() and (out[0][0][1] == 7).all()
    np.testing.assert_array_equal(out[1][0][1], out[1][0][0])


def test_source_defaults_and_refusals(monkeypatch):
    assert resolve_source(None, "clips/") == "mp4"
    assert resolve_source("render", None) == "render"
    with pytest.raises(ValueError):
        resolve_source("render", "clips/")
    with pytest.raises(ValueError):
        resolve_source("webcam", None)
    monkeypatch.setitem(sys.modules, "cv2", None)        # OpenCV missing
    assert resolve_source(None, None) == "render"
    from lipreading_tpu_torch.data.video import decode_video

    with pytest.raises(ImportError, match="source=render"):
        decode_video("x.mp4")


def test_video_round_trip_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from lipreading_tpu.data.video import decode_video as j_decode
    from lipreading_tpu_torch.data.video import decode_video, write_video

    frames = make_clip(21).frames[:12]
    path = str(tmp_path / "c.mp4")
    write_video(path, frames, fps=25.0)
    got, fps = decode_video(path)
    want, wfps = j_decode(path)
    np.testing.assert_array_equal(got, want)
    assert got.shape == frames.shape and fps == wfps == 25.0
    assert decode_video(path, max_frames=5)[0].shape[0] == 5


def test_serve_needs_a_card_for_device_cuda(monkeypatch):
    from lipreading_tpu_torch.serve import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(device="cuda", source="render", n_clips=1, B=1)


@pytest.fixture(scope="module")
def served():
    from lipreading_tpu_torch.serve import serve

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines = []
        report = _run_with_timeout(
            lambda: serve(device="cpu", source="render", n_clips=2, B=2,
                          workers=1, log=lines.append), timeout=300)
    finally:
        torch.set_num_threads(n)
    return report


def test_serve_on_the_cpu_matches_jax(served):
    from lipreading_tpu import infer as jinf
    from lipreading_tpu.ops import detector as jdet
    from lipreading_tpu.ops import landmarker as jlmk
    from lipreading_tpu.ops.preprocess import preprocess_clips_tracked
    from lipreading_tpu.preproc_training import (
        load_assets,
        load_landmarker,
        load_presence,
        load_release_model,
    )

    params, cfg = load_release_model("transformer_hybrid_universal4")
    cfg = cfg.override(**{"preprocess.landmarker": "conv"})
    clips = [make_clip(100 + i).frames[:96] for i in range(2)]
    frames = np.zeros((2, 96) + clips[0].shape[1:], np.uint8)
    for k, c in enumerate(clips):
        frames[k, :len(c)] = c
    lens = np.asarray([len(c) for c in clips], np.int32)
    rois, valid = preprocess_clips_tracked(
        jdet.params_to_jax(load_assets()[0]),
        {k: jnp.asarray(v) for k, v in load_presence().items()},
        jlmk.params_to_jax(load_landmarker()), jnp.asarray(frames),
        cfg.preprocess)
    rois, valid = np.asarray(rois), np.asarray(valid)
    want, _ = jinf.transcribe_cascade(params, cfg, rois, lens, beam=8,
                                      lm_weight=0.4, return_flags=True)
    gapped = [k for k in range(2) if not valid[k, :lens[k]].all()]
    assert gapped == [1]        # make_clip(101): frame 5 has no face
    want[1], _ = jinf.transcribe_segmented(
        params, cfg, rois[1, :lens[1]], valid[1, :lens[1]], cascade=True,
        beam=8, lm_weight=0.4)
    assert served["transcripts"] == want
    assert served["segmented_clips"] == 1 and served["source"] == "render"
    assert 0.0 <= served["rescored_frac"] <= 1.0
    assert served["cer"] == served["serving_cer"] and served["cer"] < 0.2
    jax.clear_caches()


def test_serve_report_splits_setup_from_the_run(served):
    """setup_s ends where the steady clock starts (loading, the warm-up and
    the first batch); run_s is the whole call."""
    assert 0.0 < served["setup_s"] < served["run_s"]


def _spy_server(monkeypatch, valid):
    """serve_batch on a stub server: ROIs [B, T, 2, 2] with row b filled
    with b, ``valid`` as given; the cascade and the segmented decode
    record what they were given."""
    from lipreading_tpu_torch import infer
    from lipreading_tpu_torch import serve as srv

    B, T = valid.shape
    rois = torch.arange(B, dtype=torch.float32)[:, None, None, None].expand(
        B, T, 2, 2).clone()
    calls = {"cascade": [], "segmented": []}

    def cascade(model, cfg, r, lens, margin=8.0, rescore_bucket=8,
                rows=None, **kw):
        calls["cascade"].append((r[:, 0, 0, 0].tolist(), lens.tolist(),
                                 margin, None if rows is None
                                 else rows.tolist()))
        flags = np.asarray([int(x) % 2 == 1 for x in r[:, 0, 0, 0]])
        if rows is not None:        # as transcribe_cascade: never flagged
            flags &= rows
        return [f"c{int(x)}" for x in r[:, 0, 0, 0]], flags

    def segmented(model, cfg, r, v, cascade=False, **kw):
        assert isinstance(r, torch.Tensor) and cascade
        calls["segmented"].append((int(r[0, 0, 0]), r.shape[0],
                                   v.tolist()))
        return f"s{int(r[0, 0, 0])}", []

    monkeypatch.setattr(srv, "preprocess_batch",
                        lambda s, f, mark=None: (rois, torch.as_tensor(valid)))
    monkeypatch.setattr(infer, "transcribe_cascade", cascade)
    monkeypatch.setattr(infer, "transcribe_segmented", segmented)
    return srv, {"model": None, "cfg": None}, calls


def test_serve_batch_rescores_only_whole_clips(monkeypatch):
    """The cascade sees the whole batch (one shape) with the gapped clips
    kept out of its rescore leg; each gapped clip is decoded by shot from
    its ROIs as a tensor."""
    valid = np.ones((4, 6), bool)
    valid[1, 2] = False                 # a gap inside clip 1's length
    valid[3, 5] = False                 # past clip 3's length: not a gap
    srv, server, calls = _spy_server(monkeypatch, valid)
    lens = torch.as_tensor([6, 6, 6, 5], dtype=torch.int32)
    texts, flags, seg = srv.serve_batch(server, None, lens)
    assert calls["cascade"] == [([0.0, 1.0, 2.0, 3.0], [6, 6, 6, 5], 8.0,
                                 [True, False, True, True])]
    assert calls["segmented"] == [(1, 6, valid[1].tolist())]
    assert texts == ["c0", "s1", "c2", "c3"]
    assert flags.tolist() == [False, False, False, True]
    assert seg.tolist() == [False, True, False, False]

    valid[:] = False                    # no whole clip: no batch cascade
    calls["cascade"].clear()
    calls["segmented"].clear()
    texts, flags, seg = srv.serve_batch(server, None, lens)
    assert calls["cascade"] == [] and len(calls["segmented"]) == 4
    assert texts == ["s0", "s1", "s2", "s3"] and not flags.any()


def test_warm_up_runs_every_rescore_shape(monkeypatch):
    """Every multiple of rescore_bucket a batch of B rows can reach goes
    through the cascade at margin=inf, gapped rows included."""
    valid = np.ones((19, 4), bool)
    valid[0, 1] = False
    srv, server, calls = _spy_server(monkeypatch, valid)
    lens = torch.full((19,), 4, dtype=torch.int32)
    srv.warm_up(server, torch.zeros(19, 4), lens, beam=8, lm_weight=0.4)
    assert [len(c[0]) for c in calls["cascade"]] == [8, 16, 19]
    assert all(c[2] == float("inf") and c[3] is None
               for c in calls["cascade"])
    assert calls["segmented"] == []


def test_serve_main_prints_one_report(capsys, monkeypatch):
    from lipreading_tpu_torch import serve as srv

    monkeypatch.setattr(srv, "serve", lambda **kw: dict(kw, transcripts=[]))
    srv.main(["device=cpu", "source=render", "clips=2", "B=2"])
    out = capsys.readouterr().out.strip().splitlines()
    import json

    rep = json.loads(out[-1])
    assert rep["device"] == "cpu" and rep["n_clips"] == 2
    assert rep["landmarker"] == "conv" and rep["tracked"] is True
    with pytest.raises(SystemExit):
        srv.main(["colour=1"])
