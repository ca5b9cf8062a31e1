"""The release pins of ``tests/test_streaming.py`` on the port's
``StreamingTranscriber`` (CPU, plain versions), with the JAX tests' own
assertions: the styled stream of ``test_styled_stream_ladder_pin``
(universal4, robust assets, tracked, ``cut_flush``: CER 0 with a cut
event), ``test_gap_flush_resets_context_at_shot_boundary`` and
``test_beam_commits_beat_greedy_commits`` (the universal release). Then
the two streaming entries on the CPU: ``stream_eval``'s universal4 rung
of that styled stream (plain streaming 0.2000, tracked 0.0000, as the
JAX test's docstring records them) and ``stream_latency``'s report."""

import numpy as np
import pytest
import torch

from lipreading_tpu_torch import stream_eval, stream_latency
from lipreading_tpu_torch.fixtures import (
    make_clip,
    render_faceless_frames,
)
from lipreading_tpu_torch.io import load_preprocessors, load_release_model
from lipreading_tpu_torch.metrics import cer
from lipreading_tpu_torch.streaming import StreamingTranscriber
from tests.test_torch_helpers import file_hang_guard  # noqa: F401

pytestmark = pytest.mark.usefixtures("file_hang_guard")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The beams issue many small ops a step: one intra-op thread keeps the
    file near its time alone beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(model, cfg, prep, frames, chunk, **kw):
    det, lmk, presence = prep
    st = StreamingTranscriber(model, cfg, det, lmk, presence=presence, **kw)
    for lo in range(0, frames.shape[0], chunk):
        st.feed(frames[lo:lo + chunk])
    return st.finish(), st


def test_styled_stream_ladder_pin():
    model, cfg = load_release_model("transformer_hybrid_universal4",
                                    device="cpu")
    prep = load_preprocessors(cfg.preprocess.landmarker, "robust",
                              tracked=True, device="cpu")
    clips = [make_clip(s, cfg.data, variation=0.6) for s in (33001, 33002)]
    frames = np.concatenate([c.frames for c in clips])
    truth = " ".join(c.text for c in clips)
    hyp, st = _stream(model, cfg, prep, frames, 8, window=64,
                      decode_every=12, chunk_bucket=8, beam=4, lm_weight=0.4,
                      tracked=True)
    assert st.cut_events >= 1, st.cut_events
    assert cer(hyp, truth) == 0.0, (hyp, truth)


@pytest.fixture(scope="module")
def universal():
    model, cfg = load_release_model("transformer_hybrid_universal",
                                    device="cpu")
    return model, cfg


def test_gap_flush_resets_context_at_shot_boundary(universal):
    model, cfg = universal
    prep = load_preprocessors(cfg.preprocess.landmarker, tracked=True,
                              device="cpu")
    clips = [make_clip(5501 + i, cfg.data) for i in range(2)]
    gap = render_faceless_frames(7, 40, cfg.data)
    frames = np.concatenate([clips[0].frames, gap, clips[1].frames])
    truth = " ".join(c.text for c in clips)

    def run(gap_flush, **kw):
        return _stream(model, cfg, prep, frames, 16, window=64,
                       decode_every=16, chunk_bucket=16, tracked=True,
                       gap_flush=gap_flush, **kw)[0]

    flushed, unflushed = run(25), run(0)
    e_f, e_u = cer(flushed, truth), cer(unflushed, truth)
    assert e_f <= e_u + 1e-9, (flushed, unflushed, truth)
    assert e_f < 0.12, (flushed, truth)
    beam_flushed = run(25, beam=4, lm_weight=0.4)
    assert cer(beam_flushed, truth) < 0.12, (beam_flushed, truth)


def test_beam_commits_beat_greedy_commits(universal):
    model, cfg = universal
    prep = load_preprocessors(cfg.preprocess.landmarker, device="cpu")

    def stream(frames, beam):
        return _stream(model, cfg, prep, frames, 8, window=48,
                       decode_every=12, chunk_bucket=8, beam=beam,
                       lm_weight=0.4)[0]

    clip = make_clip(717171 + 11, cfg.data)
    g = cer(stream(clip.frames, 1), clip.text)
    b = cer(stream(clip.frames, 4), clip.text)
    assert b < g, (b, g)

    clips = [make_clip(8801 + i, cfg.data) for i in range(2)]
    frames = np.concatenate([c.frames for c in clips])
    truth = " ".join(c.text for c in clips)
    g2 = cer(stream(frames, 1), truth)
    b2 = cer(stream(frames, 4), truth)
    assert b2 <= g2 + 1e-9, (b2, g2)


def test_stream_eval_universal4_rung(capsys):
    rows = stream_eval.main(["releases=universal4", "pairs=1",
                             "device=cpu"])
    (seeds, floor, plain, tracked), = rows["universal4"]
    assert seeds == (33001, 33002)
    assert (round(plain, 4), tracked) == (0.2, 0.0), (floor, plain, tracked)
    out = capsys.readouterr().out
    assert "universal4 (33001, 33002): floor=" in out
    assert "universal4 MEAN over 1 streams" in out


def test_stream_latency_reports_both_configs(capsys):
    out = stream_latency.main(["clips=1", "device=cpu"])
    assert [r["config"] for r in out] == ["greedy", "quality"]
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2
    for r in out:
        assert r["chunks"] == -(-make_clip(33001).frames.shape[0] // 8)
        assert r["chunk_ms_p50"] <= r["chunk_ms_p95"] <= r["chunk_ms_max"]
        assert r["rtf"] > 0 and 0.0 <= r["cer"] <= 1.0
        assert set(r) == {"config", "rtf", "margin", "chunk_ms_p50",
                          "chunk_ms_p95", "chunk_ms_max", "finish_ms",
                          "chunks", "chunk_frames", "stream_s", "cer"}
