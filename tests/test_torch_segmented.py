"""Shot segmentation (``infer.frame_signature``, ``signature_cuts``,
``segment_valid_runs``, ``transcribe_segmented``) and tracked padded
preprocessing (``ops.preprocess.preprocess_padded_tracked``) against the
JAX package on the CPU, on the two videos of the JAX streaming tests: a
cutaway (``make_clip(5501)``, 40 faceless frames, ``make_clip(5502)``) and a
hard cut (``make_clip(6601)`` and ``make_clip(6602)`` back to back).

Tolerances: the numpy helpers, the spans and the transcripts exact (string
for string, on the universal4 release, ``cascade`` off and on); the tracked
ROIs 1e-5 and ``valid`` exact (the release's ERT landmarker). Both packages
decode the JAX package's ROIs, so the comparison of the decode does not
rest on the preprocessing's rounding."""


import jax
import numpy as np
import pytest
import torch

from lipreading_tpu import infer as jinf
from lipreading_tpu.fixtures import make_clip, render_faceless_frames
from lipreading_tpu.ops.detector import params_to_jax
from lipreading_tpu.ops.ert import model_to_jax
from lipreading_tpu.ops.preprocess import preprocess_padded_tracked
from lipreading_tpu.preproc_training import load_assets as j_load_assets
from lipreading_tpu.preproc_training import load_presence as j_load_presence
from lipreading_tpu.preproc_training import load_release_model as j_release
from lipreading_tpu_torch import infer
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.ops import detector as tdet
from lipreading_tpu_torch.ops import ert as tert
from lipreading_tpu_torch.ops import preprocess as tpre
from tests.test_torch_helpers import file_hang_guard  # noqa: F401

RELEASE = "transformer_hybrid_universal4"

pytestmark = pytest.mark.usefixtures("file_hang_guard")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The beams issue many small ops a step: one intra-op thread keeps the
    file near its time alone beside other test workers (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _videos(cfg_data):
    a, b = make_clip(5501, cfg_data), make_clip(5502, cfg_data)
    cutaway = np.concatenate([a.frames, render_faceless_frames(7, 40, cfg_data),
                              b.frames])
    c, d = make_clip(6601, cfg_data), make_clip(6602, cfg_data)
    return {"cutaway": (cutaway, None),
            "hard_cut": (np.concatenate([c.frames, d.frames]), len(c.frames))}


@pytest.fixture(scope="module")
def videos():
    """Each video's frames, the JAX package's tracked ROIs and valid, and
    its transcribe_segmented results with cascade off and on."""
    params, jcfg = j_release(RELEASE)
    det_np, ert_np = j_load_assets()
    presence = j_load_presence()
    det, ert = params_to_jax(det_np), model_to_jax(ert_np)
    out = {}
    for name, (frames, cut) in _videos(jcfg.data).items():
        rois, valid = preprocess_padded_tracked(det, presence, ert, frames,
                                                jcfg.preprocess)
        sig = jinf.frame_signature(frames) if cut else None
        want = {c: jinf.transcribe_segmented(params, jcfg, rois, valid,
                                             gap=25, cascade=c, sig=sig)
                for c in (False, True)}
        out[name] = dict(frames=frames, cut=cut, rois=np.asarray(rois),
                         valid=np.asarray(valid), sig=sig, want=want)
    model, cfg = tio.load_release_model(RELEASE, device="cpu")
    return dict(out=out, model=model, cfg=cfg, det_np=det_np, ert_np=ert_np)


def test_frame_signature_and_cuts_match_jax(videos):
    rng = np.random.default_rng(0)
    for frames in (rng.integers(0, 256, (5, 37, 45, 3), dtype=np.uint8),
                   rng.integers(0, 256, (3, 32, 32), dtype=np.uint8)):
        np.testing.assert_array_equal(infer.frame_signature(frames, grid=8),
                                      jinf.frame_signature(frames, grid=8))
    for v in videos["out"].values():
        sig = infer.frame_signature(v["frames"])
        np.testing.assert_array_equal(sig, jinf.frame_signature(v["frames"]))
        for k, m in ((8.0, 0.02), (3.0, 0.0), (50.0, 0.5)):
            np.testing.assert_array_equal(infer.signature_cuts(sig, k, m),
                                          jinf.signature_cuts(sig, k, m))
    hard = videos["out"]["hard_cut"]
    assert infer.signature_cuts(hard["sig"]).tolist() == [hard["cut"]]
    assert infer.signature_cuts(np.zeros((1, 4, 4))).shape == (0,)


def test_segment_valid_runs_matches_jax():
    rng = np.random.default_rng(1)
    masks = [rng.uniform(size=60) > p for p in (0.1, 0.5, 0.9)]
    masks += [np.zeros(9, bool), np.ones(9, bool)]
    v = np.zeros(40, bool)
    v[3:8] = v[30:35] = True
    masks.append(v)
    for m in masks:
        for gap in (0, 1, 3, 25):
            assert (infer.segment_valid_runs(m, gap)
                    == jinf.segment_valid_runs(m, gap))


@pytest.mark.parametrize("name", ["cutaway", "hard_cut"])
def test_preprocess_padded_tracked_matches_jax(videos, name):
    v = videos["out"][name]
    cfg = videos["cfg"]
    rois, valid = tpre.preprocess_padded_tracked(
        tdet.params_to_torch(videos["det_np"], "cpu"),
        tdet.params_to_torch(tio.load_presence(), "cpu"),
        tert.model_to_torch(videos["ert_np"], "cpu"), v["frames"],
        cfg.preprocess)
    np.testing.assert_array_equal(valid, v["valid"])
    np.testing.assert_allclose(rois, v["rois"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("cascade", [False, True])
@pytest.mark.parametrize("name", ["cutaway", "hard_cut"])
def test_transcribe_segmented_matches_jax(videos, name, cascade):
    v = videos["out"][name]
    text, segs = infer.transcribe_segmented(
        videos["model"], videos["cfg"], v["rois"], v["valid"], gap=25,
        cascade=cascade, sig=v["sig"])
    want_text, want_segs = v["want"][cascade]
    assert len(segs) == 2
    assert [s for s, _ in segs] == [tuple(s) for s, _ in want_segs]
    assert [t for _, t in segs] == [t for _, t in want_segs]
    assert text == want_text
