"""The port's conv landmarker and tracked preprocessing against the JAX
package on the CPU (the JAX side through its XLA path: ``sample_rois``
dispatches to ``sample_rois_xla`` off the TPU).

Tolerances:
* conv ``forward``: 1e-4 box units (float32 convolutions and products
  summed in another order; the reading is ~1e-7);
* ``predict_batch_conv``: 1e-3 px (the same, times a box of ~100 px);
* ``round_face_boxes``: exact;
* tracked preprocessing on clips 61, 62 and 63 as the JAX robustness tests
  build them: ``valid`` exact, face boxes 1e-3 px, ROIs 1e-5 with the ERT.
  With the conv landmarker the ROIs are held to 1e-4: its landmarks agree
  with JAX's to one float32 ulp of their pixel coordinate (1.5e-5 px below
  256), which moves the sub-pixel mouth box, and a normalised ROI moves by
  at most 255 / 255 / 0.165 = 6.1 a pixel, so 1.5e-5 px can move it 9.2e-5
  (the reading is 2.7e-5)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.config import PreprocessConfig as JPre
from lipreading_tpu.fixtures import (
    blank_out_frames,
    make_clip,
    paste_second_face,
)
from lipreading_tpu.ops import detector as jdet
from lipreading_tpu.ops import landmarker as jlmk
from lipreading_tpu.ops import preprocess as jpre
from lipreading_tpu.ops.ert import model_to_jax
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.config import PreprocessConfig
from lipreading_tpu_torch.ops import detector as tdet
from lipreading_tpu_torch.ops import ert as tert
from lipreading_tpu_torch.ops import landmarker as tlmk
from lipreading_tpu_torch.ops import preprocess as tpre
from lipreading_tpu_torch.ops import roi as troi
from tests.test_torch_helpers import file_hang_guard  # noqa: F401

ROI_TOL = {"ert": 1e-5, "conv": 1e-4}

pytestmark = pytest.mark.usefixtures("file_hang_guard")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def weights():
    det, ert = tio.load_assets()
    return dict(det=det, ert=ert, lmk=tio.load_landmarker(),
                presence=tio.load_presence())


def test_load_landmarker_and_presence_match_the_jax_loaders():
    from lipreading_tpu.preproc_training import load_landmarker, load_presence

    for port, ref in ((tio.load_landmarker, load_landmarker),
                      (tio.load_presence, load_presence)):
        for variant in ("default", "robust"):
            got, want = port(variant=variant), ref(variant=variant)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
        assert port(variant="none") is None


def test_params_to_torch_layouts(weights):
    p = tlmk.params_to_torch(weights["lmk"], "cpu")
    assert p["conv2/w"].shape == (32, 16, 3, 3)      # HWIO -> OIHW
    assert p["fc1/w"].shape == (4 * 4 * 96, 256)
    assert all(v.dtype == torch.float32 for v in p.values())


def test_forward_matches_jax(weights):
    rng = np.random.default_rng(0)
    crop = rng.uniform(0, 255, size=(6, 64, 64)).astype(np.float32)
    want = np.asarray(jlmk.forward(jlmk.params_to_jax(weights["lmk"]),
                                   jnp.asarray(crop)))
    got = tlmk.forward(tlmk.params_to_torch(weights["lmk"], "cpu"),
                       _t(crop)).numpy()
    assert got.shape == (6, 68, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_forward_flattens_channels_last(weights):
    """fc1/w's rows are NHWC-ordered: flattening NCHW reads other rows."""
    p = tlmk.params_to_torch(weights["lmk"], "cpu")
    crop = _t(np.random.default_rng(1).uniform(0, 255, (2, 64, 64)).astype(
        np.float32))
    want = np.asarray(jlmk.forward(jlmk.params_to_jax(weights["lmk"]),
                                   jnp.asarray(crop.numpy())))
    q = dict(p)
    q["fc1/w"] = p["fc1/w"].reshape(4, 4, 96, 256).permute(2, 0, 1, 3
                                                           ).reshape(-1, 256)
    wrong = tlmk.forward(q, crop).numpy()
    assert np.abs(wrong - want).max() > 1e-2


def test_round_face_boxes_matches_jax():
    rng = np.random.default_rng(2)
    b = np.stack([rng.uniform(-30, 170, 64), rng.uniform(-30, 170, 64),
                  rng.uniform(-5, 200, 64)], 1).astype(np.float32)
    b[:4] = [[10.5, 2.5, 40.5], [-0.5, 159.5, 1.4999], [150, 150, 300],
             [0, 0, 0]]
    for H, W in ((160, 160), (120, 200)):
        want = np.asarray(jlmk.round_face_boxes(jnp.asarray(b), H, W))
        got = tlmk.round_face_boxes(_t(b), H, W)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_predict_batch_conv_matches_jax(weights):
    """The crop is the ROI sampler's plain version here (its kernel on the
    card), with integer boxes and normalize=0."""
    rng = np.random.default_rng(3)
    gray = rng.uniform(0, 255, size=(5, 160, 160)).astype(np.float32)
    boxes = np.stack([rng.uniform(-10, 120, 5), rng.uniform(-10, 120, 5),
                      rng.uniform(20, 120, 5)], 1).astype(np.float32)
    want = np.asarray(jlmk.predict_batch_conv(
        jlmk.params_to_jax(weights["lmk"]), jnp.asarray(gray),
        jnp.asarray(boxes)))
    before = troi.sample_rois.launches
    got = tlmk.predict_batch_conv(tlmk.params_to_torch(weights["lmk"], "cpu"),
                                  _t(gray), _t(boxes)).numpy()
    assert troi.sample_rois.launches == before    # the CPU counts nothing
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _robust_clips():
    """The frames of the JAX robustness tests: a cutaway (61), a second
    face (62), a clean clip (63)."""
    return {61: blank_out_frames(make_clip(61), [4, 5, 6], seed=2)[:12],
            62: paste_second_face(make_clip(62), donor_seed=901)[:12],
            63: make_clip(63).frames[:10]}


@pytest.fixture(scope="module")
def tracked(weights):
    """Both packages' tracked preprocessing of the three clips, conv and
    ERT landmarkers."""
    det_j = jdet.params_to_jax(weights["det"])
    pres_j = {k: jnp.asarray(v) for k, v in weights["presence"].items()}
    det_t = tdet.params_to_torch(weights["det"], "cpu")
    pres_t = tdet.params_to_torch(weights["presence"], "cpu")
    out = {}
    for lm in ("ert", "conv"):
        mj = (jlmk.params_to_jax(weights["lmk"]) if lm == "conv"
              else model_to_jax(weights["ert"]))
        mt = (tlmk.params_to_torch(weights["lmk"], "cpu") if lm == "conv"
              else tert.model_to_torch(weights["ert"], "cpu"))
        for seed, frames in _robust_clips().items():
            want = jpre.preprocess_clips_tracked(
                det_j, pres_j, mj, jnp.asarray(frames[None]),
                JPre(landmarker=lm), return_aux=True)
            got = tpre.preprocess_clips_tracked(
                det_t, pres_t, mt, _t(frames[None]),
                PreprocessConfig(landmarker=lm), return_aux=True)
            out[lm, seed] = (jax.tree_util.tree_map(np.asarray, want), got)
    return out


@pytest.mark.parametrize("seed", [61, 62, 63])
@pytest.mark.parametrize("lm", ["ert", "conv"])
def test_preprocess_clips_tracked_matches_jax(tracked, lm, seed):
    (wr, wv, wa), (gr, gv, ga) = tracked[lm, seed]
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_allclose(ga["face_boxes"].numpy(), wa["face_boxes"],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(gr.numpy(), wr, rtol=0, atol=ROI_TOL[lm])
    assert torch.isfinite(gr).all()


@pytest.mark.parametrize("lm", ["ert", "conv"])
def test_tracked_properties_of_the_jax_tests(tracked, lm):
    """The cutaway's frames are invalid and carry frame 3's box; the second
    face does not take the track; the clean clip is valid throughout."""
    _, valid, aux = tracked[lm, 61][1]
    assert valid[0].tolist() == [t not in (4, 5, 6) for t in range(12)]
    fb = aux["face_boxes"][0].numpy()
    np.testing.assert_array_equal(fb[4], fb[3])
    np.testing.assert_array_equal(fb[6], fb[3])
    _, _, aux = tracked[lm, 62][1]
    fb = aux["face_boxes"][0].numpy()
    clip = make_clip(62)
    for t in range(12):
        x0, y0, w, h = clip.boxes[t]
        d = np.hypot(fb[t, 0] + fb[t, 2] / 2 - (x0 + w / 2),
                     fb[t, 1] + fb[t, 2] / 2 - (y0 + h / 2))
        assert d < max(w, h) * 0.5, (t, d)
    assert tracked[lm, 63][1][1].all()


def test_preprocess_frames_conv_matches_jax(weights):
    frames = make_clip(64).frames[:8]
    cfg_j, cfg_t = JPre(landmarker="conv"), PreprocessConfig(landmarker="conv")
    want = np.asarray(jpre.preprocess_frames(
        jdet.params_to_jax(weights["det"]), jlmk.params_to_jax(weights["lmk"]),
        jnp.asarray(frames), cfg_j))
    got = tpre.preprocess_frames(
        tdet.params_to_torch(weights["det"], "cpu"),
        tlmk.params_to_torch(weights["lmk"], "cpu"), _t(frames), cfg_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROI_TOL["conv"])


def test_preprocess_padded_matches_jax(weights):
    frames = make_clip(65).frames[:11]
    want = jpre.preprocess_padded(jdet.params_to_jax(weights["det"]),
                                  model_to_jax(weights["ert"]), frames,
                                  bucket=8)
    got = tpre.preprocess_padded(tdet.params_to_torch(weights["det"], "cpu"),
                                 tert.model_to_torch(weights["ert"], "cpu"),
                                 frames, bucket=8)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ROI_TOL["ert"])
