"""The port's per-frame oracle (``lipreading_tpu_torch/oracle/``: ``roi``,
``detector``, ``ert.random_ert``, ``pipeline``) against the JAX package's
``lipreading_tpu/oracle/``, exactly; ``run_clip`` against the checked-in
golden dump ``tests/golden/clip0.npz``, exactly; ``make_golden`` into a
temporary path equal to it (and refusing the checked-in path); the port's
batched ``preprocess_frames`` on the CPU against ``run_clip`` within the
limits of ``tests/test_parity.py::test_full_pipeline_parity``."""

import numpy as np
import pytest
import torch

from lipreading_tpu.oracle import detector as jdet
from lipreading_tpu.oracle import ert as jert
from lipreading_tpu.oracle import pipeline as jpipe
from lipreading_tpu.oracle import roi as jroi
from lipreading_tpu_torch.io import load_assets
from lipreading_tpu_torch.oracle import detector as pdet
from lipreading_tpu_torch.oracle import ert as pert
from lipreading_tpu_torch.oracle import pipeline as ppipe
from lipreading_tpu_torch.oracle import roi as proi
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")

STAGES = ("gray", "face_boxes", "landmarks", "mouth_boxes", "roi")


@pytest.fixture(scope="module")
def port_assets():
    return load_assets()


@pytest.fixture(scope="module")
def oracle0(port_assets, clip0):
    det, ert = port_assets
    return ppipe.run_clip(clip0.frames, det, ert)


def _gray(seed, H=120, W=160):
    return np.random.default_rng(seed).uniform(0, 255, (H, W)).astype(
        np.float32)


@pytest.mark.parametrize("box,out", [((32, 40, 64, 64), 96), ((0, 0, 37, 37), 96),
                                     ((100, 50, 60, 60), 24), ((5, 3, 2, 2), 7),
                                     ((150, 110, 9, 9), 300)])
def test_sample_roi_equals_jax(box, out):
    g = _gray(1)
    got = proi.sample_roi(g, box, out)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jroi.sample_roi(g, box, out))
    np.testing.assert_array_equal(proi.normalize_roi(got, 0.4, 0.2),
                                  jroi.normalize_roi(got, 0.4, 0.2))


@pytest.mark.parametrize("box", [(31.3, 40.7, 63.2), (-4.5, 2.25, 20.0),
                                 (150.9, 110.1, 30.5)])
def test_sample_roi_subpixel_equals_jax(box):
    g = _gray(2)
    np.testing.assert_array_equal(proi.sample_roi_subpixel(g, box, 96),
                                  jroi.sample_roi_subpixel(g, box, 96))


def test_detector_forward_and_boxes_equal_jax(port_assets, clip0):
    det, _ = port_assets
    for t in (0, 17, 40):
        g = proi.grayscale(clip0.frames[t])
        small = proi.resize_frame(g, pdet.INPUT)
        np.testing.assert_array_equal(small, jroi.resize_frame(g, jdet.INPUT))
        head = pdet.forward(det, small)
        np.testing.assert_array_equal(head, jdet.forward(det, small))
        x = np.random.default_rng(t).normal(size=(10, 12, 3)).astype(
            np.float32)
        w = np.random.default_rng(t + 1).normal(size=(3, 3, 3, 5)).astype(
            np.float32)
        np.testing.assert_array_equal(pdet._conv2d(x, w, 2),
                                      jdet._conv2d(x, w, 2))
        assert pdet.decode_box(head, 160, 160) == jdet.decode_box(
            head, 160, 160)
        assert pdet.detect(det, g) == jdet.detect(det, g)
    assert pdet._sigmoid(np.float32(0.25)) == jdet._sigmoid(np.float32(0.25))


@pytest.mark.parametrize("kw", [{}, dict(stages=2, pool=16, trees=4, depth=3)])
def test_random_ert_equals_jax(kw, tmp_path):
    got, want = pert.random_ert(3, **kw), jert.random_ert(3, **kw)
    for f in ("mean_shape", "anchors", "offsets", "feat1", "feat2", "thresh",
              "leaves"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.num_stages, got.pool_size, got.num_trees, got.depth) == (
        want.num_stages, want.pool_size, want.num_trees, want.depth)
    got.save(tmp_path / "ert.npz")
    back = pert.ERTModel.load(tmp_path / "ert.npz")
    assert np.array_equal(back.leaves, got.leaves)


def test_run_clip_reproduces_the_golden_dump(oracle0, golden):
    """BASELINE config 1: the oracle rerun equals the checked-in dump."""
    for k in STAGES:
        np.testing.assert_array_equal(getattr(oracle0, k), golden[k],
                                      err_msg=k)
    assert oracle0.frames_per_sec > 0


def test_run_clip_with_overrides_equals_jax(port_assets, clip0, oracle0):
    """The stages held apart: the fixture's landmarks or face boxes in place
    of the oracle's own, and another seeded ERT, equal to JAX's run."""
    det, ert = port_assets
    frames = clip0.frames[:6]
    rnd = pert.random_ert(5)
    for kw, model in (({"landmarks_override": clip0.landmarks[:6]}, ert),
                      ({"boxes_override": oracle0.face_boxes[:6] + 1.5}, ert),
                      ({}, rnd)):
        got = ppipe.run_clip(frames, det, model, **kw)
        want = jpipe.run_clip(frames, det, jert.random_ert(5) if model is rnd
                              else ert, **kw)
        for k in STAGES:
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=f"{k} {list(kw)}")


def test_make_golden_writes_the_golden_dump(tmp_path, golden, oracle0):
    from lipreading_tpu_torch import make_golden

    out = str(tmp_path / "g" / "clip0.npz")
    make_golden.make_golden(out)
    dumped = ppipe.load_golden(out)
    assert set(dumped) == set(STAGES)
    for k in STAGES:
        np.testing.assert_array_equal(dumped[k], golden[k], err_msg=k)
    ppipe.golden_dump(oracle0, tmp_path / "again.npz")
    assert set(jpipe.load_golden(tmp_path / "again.npz")) == set(STAGES)
    with pytest.raises(SystemExit, match="refusing"):
        make_golden.make_golden(make_golden.CHECKED_IN)


def test_preprocess_frames_matches_run_clip(port_assets, oracle0, clip0,
                                           assets):
    """The batched preprocess (the ROI kernel's plain version on the CPU)
    against the per-frame oracle over clip 0's first 48 frames (those of
    ``chip_smoke.py``'s ``[oracle]``): face boxes within 1e-2, mouth boxes
    equal, ROIs within 1e-3, landmarks within 1e-2 but at the ERT knife
    edges, where the JAX package's batched preprocess parts from its oracle
    as well (frame 29, 0.111 px) and the port equals it within 1e-4."""
    import jax.numpy as jnp

    from lipreading_tpu.ops import detector as jddet
    from lipreading_tpu.ops import ert as jdert
    from lipreading_tpu.ops.preprocess import preprocess_frames as j_pre
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch
    from lipreading_tpu_torch.ops.preprocess import preprocess_frames

    det, ert = port_assets
    n = 48
    with torch.inference_mode():
        rois, aux = preprocess_frames(
            params_to_torch(det, "cpu"), model_to_torch(ert, "cpu"),
            torch.from_numpy(clip0.frames[:n]), return_aux=True)
    np.testing.assert_allclose(aux["face_boxes"].numpy(),
                               oracle0.face_boxes[:n], atol=1e-2)
    np.testing.assert_array_equal(aux["mouth_boxes"].numpy(),
                                  oracle0.mouth_boxes[:n])
    np.testing.assert_allclose(rois.numpy(), oracle0.roi[:n], atol=1e-3)
    lm = aux["landmarks"].numpy()
    off = np.abs(lm - oracle0.landmarks[:n]).max(axis=(1, 2))
    edges = np.nonzero(off > 1e-2)[0]
    assert edges.tolist() == [29], off[edges]

    jdet, jert = assets
    _, jaux = j_pre(jddet.params_to_jax(jdet), jdert.model_to_jax(jert),
                    jnp.asarray(clip0.frames[:n]), return_aux=True)
    jlm = np.asarray(jaux["landmarks"])
    joff = np.abs(jlm - oracle0.landmarks[:n]).max(axis=(1, 2))
    assert np.nonzero(joff > 1e-2)[0].tolist() == edges.tolist()
    np.testing.assert_allclose(lm, jlm, atol=1e-4)
