"""The port's preprocessing (``lipreading_tpu_torch.ops``) against the JAX
package on the CPU: grayscale, full-frame resize, the ROI sampler's plain
version in both box modes, face detection, the ERT cascade, mouth boxes and
the whole frames -> ROIs path, also against the golden dump of clip 0.

Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipreading_tpu.ops import detector as jdet
from lipreading_tpu.ops import ert as jert
from lipreading_tpu.ops import preprocess as jpre
from lipreading_tpu.ops import roi as jroi
from lipreading_tpu.oracle.ert import random_ert
from lipreading_tpu_torch import io as tio
from lipreading_tpu_torch.ops import detector as tdet
from lipreading_tpu_torch.ops import ert as tert
from lipreading_tpu_torch.ops import preprocess as tpre
from lipreading_tpu_torch.ops import roi as troi


@pytest.fixture(scope="module")
def port_assets():
    det, ert = tio.load_assets()
    return det, ert, tdet.params_to_torch(det, "cpu"), tert.model_to_torch(ert, "cpu")


@pytest.fixture(scope="module")
def gray():
    """Six gray frames of clip 0 (the golden dump's input)."""
    from lipreading_tpu_torch.fixtures import make_clip

    frames = make_clip(0).frames[:6]
    return np.asarray(jroi.grayscale(jnp.asarray(frames)))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_grayscale_matches_jax():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(3, 17, 23, 3), dtype=np.uint8)
    want = np.asarray(jroi.grayscale(jnp.asarray(frames)))
    got = troi.grayscale(_t(frames)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("out", [32, 64])
def test_resize_frames_matches_jax(out):
    """Two float32 products with the same constant weights, summed in another
    order: within two float32 ulps at 255 (3e-5, about 1e-7 of the range)."""
    rng = np.random.default_rng(1)
    g = rng.uniform(0, 255, size=(4, 48, 40)).astype(np.float32)
    want = np.asarray(jroi.resize_frames(jnp.asarray(g), out))
    got = troi.resize_frames(_t(g), out).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * np.spacing(np.float32(255)))


def _boxes(rng, n, H, W, subpixel):
    s = rng.uniform(4, 40, size=n)
    x = rng.uniform(-6, W - 4, size=n)
    y = rng.uniform(-6, H - 4, size=n)
    b = np.stack([x, y, s], 1)
    if not subpixel:
        b = np.floor(b).astype(np.int32)
        b[:, 2] = np.maximum(b[:, 2], 2)
        b[0] = (0, 0, 2)                 # smallest box
        b[1] = (W - 3, H - 3, 3)         # against the far edges
        return b
    return b.astype(np.float32)


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
def test_sample_rois_matches_jax(subpixel, normalize):
    """Plain version vs ``sample_rois_xla`` and the Pallas kernel run in
    interpret mode, R = 32, on noise frames (neighbouring pixels differ by up
    to 255, the worst case for a shifted tap).

    Against ``sample_rois_xla``: 1e-5 on normalised values, 1 float32 ulp at
    255 on raw ones; both are float32 products of the same two-tap weights.
    Against the Pallas kernel in interpret mode: 1e-4 normalised, 1e-3 raw,
    the JAX package's own kernel-vs-oracle bound; in subpixel mode the
    interpreted kernel rounds the tap position differently from
    ``sample_rois_xla`` (they differ from each other by 1.8e-5 here)."""
    rng = np.random.default_rng(2 + subpixel)
    H, W, R = 48, 56, 32
    g = rng.uniform(0, 255, size=(6, H, W)).astype(np.float32)
    b = _boxes(rng, 6, H, W, subpixel)
    kw = dict(normalize=normalize, subpixel=subpixel)
    xla = np.asarray(jroi.sample_rois_xla(jnp.asarray(g), jnp.asarray(b), R, **kw))
    pallas = np.asarray(jroi.sample_rois_pallas(
        jnp.asarray(g), jnp.asarray(b), R, interpret=True, **kw))
    got = troi.sample_rois(_t(g), _t(b), R, **kw).numpy()
    if normalize:
        np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got, xla, rtol=0,
                                   atol=np.spacing(np.float32(255)))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-3)


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("H,W,R", [(48, 56, 97), (40, 161, 32)])
def test_sample_rois_matches_jax_at_odd_sizes(subpixel, normalize, H, W, R):
    """The limits of test_sample_rois_matches_jax at an R that is not a
    multiple of 4 (97: the kernel's last column quad is partial) and a
    frame of W 161 (rows that are not 16-byte aligned)."""
    rng = np.random.default_rng(H + W + R + subpixel)
    g = rng.uniform(0, 255, size=(5, H, W)).astype(np.float32)
    b = _boxes(rng, 5, H, W, subpixel)
    kw = dict(normalize=normalize, subpixel=subpixel)
    xla = np.asarray(jroi.sample_rois_xla(jnp.asarray(g), jnp.asarray(b), R, **kw))
    pallas = np.asarray(jroi.sample_rois_pallas(
        jnp.asarray(g), jnp.asarray(b), R, interpret=True, **kw))
    got = troi.sample_rois(_t(g), _t(b), R, **kw).numpy()
    if normalize:
        np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(got, xla, rtol=0,
                                   atol=np.spacing(np.float32(255)))
        np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-3)


def test_sample_rois_cpu_uses_plain_version_and_counts_nothing():
    g = torch.zeros((2, 8, 8))
    b = torch.tensor([[0, 0, 4], [2, 2, 5]], dtype=torch.int32)
    before = troi.sample_rois.launches
    out = troi.sample_rois(g, b, 4)
    assert troi.sample_rois.launches == before
    torch.testing.assert_close(out, troi.sample_rois_reference(g, b, 4),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "float_boxes_int_mode"])
def test_sample_rois_rejects_bad_inputs(bad):
    g = torch.zeros((2, 8, 8))
    b = torch.zeros((2, 3), dtype=torch.int32)
    if bad == "dtype":
        g = g.double()
    elif bad == "shape":
        b = b[:, :2]
    else:
        b = b.float()
    with pytest.raises((TypeError, ValueError)):
        troi.sample_rois(g, b, 4)


def test_detect_matches_jax_and_golden(port_assets, gray, golden):
    det_np, _, det, _ = port_assets
    want = np.asarray(jdet.detect(jdet.params_to_jax(det_np), jnp.asarray(gray)))
    feats, head = tdet.forward_features(det, troi.resize_frames(_t(gray), 64))
    jfeats, jhead = jdet.forward_features(
        jdet.params_to_jax(det_np), jroi.resize_frames(jnp.asarray(gray), 64))
    np.testing.assert_allclose(head.numpy(), np.asarray(jhead), atol=1e-4)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-4)
    got = tdet.detect(det, _t(gray)).numpy()
    # boxes are ~100 px: 1e-3 px is a few float32 ulps of exp and sigmoid
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, golden["face_boxes"][:6], rtol=0, atol=1e-3)


@pytest.mark.parametrize("weights", ["trained", "random"])
def test_ert_matches_jax(port_assets, gray, golden, weights):
    if weights == "trained":
        _, ert_np, _, ert = port_assets
        boxes = golden["face_boxes"][:6]
    else:
        ert_np = random_ert(0)
        ert = tert.model_to_torch(ert_np, "cpu")
        boxes = np.tile(np.float32([[20.0, 20.0, 120.0]]), (len(gray), 1))
    want = np.asarray(jert.predict_batch(jert.model_to_jax(ert_np),
                                         jnp.asarray(gray), jnp.asarray(boxes)))
    got = tert.predict_batch(ert, _t(gray), _t(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    if weights == "trained":
        np.testing.assert_allclose(got, golden["landmarks"][:6], atol=1e-3)


def test_mouth_boxes_match_jax():
    rng = np.random.default_rng(5)
    lmk = rng.uniform(-20, 180, size=(32, 68, 2)).astype(np.float32)
    lmk[:4, 48:68] = rng.uniform(70, 90, size=(4, 20, 2))
    want = np.asarray(jpre.mouth_boxes_from_landmarks(jnp.asarray(lmk), 0.3,
                                                      160, 160))
    got = tpre.mouth_boxes_from_landmarks(_t(lmk), 0.3, 160, 160)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    wantf = np.asarray(jpre.mouth_boxes_float(jnp.asarray(lmk), 0.3))
    np.testing.assert_allclose(tpre.mouth_boxes_float(_t(lmk), 0.3).numpy(),
                               wantf, rtol=0, atol=1e-5)


def test_preprocess_frames_matches_golden_and_jax(port_assets, golden):
    """Clip 0's first 16 frames: mouth boxes identical to the golden dump
    and to the JAX package, ROIs within 1e-4."""
    from lipreading_tpu_torch.fixtures import make_clip

    det_np, ert_np, det, ert = port_assets
    frames = make_clip(0).frames[:16]
    rois, aux = tpre.preprocess_frames(det, ert, _t(frames), return_aux=True)
    np.testing.assert_array_equal(aux["mouth_boxes"].numpy(),
                                  golden["mouth_boxes"][:16])
    np.testing.assert_allclose(rois.numpy(), golden["roi"][:16], atol=1e-4)
    jrois, jaux = jpre.preprocess_frames(
        jdet.params_to_jax(det_np), jert.model_to_jax(ert_np),
        jnp.asarray(frames), return_aux=True)
    np.testing.assert_array_equal(aux["mouth_boxes"].numpy(),
                                  np.asarray(jaux["mouth_boxes"]))
    np.testing.assert_allclose(rois.numpy(), np.asarray(jrois), atol=1e-4)


def test_preprocess_clips_folds_time(port_assets):
    from lipreading_tpu_torch.fixtures import make_clip

    _, _, det, ert = port_assets
    frames = make_clip(0).frames[:8]
    clips = _t(frames).reshape(2, 4, *frames.shape[1:])
    got = tpre.preprocess_clips(det, ert, clips)
    assert got.shape == (2, 4, 96, 96)
    flat = tpre.preprocess_frames(det, ert, _t(frames))
    torch.testing.assert_close(got.reshape(8, 96, 96), flat, rtol=0, atol=0)


def test_full_float32_restores_caller_settings():
    prev = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        with troi.full_float32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]
