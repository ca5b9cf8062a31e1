"""The port's host C++ oracle (``lipreading_tpu_torch/native.py`` over
``csrc/lipreading_host.cpp``, built with g++ by the test) against the
port's numpy oracle, on the cases and limits of ``tests/test_native.py``;
a failed build raises with g++'s output."""

import shutil

import numpy as np
import pytest

from lipreading_tpu_torch import native
from lipreading_tpu_torch.fixtures import make_clip
from lipreading_tpu_torch.io import load_assets
from lipreading_tpu_torch.oracle import ert as oert
from lipreading_tpu_torch.oracle.pipeline import run_clip
from lipreading_tpu_torch.oracle.roi import grayscale as ogray
from lipreading_tpu_torch.oracle.roi import sample_roi
from tests.test_torch_helpers import (  # noqa: F401
    few_torch_threads,
    file_hang_guard,
)

pytestmark = pytest.mark.usefixtures("file_hang_guard", "few_torch_threads")


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the host oracle is built with it")
    return native.load()        # builds at first use; raises on failure


@pytest.fixture(scope="module")
def clip():
    return make_clip(21)


def _want_roi(g, x0, y0, s, out):
    return ((sample_roi(g, (x0, y0, s, s), out) / 255.0 - np.float32(0.421))
            / np.float32(0.165))


def test_native_grayscale(lib, clip):
    assert native.available()
    want = ogray(clip.frames[0])
    got = native.grayscale(clip.frames[0])
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_native_roi(lib, clip):
    g = ogray(clip.frames[0])
    for box in [(30, 40, 64), (0, 0, 37), (90, 100, 60)]:
        got = native.sample_roi(g, box)
        np.testing.assert_allclose(got, _want_roi(g, *box, 96), atol=1e-4)
    raw = native.sample_roi(g, (30, 40, 64), normalize=False)
    np.testing.assert_allclose(raw, sample_roi(g, (30, 40, 64, 64), 96),
                               atol=1e-3)
    with pytest.raises(ValueError, match="out_size 0"):
        native.sample_roi(g, (30, 40, 64), out_size=0)


def test_native_ert(lib, clip):
    model = oert.random_ert(1)
    g = ogray(clip.frames[0])
    box = (20.0, 25.0, 110.0)
    np.testing.assert_allclose(native.ert_predict(model, g, box),
                               oert.predict(model, g, box), atol=1e-3)


def test_native_roi_adversarial_sizes_fuzz(lib, clip):
    """Output sizes past 256 and odd or extreme crops stay within 1e-4 of
    the numpy oracle."""
    g = ogray(clip.frames[0])
    H, W = g.shape
    rng = np.random.default_rng(99)
    cases = [(0, 0, 2, 1), (5, 7, 3, 257), (10, 12, 97, 300),
             (0, 0, min(H, W), 512), (33, 21, 101, 384)]
    for _ in range(10):
        s = int(rng.integers(2, min(H, W)))
        x0 = int(rng.integers(0, W - s + 1))
        y0 = int(rng.integers(0, H - s + 1))
        out = int(rng.integers(2, 420))
        cases.append((x0, y0, s, out))
    for x0, y0, s, out in cases:
        got = native.sample_roi(g, (x0, y0, s), out_size=out)
        np.testing.assert_allclose(got, _want_roi(g, x0, y0, s, out),
                                   atol=1e-4, err_msg=str((x0, y0, s, out)))


def test_native_ert_large_pool(lib, clip):
    """Pool sizes past 512 work."""
    model = oert.random_ert(2, pool=700)
    g = ogray(clip.frames[0])
    box = (20.0, 25.0, 110.0)
    np.testing.assert_allclose(native.ert_predict(model, g, box),
                               oert.predict(model, g, box), atol=1e-3)


def test_native_full_clip(lib, clip):
    """The whole clip through the C++ loop against ``run_clip`` from the
    same face boxes."""
    det, ert = load_assets()
    frames = clip.frames[:10]
    want = run_clip(frames, det, ert)
    rois, lms = native.preprocess_clip(ert, frames, want.face_boxes,
                                       return_landmarks=True)
    np.testing.assert_allclose(lms, want.landmarks, atol=1e-2)
    np.testing.assert_allclose(rois, want.roi, atol=1e-3)
    np.testing.assert_array_equal(
        native.preprocess_clip(ert, frames, want.face_boxes), rois)
    with pytest.raises(ValueError, match="boxes"):
        native.preprocess_clip(ert, frames, want.face_boxes[:3])


def test_failed_build_raises_with_the_compiler_output(lib, tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" void lr_grayscale( { }\n')
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed") as e:
        native.build()
    assert "broken.cpp" in str(e.value) and "error" in str(e.value)
