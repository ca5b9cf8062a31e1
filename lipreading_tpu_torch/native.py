"""The host C++ preprocessing oracle (counterpart of
``lipreading_tpu/native.py``): ``csrc/lipreading_host.cpp`` holds the
per-frame loop of ``oracle/pipeline.run_clip`` (grayscale, the ERT cascade
from given face boxes, the mouth box and the ROI) in compiled code, with
the numpy oracle's arithmetic, where the host's frames/s matters.

The library is built with ``g++`` at first use into
``_build/host-<hash of the source and flags>/`` inside the package (listed
in ``.gitignore``), so a second run loads it without rebuilding, and it is
bound with ``ctypes`` (``argtypes`` set on every entry). A failed build
raises with g++'s output. ``available()`` says whether it builds on the
machine at hand; nothing falls back to the numpy oracle in its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from ctypes import c_float, c_int, c_void_p

import numpy as np

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "lipreading_host.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(__file__), "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

# C entry -> argtypes (every array as c_void_p)
SIGNATURES = {
    # rgb, h, w, out
    "lr_grayscale": [c_void_p, c_int, c_int, c_void_p],
    # gray, H, W, x0, y0, size, out_size, mean, std, normalize, out
    "lr_sample_roi": [c_void_p] + [c_int] * 6 + [c_float] * 2
                     + [c_int, c_void_p],
    # gray, H, W, bx, by, bsize, mean_shape, anchors, offsets, feat1, feat2,
    # thresh, leaves, S, P, K, D, out
    "lr_ert_predict": [c_void_p, c_int, c_int] + [c_float] * 3
                      + [c_void_p] * 7 + [c_int] * 4 + [c_void_p],
    # frames, T, H, W, boxes, mean_shape, anchors, offsets, feat1, feat2,
    # thresh, leaves, S, P, K, D, roi_margin, out_size, mean, std,
    # landmarks (or NULL), rois
    "lr_preprocess_clip": [c_void_p] + [c_int] * 3 + [c_void_p] * 8
                          + [c_int] * 4 + [c_float, c_int, c_float, c_float]
                          + [c_void_p] * 2,
}

_lib = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX): the host oracle is "
                           "built at first use")
    return cxx


def build() -> str:
    """Compile the library unless one for this source and these flags
    exists -> its path. Raises with the compiler's output if it fails."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f"host-{h}")
    path = os.path.join(out_dir, "liblipreading_host.so")
    if os.path.exists(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"g++ ran past 300 s: {' '.join(cmd)}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built at first use, its entries typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads (a test's skip reason)."""
    try:
        load()
        return True
    except (OSError, RuntimeError):
        return False


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a):
    return a.ctypes.data_as(c_void_p)


def grayscale(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [H, W] float32 luma."""
    lib = load()
    h, w, _ = rgb.shape
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    out = np.empty((h, w), np.float32)
    lib.lr_grayscale(_ptr(rgb), h, w, _ptr(out))
    return out


def sample_roi(gray, box, out_size=96, mean=0.421, std=0.165,
               normalize=True) -> np.ndarray:
    """The integer square ``box`` (x0, y0, size) of a gray frame ->
    [out_size, out_size] float32, normalised unless ``normalize`` is
    false."""
    lib = load()
    gray = _f32(gray)
    H, W = gray.shape
    x0, y0, size = (int(v) for v in box)
    if out_size <= 0 or size <= 0 or H < 2 or W < 2:
        raise ValueError(f"sample_roi: box {box}, out_size {out_size} on a "
                         f"{H}x{W} frame")
    out = np.empty((out_size, out_size), np.float32)
    lib.lr_sample_roi(_ptr(gray), H, W, x0, y0, size, out_size, mean, std,
                      1 if normalize else 0, _ptr(out))
    return out


def _ert_arrays(model):
    return (
        _f32(model.mean_shape), _i32(model.anchors), _f32(model.offsets),
        _i32(model.feat1), _i32(model.feat2), _f32(model.thresh),
        _f32(model.leaves),
    )


def ert_predict(model, gray, box) -> np.ndarray:
    """The cascade on one gray frame and face box (x0, y0, size) -> [68, 2]
    landmarks in pixels."""
    lib = load()
    gray = _f32(gray)
    H, W = gray.shape
    arrays = _ert_arrays(model)
    S, P = model.anchors.shape
    out = np.empty((68, 2), np.float32)
    lib.lr_ert_predict(_ptr(gray), H, W, box[0], box[1], box[2],
                       *map(_ptr, arrays), S, P, model.num_trees,
                       model.depth, _ptr(out))
    return out


def preprocess_clip(model, frames, boxes, roi_margin=0.30, out_size=96,
                    mean=0.421, std=0.165, return_landmarks=False):
    """[T, H, W, 3] uint8 + [T, 3] face boxes -> [T, R, R] normalised ROIs
    (and [T, 68, 2] landmarks with ``return_landmarks``)."""
    lib = load()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    T, H, W, _ = frames.shape
    boxes = _f32(boxes)
    if boxes.shape != (T, 3):
        raise ValueError(f"preprocess_clip: boxes {boxes.shape} for {T} "
                         "frames, want [T, 3]")
    arrays = _ert_arrays(model)
    S, P = model.anchors.shape
    rois = np.empty((T, out_size, out_size), np.float32)
    lms = np.empty((T, 68, 2), np.float32) if return_landmarks else None
    lib.lr_preprocess_clip(
        _ptr(frames), T, H, W, _ptr(boxes), *map(_ptr, arrays),
        S, P, model.num_trees, model.depth, roi_margin, out_size, mean, std,
        _ptr(lms) if lms is not None else None, _ptr(rois))
    return (rois, lms) if return_landmarks else rois
