"""Mouth-ROI geometry and bilinear sampling on the host (copy of
``lipreading_tpu/oracle/roi.py``): numpy, frame by frame. This is the
arithmetic the ROI kernel's boxes and taps are held to, in true float32:

* grayscale: Rec.601 luma on float32 RGB (r*0.299 + g*0.587 + b*0.114);
* crop and resize as ONE bilinear resample with OpenCV's half-pixel
  centres, src = (dst + 0.5) * scale - 0.5, clamped to the crop
  (``cv2.resize`` INTER_LINEAR of an integer crop);
* normalise: (gray / 255 - mean) / std.

The per-frame oracle (``oracle/pipeline.run_clip``) and the detector's
input resize run on it; the preprocessor trainers gray their frames with
it, and ``conv_box_agreement`` rounds the mouth boxes behind both
landmarkers with it."""

from __future__ import annotations

import numpy as np


def grayscale(frame_rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8/float RGB -> [H, W] float32 Rec.601 luma (0..255)."""
    f = frame_rgb.astype(np.float32)
    return f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114


def mouth_box_from_landmarks(
    landmarks: np.ndarray, margin: float = 0.30
) -> tuple[float, float, float]:
    """68-pt landmarks -> square mouth box (x0, y0, size), float geometry:
    the tight box of points 48-67, its longer side grown by ``margin``,
    squared about its centre."""
    pts = np.asarray(landmarks, dtype=np.float32)[48:68]
    x0, y0 = pts.min(axis=0)
    x1, y1 = pts.max(axis=0)
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    size = max(x1 - x0, y1 - y0) * (1.0 + margin)
    return float(cx - size / 2.0), float(cy - size / 2.0), float(size)


def round_box(
    box: tuple[float, float, float], frame_h: int, frame_w: int
) -> tuple[int, int, int]:
    """Float square box -> integer box inside the frame: size and origin
    round half up, then the origin shifts so that the box fits."""
    x0, y0, size = (float(v) for v in box)
    s = int(np.floor(size + 0.5))
    s = max(2, min(s, frame_h, frame_w))
    xi = int(np.floor(x0 + 0.5))
    yi = int(np.floor(y0 + 0.5))
    xi = max(0, min(xi, frame_w - s))
    yi = max(0, min(yi, frame_h - s))
    return xi, yi, s


def sample_roi(
    gray: np.ndarray,
    box: tuple[int, int, int, int],
    out_size: int = 96,
) -> np.ndarray:
    """Bilinear-resample the integer ``box`` (x0, y0, w, h) of a gray frame,
    equal to cropping it and ``cv2.resize(INTER_LINEAR)``: output pixel j
    reads source (j + 0.5) * (w / out) - 0.5 within the crop, clamped to the
    crop's interior (a materialised crop's edge), then interpolated."""
    H, W = gray.shape
    x0, y0, bw, bh = (int(v) for v in box)
    js = np.arange(out_size, dtype=np.float32)

    def weights(n, off, limit):
        src = (js + 0.5) * (np.float32(n) / out_size) - 0.5
        src = np.clip(src, 0.0, n - 1.0)
        i0 = np.floor(src).astype(np.int32)
        i0 = np.minimum(i0, max(n - 2, 0))
        frac = (src - i0).astype(np.float32)
        i0 = np.clip(i0 + off, 0, limit - 2)
        return i0, frac

    yi, yf = weights(bh, y0, H)
    xi, xf = weights(bw, x0, W)
    g = gray.astype(np.float32)
    top = g[yi][:, xi] * (1 - xf)[None, :] + g[yi][:, xi + 1] * xf[None, :]
    bot = g[yi + 1][:, xi] * (1 - xf)[None, :] + g[yi + 1][:, xi + 1] * xf[None, :]
    return top * (1 - yf)[:, None] + bot * yf[:, None]


def sample_roi_subpixel(
    gray: np.ndarray,
    box: tuple[float, float, float],
    out_size: int = 96,
) -> np.ndarray:
    """Bilinear-resample the FLOAT square ``box`` (x0, y0, size), with no
    rounding (the conv landmarker's mouth ROIs): sampling positions are
    clamped to the box's interior, then to the frame."""
    H, W = gray.shape
    x0, y0, size = (np.float32(v) for v in box)
    js = np.arange(out_size, dtype=np.float32)

    def weights(start, limit):
        src = (js + 0.5) * (size / np.float32(out_size)) - np.float32(0.5)
        src = np.clip(src, 0.0, size - 1.0) + start
        src = np.clip(src, 0.0, np.float32(limit - 1))
        i0 = np.clip(np.floor(src), 0.0, np.float32(limit - 2))
        frac = (src - i0).astype(np.float32)
        return i0.astype(np.int32), frac

    yi, yf = weights(y0, H)
    xi, xf = weights(x0, W)
    g = gray.astype(np.float32)
    top = g[yi][:, xi] * (1 - xf)[None, :] + g[yi][:, xi + 1] * xf[None, :]
    bot = g[yi + 1][:, xi] * (1 - xf)[None, :] + g[yi + 1][:, xi + 1] * xf[None, :]
    return top * (1 - yf)[:, None] + bot * yf[:, None]


def normalize_roi(
    roi: np.ndarray, mean: float = 0.421, std: float = 0.165
) -> np.ndarray:
    """0..255 gray ROI -> standardised float32 ((x / 255 - mean) / std)."""
    return ((roi.astype(np.float32) / 255.0) - np.float32(mean)) / np.float32(std)


def resize_frame(gray: np.ndarray, out_size: int) -> np.ndarray:
    """Whole-frame resize (the detector's input) by the same sampling."""
    H, W = gray.shape
    return sample_roi(gray, (0, 0, W, H), out_size)
