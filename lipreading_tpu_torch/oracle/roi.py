"""Mouth-box geometry on the host (copy of ``grayscale``,
``mouth_box_from_landmarks`` and ``round_box`` in
``lipreading_tpu/oracle/roi.py``): numpy, frame by frame. The preprocessor
trainers gray their frames with it, and ``conv_box_agreement`` rounds the
mouth boxes behind both landmarkers with it."""

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
