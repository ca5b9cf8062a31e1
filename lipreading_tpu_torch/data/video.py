"""Host-side video decode and write (counterpart of ``decode_video`` and
``write_video`` in ``lipreading_tpu/data/video.py``).

Decode stays on the host: frames go to the device as whole uint8 stacks.
Both need OpenCV (``cv2``), imported inside the functions. Where it is
missing, the serving loop renders its fixture clips instead
(``python -m lipreading_tpu_torch.serve source=render``).
"""

from __future__ import annotations

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "video decode and write need OpenCV (cv2), which is not "
            "installed; the serving loop can render its fixture clips "
            "instead: source=render") from e
    return cv2


def decode_video(path: str, max_frames: int | None = None
                 ) -> tuple[np.ndarray, float]:
    """Video file -> ([T, H, W, 3] uint8 RGB, fps)."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path!r}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames = []
    try:
        while max_frames is None or len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[..., ::-1])  # BGR -> RGB
    finally:
        cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path!r}")
    return np.stack(frames).astype(np.uint8), float(fps)


def write_video(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
    """[T, H, W, 3] uint8 RGB -> an mp4v video file."""
    cv2 = _cv2()
    T, H, W, _ = frames.shape
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    out = cv2.VideoWriter(path, fourcc, fps, (W, H))
    if not out.isOpened():
        raise IOError(f"cannot open video writer for {path!r}")
    try:
        for t in range(T):
            out.write(np.ascontiguousarray(frames[t][..., ::-1]))  # RGB -> BGR
    finally:
        out.release()
