"""The per-frame preprocessing oracle on the host (counterpart of
``lipreading_tpu/oracle/pipeline.py``): numpy, one frame at a time, stage
for stage the loop that the batched ``ops/preprocess.preprocess_frames``
replaces on the card::

    for each frame:
        gray = grayscale(frame)
        box = detect(gray)                  # the conv face detector
        landmarks = ert(gray, box)          # the regression-tree cascade
        mouth = round_box(mouth_box(landmarks))
        roi = normalize(sample(gray, mouth, R))

Its frames/s is the denominator of the north star's "≥10x the reference's
CPU frames/sec", and ``golden_dump`` writes the per-stage tensors of one
clip that every kernel change is diffed against (``tests/golden/clip0.npz``;
``python -m lipreading_tpu_torch.make_golden`` writes them anew).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from lipreading_tpu_torch.config import PreprocessConfig
from lipreading_tpu_torch.oracle import detector as det
from lipreading_tpu_torch.oracle import ert
from lipreading_tpu_torch.oracle.roi import (
    grayscale,
    mouth_box_from_landmarks,
    normalize_roi,
    round_box,
    sample_roi,
)


@dataclass
class PreprocResult:
    gray: np.ndarray        # [T, H, W] f32
    face_boxes: np.ndarray  # [T, 3] (x0, y0, size)
    landmarks: np.ndarray   # [T, 68, 2] predicted
    mouth_boxes: np.ndarray # [T, 3] (x0, y0, size)
    roi: np.ndarray         # [T, R, R] normalized f32
    frames_per_sec: float   # the loop's measured throughput


def run_clip(
    frames: np.ndarray,
    det_params: dict[str, np.ndarray],
    ert_model: ert.ERTModel,
    cfg: PreprocessConfig | None = None,
    landmarks_override: np.ndarray | None = None,
    boxes_override: np.ndarray | None = None,
) -> PreprocResult:
    """The per-frame loop over a [T, H, W, 3] uint8 clip.

    ``landmarks_override`` / ``boxes_override`` put given landmarks or face
    boxes (the fixtures' ground truth) in place of a stage's own, to hold
    the stages apart in parity tests."""
    cfg = cfg or PreprocessConfig()
    T = frames.shape[0]
    R = cfg.roi_size
    gray = np.empty(frames.shape[:3], dtype=np.float32)
    face_boxes = np.empty((T, 3), dtype=np.float32)
    landmarks = np.empty((T, 68, 2), dtype=np.float32)
    mouth_boxes = np.empty((T, 3), dtype=np.float32)
    roi = np.empty((T, R, R), dtype=np.float32)

    t0 = time.perf_counter()
    for t in range(T):
        g = grayscale(frames[t])
        gray[t] = g
        if boxes_override is not None:
            box = tuple(np.asarray(boxes_override[t], dtype=np.float32))
        else:
            box = det.detect(det_params, g)
        face_boxes[t] = box
        if landmarks_override is not None:
            lm = np.asarray(landmarks_override[t], dtype=np.float32)
        else:
            lm = ert.predict(ert_model, g, box)
        landmarks[t] = lm
        mbox = round_box(
            mouth_box_from_landmarks(lm, cfg.roi_margin),
            frames.shape[1], frames.shape[2],
        )
        mouth_boxes[t] = mbox
        raw = sample_roi(g, (mbox[0], mbox[1], mbox[2], mbox[2]), R)
        roi[t] = normalize_roi(raw, cfg.normalize_mean, cfg.normalize_std)
    dt = time.perf_counter() - t0

    return PreprocResult(
        gray=gray,
        face_boxes=face_boxes,
        landmarks=landmarks,
        mouth_boxes=mouth_boxes,
        roi=roi,
        frames_per_sec=T / dt if dt > 0 else float("inf"),
    )


def golden_dump(result: PreprocResult, path) -> None:
    """The per-stage tensors of one clip -> a compressed ``.npz``."""
    np.savez_compressed(
        path,
        gray=result.gray,
        face_boxes=result.face_boxes,
        landmarks=result.landmarks,
        mouth_boxes=result.mouth_boxes,
        roi=result.roi,
    )


def load_golden(path) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
