"""Batched video -> mouth-ROI preprocessing (counterpart of
``mouth_boxes_from_landmarks``, ``mouth_boxes_float``, ``preprocess_frames``
and ``preprocess_clips`` in ``lipreading_tpu/ops/preprocess.py``).

    frames [N, H, W, 3] u8 -> gray -> detect -> 68 landmarks -> mouth box
                           -> ROI sampler kernel -> roi [N, R, R] f32

The tracked variant and the conv landmarker are later slices.
"""

from __future__ import annotations

import torch

from lipreading_tpu_torch.config import PreprocessConfig
from lipreading_tpu_torch.ops import detector as det_ops
from lipreading_tpu_torch.ops import ert as ert_ops
from lipreading_tpu_torch.ops import roi as roi_ops


def _mouth_geometry(landmarks: torch.Tensor, margin: float):
    pts = landmarks[:, 48:68, :].float()
    mn = pts.amin(dim=1)
    mx = pts.amax(dim=1)
    c = (mn + mx) / 2.0
    size = torch.amax(mx - mn, dim=1) * (1.0 + margin)
    return c[:, 0] - size / 2.0, c[:, 1] - size / 2.0, size


def mouth_boxes_from_landmarks(landmarks: torch.Tensor, margin: float,
                               frame_h: int, frame_w: int) -> torch.Tensor:
    """[B, 68, 2] -> [B, 3] int32 square mouth boxes (x0, y0, size), rounded
    and shifted into the frame."""
    x0, y0, size = _mouth_geometry(landmarks, margin)
    s = torch.floor(size + 0.5).int().clamp(2, min(frame_h, frame_w))
    xi = torch.minimum(torch.floor(x0 + 0.5).int().clamp(min=0), frame_w - s)
    yi = torch.minimum(torch.floor(y0 + 0.5).int().clamp(min=0), frame_h - s)
    return torch.stack([xi, yi, s], dim=1).int()


def mouth_boxes_float(landmarks: torch.Tensor, margin: float) -> torch.Tensor:
    """[B, 68, 2] -> [B, 3] float32 square mouth boxes, not rounded (the ROI
    sampler's subpixel mode clamps each tap into the frame)."""
    return torch.stack(_mouth_geometry(landmarks, margin), dim=1)


def use_subpixel_roi(cfg: PreprocessConfig) -> bool:
    """Resolve ``cfg.roi_sampling`` ("auto" = subpixel iff the landmarker is
    not the ERT)."""
    if cfg.roi_sampling == "auto":
        return cfg.landmarker != "ert"
    return cfg.roi_sampling == "subpixel"


def preprocess_frames(det_params, ert_model, frames: torch.Tensor,
                      cfg: PreprocessConfig | None = None,
                      return_aux: bool = False):
    """[N, H, W, 3] uint8 RGB -> [N, R, R] normalised float32 ROIs.

    ``det_params`` and ``ert_model`` come from ``ops.detector.params_to_torch``
    and ``ops.ert.model_to_torch`` on the device of ``frames``."""
    cfg = cfg or PreprocessConfig()
    if cfg.landmarker != "ert":
        raise NotImplementedError(
            f"landmarker {cfg.landmarker!r}: the conv landmarker is a later slice")
    N, H, W, _ = frames.shape
    gray = roi_ops.grayscale(frames)                           # [N, H, W]
    face_boxes = det_ops.detect(det_params, gray)              # [N, 3] float
    landmarks = ert_ops.predict_batch(ert_model, gray, face_boxes)
    subpix = use_subpixel_roi(cfg)
    mboxes = (mouth_boxes_float(landmarks, cfg.roi_margin) if subpix else
              mouth_boxes_from_landmarks(landmarks, cfg.roi_margin, H, W))
    rois = roi_ops.sample_rois(gray, mboxes, cfg.roi_size,
                               mean=cfg.normalize_mean, std=cfg.normalize_std,
                               subpixel=subpix)
    if return_aux:
        return rois, {"face_boxes": face_boxes, "landmarks": landmarks,
                      "mouth_boxes": mboxes}
    return rois


def preprocess_clips(det_params, ert_model, clips: torch.Tensor,
                     cfg: PreprocessConfig | None = None) -> torch.Tensor:
    """[B, T, H, W, 3] uint8 -> [B, T, R, R]: time folded into the batch."""
    cfg = cfg or PreprocessConfig()
    B, T, H, W, C = clips.shape
    rois = preprocess_frames(det_params, ert_model,
                             clips.reshape(B * T, H, W, C), cfg)
    return rois.reshape(B, T, cfg.roi_size, cfg.roi_size)
