"""Batched video -> mouth-ROI preprocessing (counterpart of
``mouth_boxes_from_landmarks``, ``mouth_boxes_float``, ``use_subpixel_roi``,
``preprocess_frames``, ``preprocess_padded``, ``preprocess_clips``,
``preprocess_clips_tracked`` and ``preprocess_padded_tracked`` in
``lipreading_tpu/ops/preprocess.py``).

    frames [N, H, W, 3] u8 -> gray -> detect -> 68 landmarks -> mouth box
                           -> ROI sampler kernel -> roi [N, R, R] f32

The landmarker is the ERT cascade or the conv landmarker
(``cfg.landmarker``); the second crops the face with the ROI kernel too, so
a call on the card launches the ROI kernel once (ERT) or twice (conv). The
tracked variant scores the detector's top-k cells with the face-presence
head and tracks the face box over time (``ops.tracking``): frames with no
confident face are flagged invalid and keep the carried box.

The JAX package caches one jitted program per padded shape to bound its
compiles; PyTorch compiles nothing, so the port keeps only the bucket
padding, which fixes the shapes the model sees.
"""

from __future__ import annotations

import numpy as np
import torch

from lipreading_tpu_torch.config import PreprocessConfig
from lipreading_tpu_torch.ops import detector as det_ops
from lipreading_tpu_torch.ops import ert as ert_ops
from lipreading_tpu_torch.ops import landmarker as lmk_ops
from lipreading_tpu_torch.ops import roi as roi_ops
from lipreading_tpu_torch.ops.tracking import track_boxes


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


def _landmarks(model, gray: torch.Tensor, face_boxes: torch.Tensor,
               cfg: PreprocessConfig) -> torch.Tensor:
    if cfg.landmarker == "conv":
        return lmk_ops.predict_batch_conv(model, gray, face_boxes)
    if cfg.landmarker != "ert":
        raise ValueError(f"landmarker {cfg.landmarker!r}: need 'ert' or 'conv'")
    return ert_ops.predict_batch(model, gray, face_boxes)


def _mouth_rois(gray: torch.Tensor, landmarks: torch.Tensor,
                cfg: PreprocessConfig):
    """Landmarks -> (mouth boxes, ROIs [N, R, R]): integer boxes, or float
    boxes sampled sub-pixel (``use_subpixel_roi``)."""
    _, H, W = gray.shape
    subpix = use_subpixel_roi(cfg)
    mboxes = (mouth_boxes_float(landmarks, cfg.roi_margin) if subpix else
              mouth_boxes_from_landmarks(landmarks, cfg.roi_margin, H, W))
    rois = roi_ops.sample_rois(gray, mboxes, cfg.roi_size,
                               mean=cfg.normalize_mean, std=cfg.normalize_std,
                               subpixel=subpix)
    return mboxes, rois


def preprocess_frames(det_params, ert_model, frames: torch.Tensor,
                      cfg: PreprocessConfig | None = None,
                      return_aux: bool = False):
    """[N, H, W, 3] uint8 RGB -> [N, R, R] normalised float32 ROIs.

    ``det_params`` and ``ert_model`` come from ``ops.detector.params_to_torch``
    and ``ops.ert.model_to_torch`` on the device of ``frames``; with
    ``cfg.landmarker == "conv"`` ``ert_model`` is the conv landmarker's
    weights (``ops.landmarker.params_to_torch``)."""
    cfg = cfg or PreprocessConfig()
    N, H, W, _ = frames.shape
    gray = roi_ops.grayscale(frames)                           # [N, H, W]
    face_boxes = det_ops.detect(det_params, gray)              # [N, 3] float
    landmarks = _landmarks(ert_model, gray, face_boxes, cfg)
    mboxes, rois = _mouth_rois(gray, landmarks, cfg)
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


def _pad_to_bucket(frames, bucket: int) -> tuple[np.ndarray, int]:
    """[N, ...] -> ([P, ...] with P the next multiple of ``bucket``, the
    last frame repeated; N)."""
    frames = np.asarray(frames)
    n = frames.shape[0]
    padded = -(-n // bucket) * bucket
    if padded != n:
        frames = np.concatenate(
            [frames, np.repeat(frames[-1:], padded - n, axis=0)])
    return frames, n


def preprocess_padded(det_params, ert_model, frames,
                      cfg: PreprocessConfig | None = None,
                      bucket: int = 64) -> np.ndarray:
    """One video's [N, H, W, 3] uint8 frames (numpy) -> numpy [N, R, R]
    ROIs, computed on the device of ``det_params`` over N padded up to a
    multiple of ``bucket`` by repeating the last frame."""
    padded, n = _pad_to_bucket(frames, bucket)
    dev = det_params["conv1/w"].device
    with torch.inference_mode():
        rois = preprocess_frames(det_params, ert_model,
                                 torch.as_tensor(padded, device=dev), cfg)
    return rois[:n].cpu().numpy()


def preprocess_clips_tracked(det_params, presence, ert_model,
                             clips: torch.Tensor,
                             cfg: PreprocessConfig | None = None,
                             threshold: float = 0.5, topk: int = 4,
                             return_aux: bool = False, mark=None):
    """[B, T, H, W, 3] uint8 -> (ROIs [B, T, R, R], valid [B, T] bool).

    The detector's ``topk`` best cells by the presence head's logits
    (``presence``: ``io.load_presence`` arrays on the device) are the
    candidates; ``ops.tracking.track_boxes`` picks one a frame and flags
    frames without a confident face (confidence below ``threshold``)
    invalid, with the carried box. ``return_aux`` adds {"face_boxes" [B, T,
    3], "conf" [B * T, topk], "landmarks" [B * T, 68, 2]}. ``mark(stage)``, if given, is called after
    each stage: "detect" (detector and presence head), "track",
    "landmarks" and "roi" (the serving loop times the stages with it)."""
    mark = mark or (lambda stage: None)
    cfg = cfg or PreprocessConfig()
    B, T, H, W, C = clips.shape
    gray = roi_ops.grayscale(clips.reshape(B * T, H, W, C))    # [BT, H, W]
    feats, head = det_ops.forward_features(
        det_params, roi_ops.resize_frames(gray, det_ops.INPUT))
    pmap = det_ops.presence_logits(presence, feats)            # [BT, 8, 8]
    cand, logit_k = det_ops.decode_boxes_topk(head, H, W, topk, pmap)
    conf = torch.sigmoid(logit_k)
    mark("detect")
    boxes, valid = track_boxes(cand.reshape(B, T, topk, 3),
                               conf.reshape(B, T, topk), threshold)
    mark("track")
    landmarks = _landmarks(ert_model, gray, boxes.reshape(B * T, 3), cfg)
    mark("landmarks")
    _, rois = _mouth_rois(gray, landmarks, cfg)
    rois = rois.reshape(B, T, cfg.roi_size, cfg.roi_size)
    mark("roi")
    if return_aux:
        return rois, valid, {"face_boxes": boxes, "conf": conf,
                             "landmarks": landmarks}
    return rois, valid


def preprocess_padded_tracked(det_params, presence, ert_model, frames,
                              cfg: PreprocessConfig | None = None,
                              bucket: int = 64, threshold: float = 0.5,
                              topk: int = 4):
    """Tracked preprocessing of one video's [N, H, W, 3] uint8 frames
    (numpy), N padded to a multiple of ``bucket`` -> (numpy ROIs [N, R, R]
    float32, numpy valid [N] bool)."""
    padded, n = _pad_to_bucket(frames, bucket)
    dev = det_params["conv1/w"].device
    with torch.inference_mode():
        rois, valid = preprocess_clips_tracked(
            det_params, presence, ert_model,
            torch.as_tensor(padded, device=dev)[None], cfg,
            threshold=threshold, topk=topk)
    return rois[0, :n].cpu().numpy(), valid[0, :n].cpu().numpy()
