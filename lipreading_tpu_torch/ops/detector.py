"""Batched face detection (counterpart of ``forward_features``,
``decode_boxes`` and ``detect`` in ``lipreading_tpu/ops/detector.py``).

Three 3x3 stride-2 convolutions and a 1x1 head over the 64x64 resized frame,
with the explicit symmetric padding ``k // 2`` of the JAX package, in full
float32: cuDNN's default TF32 convolutions keep about three decimal digits,
which moves the decoded boxes, so ``forward_features`` turns TF32 off for its
own convolutions (``ops.roi.full_float32``) and restores the caller's
setting afterwards.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lipreading_tpu_torch.oracle.detector import INPUT, LAYERS, SIZE_ANCHOR, STRIDE
from lipreading_tpu_torch.ops.roi import full_float32, resize_frames, true_div


def params_to_torch(params: dict[str, np.ndarray],
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """``detector.npz`` arrays -> float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def forward_features(params: dict[str, torch.Tensor], gray64: torch.Tensor):
    """[B, 64, 64] gray (0..255) -> (trunk features [B, 8, 8, 32],
    head [B, 8, 8, 4]), channels last as in the JAX package."""
    x = (true_div(gray64.float(), 255.0) - 0.5) / 0.5
    x = x[:, None]                                       # NCHW
    feats = None
    with full_float32():
        for name, k, _, _, stride in LAYERS:
            w = params[f"{name}/w"].float().permute(3, 2, 0, 1)   # HWIO -> OIHW
            x = F.conv2d(x, w, stride=stride, padding=k // 2)
            x = x + params[f"{name}/b"].float()[:, None, None]
            if name != "head":
                x = torch.relu(x)
                feats = x
    return feats.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1)


def forward(params: dict[str, torch.Tensor], gray64: torch.Tensor) -> torch.Tensor:
    """[B, 64, 64] gray (0..255) -> [B, 8, 8, 4] raw head outputs."""
    return forward_features(params, gray64)[1]


def decode_boxes(head: torch.Tensor, frame_h: int, frame_w: int) -> torch.Tensor:
    """[B, 8, 8, 4] -> [B, 3] float32 square face boxes (x0, y0, size) from
    the highest-scoring cell (first maximum in row-major order)."""
    B, gh, gw, _ = head.shape
    flat = head.reshape(B, gh * gw, 4)
    idx = torch.argmax(flat[..., 0], dim=1)
    cy_cell = torch.div(idx, gw, rounding_mode="floor").float()
    cx_cell = (idx % gw).float()
    sel = flat[torch.arange(B, device=head.device), idx]          # [B, 4]
    dx = torch.sigmoid(sel[:, 1])
    dy = torch.sigmoid(sel[:, 2])
    size64 = torch.exp(sel[:, 3]) * SIZE_ANCHOR
    cx64 = (cx_cell + dx) * STRIDE
    cy64 = (cy_cell + dy) * STRIDE
    sx, sy = frame_w / INPUT, frame_h / INPUT
    cx = cx64 * sx
    cy = cy64 * sy
    size = size64 * (0.5 * (sx + sy))
    return torch.stack([cx - size / 2, cy - size / 2, size], dim=1)


def detect(params: dict[str, torch.Tensor], gray: torch.Tensor) -> torch.Tensor:
    """[B, H, W] full-resolution gray -> [B, 3] face boxes."""
    B, H, W = gray.shape
    return decode_boxes(forward(params, resize_frames(gray, INPUT)), H, W)
