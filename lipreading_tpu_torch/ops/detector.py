"""Batched face detection (counterpart of ``forward_features``,
``presence_logits``, ``decode_boxes_topk``, ``decode_boxes`` and ``detect``
in ``lipreading_tpu/ops/detector.py``).

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

from lipreading_tpu_torch.ops.decode import top_k
from lipreading_tpu_torch.oracle.detector import INPUT, LAYERS, SIZE_ANCHOR, STRIDE
from lipreading_tpu_torch.ops.roi import full_float32, resize_frames, true_div


def params_to_torch(params: dict[str, np.ndarray],
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """``detector.npz`` arrays -> float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: half the gradient at exactly 0, as JAX gives
    it (``torch.relu`` gives none), so that training matches JAX where a
    unit's input is 0, as it is wherever a zero-bias unit sees only dead
    inputs."""
    return torch.maximum(x, x.new_zeros(()))


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
                x = relu(x)
                feats = x
    return feats.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1)


def forward(params: dict[str, torch.Tensor], gray64: torch.Tensor) -> torch.Tensor:
    """[B, 64, 64] gray (0..255) -> [B, 8, 8, 4] raw head outputs."""
    return forward_features(params, gray64)[1]


def presence_logits(presence: dict[str, torch.Tensor],
                    feats: torch.Tensor) -> torch.Tensor:
    """[B, 8, 8, 32] trunk features -> [B, 8, 8] face-presence logits: the
    two-layer head (``presence.npz``) trained with faceless frames on the
    frozen trunk, which the tracked path thresholds. Its products run in
    full float32: TF32 would move the confidences the threshold reads."""
    with full_float32():
        h = relu(feats @ presence["w1"].float() + presence["b1"].float())
        return h @ presence["w2"].float() + presence["b2"].float()


def _decode_cells(sel: torch.Tensor, idx: torch.Tensor, gw: int,
                  frame_h: int, frame_w: int) -> torch.Tensor:
    """Head outputs [..., 4] of the cells ``idx`` [...] (row-major in a grid
    ``gw`` wide) -> [..., 3] square boxes (x0, y0, size) in frame pixels."""
    cy_cell = torch.div(idx, gw, rounding_mode="floor").float()
    cx_cell = (idx % gw).float()
    dx = torch.sigmoid(sel[..., 1])
    dy = torch.sigmoid(sel[..., 2])
    size64 = torch.exp(sel[..., 3]) * SIZE_ANCHOR
    cx64 = (cx_cell + dx) * STRIDE
    cy64 = (cy_cell + dy) * STRIDE
    sx, sy = frame_w / INPUT, frame_h / INPUT
    cx = cx64 * sx
    cy = cy64 * sy
    size = size64 * (0.5 * (sx + sy))
    return torch.stack([cx - size / 2, cy - size / 2, size], dim=-1)


def decode_boxes_topk(head: torch.Tensor, frame_h: int, frame_w: int, k: int,
                      scores: torch.Tensor | None = None):
    """[B, 8, 8, 4] -> (boxes [B, K, 3], score logits [B, K]): the ``k``
    best cells by ``scores`` (default: the head's own score channel; the
    tracked path passes presence logits), in ``lax.top_k``'s order (highest
    first, the lower cell first among ties), each decoded as
    ``decode_boxes`` decodes its cell."""
    B, gh, gw, _ = head.shape
    s = (head[..., 0] if scores is None else scores).reshape(B, gh * gw)
    top_s, idx = top_k(s, k)                                   # [B, K]
    sel = torch.gather(head.reshape(B, gh * gw, 4), 1,
                       idx[..., None].expand(B, k, 4))         # [B, K, 4]
    return _decode_cells(sel, idx, gw, frame_h, frame_w), top_s


def decode_boxes(head: torch.Tensor, frame_h: int, frame_w: int) -> torch.Tensor:
    """[B, 8, 8, 4] -> [B, 3] float32 square face boxes (x0, y0, size) from
    the highest-scoring cell (first maximum in row-major order)."""
    B, gh, gw, _ = head.shape
    flat = head.reshape(B, gh * gw, 4)
    idx = torch.argmax(flat[..., 0], dim=1)
    sel = flat[torch.arange(B, device=head.device), idx]          # [B, 4]
    return _decode_cells(sel, idx, gw, frame_h, frame_w)


def detect(params: dict[str, torch.Tensor], gray: torch.Tensor) -> torch.Tensor:
    """[B, H, W] full-resolution gray -> [B, 3] face boxes."""
    B, H, W = gray.shape
    return decode_boxes(forward(params, resize_frames(gray, INPUT)), H, W)
