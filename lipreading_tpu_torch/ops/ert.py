"""Batched ERT landmark cascade (counterpart of ``predict_batch`` in
``lipreading_tpu/ops/ert.py``, its ``gather="take"`` semantics).

Per stage: gather the pool pixels at positions anchored to the current shape
estimate (nearest pixel by ``floor(x + 0.5)``), compare every split node at
once, descend the heap-ordered trees level by level, and add the chosen
leaves' shape increments. The JAX package's ``gather="matmul"`` form is a
reformulation for the TPU's matrix unit with the same result and is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from lipreading_tpu_torch.oracle.ert import ERTModel

_FIELDS = ("mean_shape", "anchors", "offsets", "feat1", "feat2", "thresh",
           "leaves")


def model_to_torch(model: ERTModel, device: str | torch.device = "cuda"
                   ) -> dict[str, torch.Tensor]:
    """ERTModel arrays -> tensors on ``device`` (indices as int64)."""
    out = {}
    for k in _FIELDS:
        v = np.asarray(getattr(model, k))
        out[k] = torch.as_tensor(
            v.astype(np.int64 if v.dtype.kind == "i" else np.float32),
            device=device)
    return out


def predict_batch(m: dict[str, torch.Tensor], gray: torch.Tensor,
                  boxes: torch.Tensor) -> torch.Tensor:
    """[B, H, W] gray + [B, 3] float boxes (x0, y0, size) -> [B, 68, 2]
    landmarks in pixels."""
    B, H, W = gray.shape
    S = m["anchors"].shape[0]
    K, nn = m["feat1"].shape[1:]
    depth = int(np.log2(nn + 1))
    dev = gray.device

    gray_flat = gray.float().reshape(B, H * W)
    origin = boxes[:, :2].float()[:, None, :]                  # [B, 1, 2]
    size = boxes[:, 2].float()[:, None, None]                  # [B, 1, 1]
    shape = m["mean_shape"].float()[None].expand(B, 68, 2)
    ks = torch.arange(K, device=dev)

    for s in range(S):
        pos = (shape[:, m["anchors"][s]] + m["offsets"][s][None]) * size + origin
        px = torch.floor(pos[..., 0] + 0.5).long().clamp(0, W - 1)
        py = torch.floor(pos[..., 1] + 0.5).long().clamp(0, H - 1)
        vals = torch.gather(gray_flat, 1, py * W + px)         # [B, P]
        v1 = vals[:, m["feat1"][s].reshape(-1)].reshape(B, K, nn)
        v2 = vals[:, m["feat2"][s].reshape(-1)].reshape(B, K, nn)
        right = ((v1 - v2) > m["thresh"][s][None]).long()      # [B, K, Nn]
        node = torch.zeros((B, K), dtype=torch.long, device=dev)
        for _ in range(depth):
            bit = torch.gather(right, 2, node[..., None])[..., 0]
            node = 2 * node + 1 + bit
        leaf = node - nn                                       # [B, K]
        delta = m["leaves"][s][ks[None], leaf].sum(dim=1)      # [B, 136]
        shape = shape + delta.reshape(B, 68, 2)

    return shape * size + origin
