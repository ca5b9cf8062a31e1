"""Patchify visual stem (counterpart of ``patchify_apply`` in
``lipreading_tpu/models/frontend3d.py``).

    [B,T,R,R] -> 8x8 space-to-depth     -> [B,T,R/8,R/8,64]
              -> concat (t-1, t, t+1)   -> [B,T,R/8,R/8,192]  (zeros past the ends)
              -> dense 192->P -> GN -> relu -> pool(1,2,2)
              -> conv3d(3,3,3) P->P -> GN -> relu -> pool(1,2,2)
              -> conv3d(3,3,3) P->P -> GN -> relu
              -> flatten -> dense -> highway x N -> dropout -> [B,T,D]

The reference-shaped conv3d stem (``frontend_apply``) is a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from lipreading_tpu_torch.config import ModelConfig
from lipreading_tpu_torch.models.nn import (
    Conv3d,
    Dense,
    GroupNorm,
    Highway,
    dropout,
    maxpool3d,
)


def patchify_apply(p: "Patchify", rois: torch.Tensor, cfg: ModelConfig,
                   dtype: torch.dtype | None = None,
                   gen: torch.Generator | None = None,
                   rate: float = 0.0) -> torch.Tensor:
    """[B, T, R, R] (or [B, T, R, R, 1]) -> [B, T, D]; dropout at ``rate``
    on the output when ``gen`` is given (training)."""
    if rois.ndim == 5:
        rois = rois[..., 0]
    x = rois.to(dtype or torch.float32)
    B, T, R, _ = x.shape
    ps = cfg.patch_size
    g = R // ps
    x = x.reshape(B, T, g, ps, g, ps).permute(0, 1, 2, 4, 3, 5)
    x = x.reshape(B, T, g, g, ps * ps)
    z = torch.zeros_like(x[:, :1])
    x = torch.cat([torch.cat([z, x[:, :-1]], dim=1), x,
                   torch.cat([x[:, 1:], z], dim=1)], dim=-1)
    x = torch.relu(p.gn_e(p.embed(x, dtype)))
    x = maxpool3d(x.reshape(B, T, g, g, -1))
    x = torch.relu(p.gnA(p.convA(x, dtype)))
    x = maxpool3d(x)
    x = torch.relu(p.gnB(p.convB(x, dtype)))
    x = p.proj(x.reshape(B, T, -1), dtype)
    for hw in p.highway:
        x = hw(x, dtype)
    return dropout(x, rate, gen)


class Patchify(nn.Module):
    def __init__(self, cfg: ModelConfig, roi_size: int = 96):
        super().__init__()
        P, ps, fw = cfg.patch_dim, cfg.patch_size, cfg.framewise_norm
        self.cfg = cfg
        self.embed = Dense(3 * ps * ps, P)
        self.gn_e = GroupNorm(P, fw)
        self.convA = Conv3d((3, 3, 3), P, P)
        self.gnA = GroupNorm(P, fw)
        self.convB = Conv3d((3, 3, 3), P, P)
        self.gnB = GroupNorm(P, fw)
        self.proj = Dense(P * (roi_size // ps // 4) ** 2, cfg.frontend_dim)
        self.highway = nn.ModuleList(
            Highway(cfg.frontend_dim) for _ in range(cfg.highway_layers))

    def forward(self, rois, dtype=None, gen=None, rate=0.0):
        return patchify_apply(self, rois, self.cfg, dtype, gen, rate)
