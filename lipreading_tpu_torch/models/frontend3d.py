"""The two visual stems (counterparts of ``patchify_apply`` and
``frontend_apply`` in ``lipreading_tpu/models/frontend3d.py``).

The patchify stem (``frontend="patchify"``):

    [B,T,R,R] -> 8x8 space-to-depth     -> [B,T,R/8,R/8,64]
              -> concat (t-1, t, t+1)   -> [B,T,R/8,R/8,192]  (zeros past the ends)
              -> dense 192->P -> GN -> relu -> pool(1,2,2)
              -> conv3d(3,3,3) P->P -> GN -> relu -> pool(1,2,2)
              -> conv3d(3,3,3) P->P -> GN -> relu
              -> flatten -> dense -> highway x N -> dropout -> [B,T,D]

The conv3d stem (``frontend="conv3d"``, the reference-shaped stack):

    [B,T,96,96,1] -> conv3d(3,5,5) s(1,2,2) C0 -> GN -> relu -> pool(1,2,2)
                  -> conv3d(3,5,5) C1 -> GN -> relu -> pool(1,2,2)
                  -> conv3d(3,3,3) C2 -> GN -> relu -> pool(1,2,2)  (6x6)
                  -> flatten -> dense -> highway x N -> dropout -> [B,T,D]

Every convolution pads as XLA's "SAME" does (``nn.conv3d``): the 5x5
stride-2 one pads 1 before and 2 after. With ``framewise_norm`` off (the
releases of this stem) the GroupNorm statistics pool over time, padded
frames included, so a clip's features depend on how far it was padded.
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


def frontend_apply(p: "Frontend3D", rois: torch.Tensor,
                   dtype: torch.dtype | None = None,
                   gen: torch.Generator | None = None,
                   rate: float = 0.0) -> torch.Tensor:
    """[B, T, R, R] (or [B, T, R, R, 1]) -> [B, T, D]; dropout at ``rate``
    on the output when ``gen`` is given (training)."""
    if rois.ndim == 4:
        rois = rois[..., None]
    x = rois.to(dtype or torch.float32)
    x = maxpool3d(torch.relu(p.gn0(p.conv0(x, dtype, strides=(1, 2, 2)))))
    x = maxpool3d(torch.relu(p.gn1(p.conv1(x, dtype))))
    x = maxpool3d(torch.relu(p.gn2(p.conv2(x, dtype))))
    B, T = x.shape[:2]
    x = p.proj(x.reshape(B, T, -1), dtype)
    for hw in p.highway:
        x = hw(x, dtype)
    return dropout(x, rate, gen)


class Frontend3D(nn.Module):
    def __init__(self, cfg: ModelConfig, roi_size: int = 96):
        super().__init__()
        c0, c1, c2 = cfg.frontend_channels
        fw = cfg.framewise_norm
        self.conv0 = Conv3d((3, 5, 5), 1, c0)
        self.gn0 = GroupNorm(c0, fw)
        self.conv1 = Conv3d((3, 5, 5), c0, c1)
        self.gn1 = GroupNorm(c1, fw)
        self.conv2 = Conv3d((3, 3, 3), c1, c2)
        self.gn2 = GroupNorm(c2, fw)
        # R -> conv stride 2 -> pool -> pool -> pool: 96 -> 48 -> 24 -> 12 -> 6
        s = -(-roi_size // 2) // 8
        self.proj = Dense(c2 * s * s, cfg.frontend_dim)
        self.highway = nn.ModuleList(
            Highway(cfg.frontend_dim) for _ in range(cfg.highway_layers))

    def forward(self, rois, dtype=None, gen=None, rate=0.0):
        return frontend_apply(self, rois, dtype, gen, rate)
