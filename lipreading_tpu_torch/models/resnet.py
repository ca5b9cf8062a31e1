"""The ResNet-18 visual trunk of the Auto-AVSR family
(``frontend="resnet18"``; Ma, Petridis and Pantic 2022, arXiv:2202.13084,
as Auto-AVSR trains it, arXiv:2303.14307). No JAX counterpart.

    [B,T,88,88] -> conv3d(5,7,7) s(1,2,2) pad(2,3,3) 1->64 -> BN -> swish
                -> maxpool(1,3,3) s(1,2,2) pad(0,1,1)    -> [B,T,22,22,64]
                -> ResNet-18 per frame: BasicBlocks [2,2,2,2] of 64, 128,
                   256, 512 channels, strides 1, 2, 2, 2
                -> global average pool                          -> [B,T,512]

A BasicBlock is ``swish(BN(conv3x3(swish(BN(conv3x3_s(x))))) + r)``, r the
input or, where the stride or width changes, ``BN(conv1x1_s(x))``. The
convolutions have no bias and pad as PyTorch pads (the public model's):
symmetrically, so a stride-2 3x3 one pads 1 before and 1 after. The
stride-1 3x3 ones (13) go through ``nn.conv3d`` with kT 1, whose input
gradient in bf16 is the ``conv3d_dgrad`` kernel; the strided ones are
2D convolutions over the frames. BatchNorm (``nn.BatchNorm``) takes its
statistics over every frame of the batch, padded ones included, as the
public model does. Weights are [kT, kH, kW, Cin, Cout] as ``nn.conv3d``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lipreading_tpu_torch.models import nn as lnn
from lipreading_tpu_torch.ops.roi import full_float32

WIDTHS = (64, 128, 256, 512)
STRIDES = (1, 2, 2, 2)


class ConvW(nn.Module):
    """A bias-free convolution's weight [kT, kH, kW, Cin, Cout]."""

    def __init__(self, kernel: tuple[int, int, int], cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(*kernel, cin, cout))


def conv_frames(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """A 2D convolution of every frame: x [B, T, H, W, Cin], w [1, kH, kW,
    Cin, Cout], PyTorch's symmetric ``pad`` -> [B, T, H', W', Cout]."""
    B, T, H, W, C = x.shape
    w = w[0].to(dtype or x.dtype)
    xf = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    with full_float32():
        y = F.conv2d(xf, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).reshape(B, T, *y.shape[2:], y.shape[1])


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = ConvW((1, 3, 3), cin, cout)
        self.bn1 = lnn.BatchNorm(cout)
        self.conv2 = ConvW((1, 3, 3), cout, cout)
        self.bn2 = lnn.BatchNorm(cout)
        if stride != 1 or cin != cout:
            self.down = ConvW((1, 1, 1), cin, cout)
            self.down_bn = lnn.BatchNorm(cout)

    def forward(self, x, dtype=None):
        if self.stride == 1:
            h = lnn.conv3d(x, self.conv1.w, None, dtype=dtype)
        else:
            h = conv_frames(x, self.conv1.w, self.stride, 1, dtype)
        h = F.silu(self.bn1(h))
        h = self.bn2(lnn.conv3d(h, self.conv2.w, None, dtype=dtype))
        r = x
        if hasattr(self, "down"):
            r = self.down_bn(conv_frames(x, self.down.w, self.stride, 0,
                                         dtype))
        return F.silu(h + r)


class ResNet18Trunk(nn.Module):
    """The trunk (the module doc); ``forward(rois [B, T, R, R], dtype, gen,
    rate)`` as the other stems take it (no dropout here) -> [B, T, 512]."""

    out_dim = WIDTHS[-1]

    def __init__(self):
        super().__init__()
        self.conv0 = ConvW((5, 7, 7), 1, WIDTHS[0])
        self.bn0 = lnn.BatchNorm(WIDTHS[0])
        layers, cin = [], WIDTHS[0]
        for cout, s in zip(WIDTHS, STRIDES):
            layers.append(nn.ModuleList([BasicBlock(cin, cout, s),
                                         BasicBlock(cout, cout, 1)]))
            cin = cout
        self.layers = nn.ModuleList(layers)

    def forward(self, rois, dtype=None, gen=None, rate=0.0):
        x = rois.to(dtype or torch.float32)
        B, T = x.shape[:2]
        w = self.conv0.w.to(x.dtype)
        with full_float32():
            x = F.conv3d(x[:, None], w.permute(4, 3, 0, 1, 2),
                         stride=(1, 2, 2), padding=(2, 3, 3))
        x = F.silu(self.bn0(x.permute(0, 2, 3, 4, 1)))
        H, W, C = x.shape[2:]
        x = F.max_pool2d(x.reshape(B * T, H, W, C).permute(0, 3, 1, 2),
                         (3, 3), 2, 1)
        x = x.permute(0, 2, 3, 1).reshape(B, T, *x.shape[2:], C)
        for blocks in self.layers:
            for blk in blocks:
                x = blk(x, dtype)
        return x.float().mean(dim=(2, 3)).to(x.dtype)
