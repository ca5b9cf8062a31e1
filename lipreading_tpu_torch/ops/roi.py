"""Grayscale, full-frame resize and mouth-ROI sampling (counterpart of
``lipreading_tpu/ops/roi.py``).

``sample_rois`` is the wrapper of the CUDA ROI sampler
(``csrc/roi_sampler.cu``); ``sample_rois_reference`` is its plain PyTorch
version, the dense ``W_y @ g @ W_x^T`` product in float32 of
``sample_rois_xla``. The wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from lipreading_tpu_torch import kernels

RGB_WEIGHTS = (0.299, 0.587, 0.114)  # Rec.601


@contextlib.contextmanager
def full_float32():
    """Float32 matrix products and cuDNN convolutions in full float32 inside
    the block, whatever the caller allowed (TF32 keeps ~3 decimal digits,
    which moves boxes); the caller's settings come back after it."""
    prev = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a correctly rounded float division on every device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which is off by an ulp for divisors such as 96 or 255; the
    JAX package and the kernels divide."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def grayscale(frames: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB (uint8 or float) -> [..., H, W] float32 luma."""
    f = frames.float()
    r, g, b = RGB_WEIGHTS
    return f[..., 0] * r + f[..., 1] * g + f[..., 2] * b


def _interp_weights_dense(starts, sizes, src_dim: int, out_size: int,
                          subpixel: bool = False) -> torch.Tensor:
    """[N] crop origins and extents along one axis -> [N, out, src_dim]
    bilinear weight matrices with two taps a row (see csrc/roi_sampler.cu
    for the two box modes)."""
    starts = starts.float()[:, None]
    sizes = sizes.float()[:, None]
    js = torch.arange(out_size, dtype=torch.float32, device=starts.device)[None]
    src = (js + 0.5) * true_div(sizes, out_size) - 0.5
    src = torch.minimum(torch.clamp(src, min=0.0), sizes - 1.0)
    if subpixel:
        src = torch.clamp(src + starts, 0.0, float(src_dim - 1))
        i0 = torch.clamp(torch.floor(src), 0.0, float(src_dim - 2))
        frac = src - i0
    else:
        i0 = torch.minimum(torch.floor(src), torch.clamp(sizes - 2.0, min=0.0))
        frac = src - i0
        i0 = torch.clamp(i0 + starts, 0.0, float(src_dim - 2))
    cols = torch.arange(src_dim, dtype=torch.float32, device=starts.device)
    i0e, fe = i0[:, :, None], frac[:, :, None]
    return (torch.where(cols == i0e, 1.0 - fe, 0.0)
            + torch.where(cols == i0e + 1.0, fe, 0.0))


def sample_rois_reference(gray: torch.Tensor, boxes: torch.Tensor,
                          out_size: int = 96, mean: float = 0.421,
                          std: float = 0.165, normalize: bool = True,
                          subpixel: bool = False) -> torch.Tensor:
    """[N, H, W] gray + [N, 3] boxes (x0, y0, size) -> [N, R, R] ROIs, as the
    dense float32 product (plain version of the kernel)."""
    N, H, W = gray.shape
    wy = _interp_weights_dense(boxes[:, 1], boxes[:, 2], H, out_size, subpixel)
    wx = _interp_weights_dense(boxes[:, 0], boxes[:, 2], W, out_size, subpixel)
    with full_float32():
        rows = torch.bmm(wy, gray.float())              # [N, R, W]
        roi = torch.bmm(rows, wx.transpose(1, 2))       # [N, R, R]
    if normalize:
        roi = true_div(true_div(roi, 255.0) - mean, std)
    return roi


def sample_rois(gray: torch.Tensor, boxes: torch.Tensor, out_size: int = 96,
                mean: float = 0.421, std: float = 0.165,
                normalize: bool = True, subpixel: bool = False) -> torch.Tensor:
    """[N, H, W] float32 gray + [N, 3] boxes -> [N, R, R] float32 ROIs.

    Boxes are int32 (x0, y0, size), or float32 with ``subpixel=True``. On a
    CUDA tensor this launches the ROI kernel; on a CPU tensor it runs
    ``sample_rois_reference``."""
    if gray.ndim != 3 or boxes.shape != (gray.shape[0], 3):
        raise ValueError(f"sample_rois: gray {tuple(gray.shape)} and boxes "
                         f"{tuple(boxes.shape)} are not [N, H, W] and [N, 3]")
    want = torch.float32 if subpixel else torch.int32
    if gray.dtype != torch.float32 or boxes.dtype != want:
        raise TypeError(f"sample_rois: need float32 gray and {want} boxes, "
                        f"got {gray.dtype} and {boxes.dtype}")
    if gray.device.type == "cpu" and boxes.device.type == "cpu":
        return sample_rois_reference(gray, boxes, out_size, mean, std,
                                     normalize, subpixel)
    if gray.device.type != "cuda" or boxes.device != gray.device:
        raise ValueError(f"sample_rois: gray on {gray.device}, boxes on "
                         f"{boxes.device}; need both on one CUDA device")
    N, H, W = gray.shape
    if H < 2 or W < 2 or not 1 <= out_size <= 2048:
        raise ValueError(f"sample_rois: frame {H}x{W}, out_size {out_size}")
    gray, boxes = gray.contiguous(), boxes.contiguous()
    out = torch.empty((N, out_size, out_size), dtype=torch.float32,
                      device=gray.device)
    err = kernels.lib().roi_sample(
        gray.data_ptr(), boxes.data_ptr(), out.data_ptr(), N, H, W, out_size,
        mean, std, int(normalize), int(subpixel),
        kernels.stream_ptr(gray.device))
    kernels.check(err, "roi_sample")
    sample_rois.launches += 1
    return out


sample_rois.launches = 0


def _np_interp_weights(src_dim: int, out_size: int) -> np.ndarray:
    """Constant interpolation matrix [out, src] for a full-frame box."""
    js = np.arange(out_size, dtype=np.float32)
    src = (js + 0.5) * (src_dim / out_size) - 0.5
    src = np.clip(src, 0.0, src_dim - 1.0)
    i0 = np.minimum(np.floor(src), src_dim - 2).astype(np.int32)
    frac = (src - i0).astype(np.float32)
    w = np.zeros((out_size, src_dim), dtype=np.float32)
    w[np.arange(out_size), i0] = 1.0 - frac
    w[np.arange(out_size), i0 + 1] += frac
    return w


def resize_frames(gray: torch.Tensor, out_size: int) -> torch.Tensor:
    """[N, H, W] -> [N, out, out] full-frame bilinear resize (detector
    input), as two float32 products with constant weights."""
    N, H, W = gray.shape
    wy = torch.from_numpy(_np_interp_weights(H, out_size)).to(gray.device)
    wx = torch.from_numpy(_np_interp_weights(W, out_size)).to(gray.device)
    with full_float32():
        rows = torch.matmul(wy, gray.float())           # [N, out, W]
        return torch.matmul(rows, wx.t())               # [N, out, out]
