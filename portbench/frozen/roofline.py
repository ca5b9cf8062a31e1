"""The least time a kernel launch could take on the card: the larger of
its bytes over the memory rate and its float32 operations over the float32
peak (``frozen/flops.card_peaks``). Byte and operation counts are the
work a launch's inputs need, each input byte read once and each output
byte written once; frozen copies of the models of the program's
``chip_smoke.py`` (``roi_bytes_needed``, the greedy row of ``[greedy]``
and ``ctc_work``), with ``_interp_weights_dense`` of ``ops/roi.py``."""

from __future__ import annotations

import numpy as np
import torch


def bound_s(nbytes: float, ops: float, peaks: dict) -> float:
    return max(nbytes / peaks["bytes"], ops / peaks["float32"])


def _interp_weights_dense(starts, sizes, src_dim: int, out_size: int,
                          subpixel: bool = False) -> torch.Tensor:
    starts = starts.float()[:, None]
    sizes = sizes.float()[:, None]
    js = torch.arange(out_size, dtype=torch.float32, device=starts.device)[None]
    src = (js + 0.5) * (sizes / torch.tensor(float(out_size),
                                             device=starts.device)) - 0.5
    src = torch.minimum(torch.maximum(src, torch.zeros_like(src)), sizes - 1.0)
    if subpixel:
        src = (src + starts).clamp(0.0, float(src_dim - 1))
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


def roi_bytes_needed(boxes, subpixel: bool, H: int, W: int, R: int,
                     block: int = 1024) -> int:
    """Bytes of gray that the ROIs depend on: each frame's distinct tap rows
    times distinct tap columns, 4 bytes each (plus the boxes)."""
    total = 0
    for i in range(0, boxes.shape[0], block):
        b = boxes[i:i + block]
        wy = _interp_weights_dense(b[:, 1], b[:, 2], H, R, subpixel)
        wx = _interp_weights_dense(b[:, 0], b[:, 2], W, R, subpixel)
        rows = (wy != 0).any(dim=1).sum(dim=1)
        cols = (wx != 0).any(dim=1).sum(dim=1)
        total += int(torch.sum(rows * cols).item())
    return total * 4 + boxes.numel() * 4


def roi_launch(boxes, subpixel: bool, H: int, W: int, R: int):
    """(bytes, operations) of one ROI kernel launch: the gray it reads, the
    ROIs it writes, 10 operations an output pixel."""
    N = boxes.shape[0]
    return (roi_bytes_needed(boxes, subpixel, H, W, R) + N * R * R * 4,
            10.0 * N * R * R)


def greedy_launch(B: int, T: int, V: int, lengths) -> tuple[float, float]:
    """(bytes, operations) of one CTC-greedy launch: the valid frames'
    float32 log-probabilities read, lengths read, ids and counts written,
    one comparison a valid log-probability."""
    valid = int(np.clip(np.asarray(lengths), 0, T).sum())
    return valid * V * 4 + B * 4 + B * T * 4 + B * 4, float(valid * V)


def ctc_work(frame_lengths, labels, label_lengths, T: int) -> dict:
    """{"fwd", "bwd"}: (bytes, operations) of the lattice kernels on a
    batch: rows t < input length of lp_ext (and of alpha, for the backward)
    are read, every row of alpha and of the gradient is written; one
    logaddexp is 6 operations."""
    labels = np.asarray(labels)
    B, L = labels.shape
    S = 2 * L + 1
    ext = np.zeros((B, S), np.int64)
    ext[:, 1::2] = labels
    prev2 = np.pad(ext, ((0, 0), (2, 0)))[:, :S]
    skip = (ext != 0) & (ext != prev2)
    n = np.clip(np.asarray(frame_lengths, np.int64), 0, T)
    rows_f = int(np.clip(n, 1, None).sum())
    rows_b = int(n.sum())
    steps = int(np.clip(n - 1, 0, None).sum())
    skip_steps = int((np.clip(n - 1, 0, None) * skip.sum(1)).sum())
    small = B * S + 2 * B * 4
    return {
        "fwd": (rows_f * S * 4 + small + B * T * S * 4 + B * 4,
                steps * S * 7 + skip_steps * 6),
        "bwd": (steps * S * 4 + rows_b * S * 4 + small + 2 * B * 4
                + B * T * S * 4, rows_b * S * (3 + 12 + 5)),
    }
