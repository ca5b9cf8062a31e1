"""Temporal face-box tracking (counterpart of ``track_boxes`` and
``compact_valid_frames`` in ``lipreading_tpu/ops/tracking.py``).

Each frame brings the detector's top-K candidate boxes with their presence
confidences. A forward pass over time keeps, among the candidates above the
threshold, the one nearest the previous frame's box (a second face in the
frame never takes the track), and carries the last confident box through
frames without one (flagged invalid). A backward pass fills a leading run
of such frames with the first confident box.

The JAX package runs both passes as ``lax.scan``s. Here they are loops over
T on the device: about 20 small launches a frame and no read of the device
inside the loop. The forward carry is a true recurrence, so the loop stays.
"""

from __future__ import annotations

import torch

from lipreading_tpu_torch import profiling

NEG = -1e30


def _centers(b: torch.Tensor) -> torch.Tensor:
    return torch.stack([b[..., 0] + b[..., 2] / 2,
                        b[..., 1] + b[..., 2] / 2], dim=-1)


def track_boxes(boxes: torch.Tensor, conf: torch.Tensor, threshold: float,
                init_state=None, return_state: bool = False):
    """boxes [B, T, K, 3] candidates and conf [B, T, K] confidences in
    (0, 1) -> (tracked [B, T, 3] float, valid [B, T] bool). ``valid`` marks
    frames with a confident candidate; the others hold the carried (or
    back-filled) box.

    ``init_state`` / ``return_state`` chain the track across chunks (for
    streaming): the state is (have [B] bool, box [B, 3]), the last
    confident box so far. With a live prior state a chunk's leading run of
    invalid frames carries that box instead of being back-filled."""
    B, T, K, _ = boxes.shape
    dev = boxes.device
    if init_state is not None:
        have, box = init_state
        have, box = have.to(dev, torch.bool), box.to(dev, boxes.dtype)
    else:
        have = torch.zeros((B,), dtype=torch.bool, device=dev)
        box = torch.zeros((B, 3), dtype=boxes.dtype, device=dev)
    ar = torch.arange(B, device=dev)
    with profiling.span("wait.h2d"):    # a copy from host memory
        neg = torch.tensor(NEG, dtype=conf.dtype, device=dev)
    out, valid, have_so_far = [], [], []
    for t in range(T):
        b_t, c_t = boxes[:, t], conf[:, t]                      # [B,K,3], [B,K]
        ok = c_t >= threshold
        d = torch.linalg.vector_norm(
            _centers(b_t) - _centers(box)[:, None, :], dim=-1)  # [B, K]
        # with a track: the nearest confident candidate; without: the most
        # confident one
        pick = torch.where(have[:, None], -d, c_t)
        pick = torch.where(ok, pick, neg)
        chosen = b_t[ar, torch.argmax(pick, dim=1)]             # first max
        any_ok = ok.any(dim=1)
        box = torch.where(any_ok[:, None], chosen, box)
        have = have | any_ok
        out.append(box)
        valid.append(any_ok)
        have_so_far.append(have)
    final_state = (have, box)

    # back-fill only the leading frames with no confident candidate at or
    # before them, from the first confident box; later frames already hold
    # the forward-carried box
    filled = [None] * T
    next_box = out[-1]
    for t in range(T - 1, -1, -1):
        filled[t] = torch.where(have_so_far[t][:, None], out[t], next_box)
        next_box = torch.where(valid[t][:, None], out[t], next_box)
    tracked = torch.stack(filled, dim=1)
    valid_bt = torch.stack(valid, dim=1)
    if return_state:
        return tracked, valid_bt, final_state
    return tracked, valid_bt


def compact_valid_frames(x: torch.Tensor, valid: torch.Tensor,
                         lengths: torch.Tensor):
    """Move each sample's valid frames to the front, in order (the skip-frame
    semantics under static shapes): x [B, T, ...], valid [B, T] bool,
    lengths [B] (frames at or past a length are dropped too) -> (x
    compacted, new lengths of ``lengths``' type)."""
    B, T = valid.shape
    pos = torch.arange(T, device=valid.device)[None, :]
    keep = valid & (pos < lengths[:, None])
    # a stable sort on a 0/1 key: kept frames first, in their order
    order = torch.argsort(torch.where(keep, 0, 1), dim=1, stable=True)
    idx = order.reshape(B, T, *([1] * (x.ndim - 2))).expand(x.shape)
    return torch.gather(x, 1, idx), keep.sum(dim=1).to(lengths.dtype)
