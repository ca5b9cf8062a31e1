"""CTC greedy collapse (counterpart of ``ctc_greedy_ids`` in
``lipreading_tpu/ops/decode.py`` and of the Pallas kernel
``ctc_greedy_ids_pallas`` in ``lipreading_tpu/ops/decode_pallas.py``).

``ctc_greedy_ids`` is the wrapper of the CUDA kernel
(``csrc/ctc_greedy.cu``); ``ctc_greedy_ids_reference`` is its plain PyTorch
version. The wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from lipreading_tpu_torch import kernels


def ctc_greedy_ids_reference(logits: torch.Tensor, lengths: torch.Tensor,
                             blank: int = 0):
    """[B, T, V] logits + [B] lengths -> (ids [B, T] int32, counts [B] int32).

    ``ids[b, :counts[b]]`` is the collapsed label sequence (first-maximum
    argmax, repeats and blanks dropped, frames at or past the length
    ignored), padded with blank."""
    B, T, V = logits.shape
    raw = torch.argmax(logits, dim=-1)                          # [B, T]
    t = torch.arange(T, device=logits.device)[None, :]
    valid = t < lengths.to(logits.device)[:, None]
    prev = torch.cat([torch.full_like(raw[:, :1], blank), raw[:, :-1]], dim=1)
    keep = (raw != blank) & (raw != prev) & valid
    # stable compaction: kept frames first, in time order
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    ids = torch.gather(raw, 1, order)
    counts = keep.sum(dim=1)
    ids = torch.where(t < counts[:, None], ids, blank)
    return ids.to(torch.int32), counts.to(torch.int32)


def ctc_greedy_ids(logits: torch.Tensor, lengths: torch.Tensor,
                   blank: int = 0):
    """[B, T, V] float32 logits + [B] int32 lengths -> (ids [B, T] int32,
    counts [B] int32).

    On CUDA tensors this launches the greedy kernel; on CPU tensors it runs
    ``ctc_greedy_ids_reference``."""
    if logits.ndim != 3 or lengths.shape != (logits.shape[0],):
        raise ValueError(f"ctc_greedy_ids: logits {tuple(logits.shape)} and "
                         f"lengths {tuple(lengths.shape)} are not [B, T, V] "
                         "and [B]")
    if logits.dtype != torch.float32 or lengths.dtype != torch.int32:
        raise TypeError(f"ctc_greedy_ids: need float32 logits and int32 "
                        f"lengths, got {logits.dtype} and {lengths.dtype}")
    if logits.device.type == "cpu" and lengths.device.type == "cpu":
        return ctc_greedy_ids_reference(logits, lengths, blank)
    if logits.device.type != "cuda" or lengths.device != logits.device:
        raise ValueError(f"ctc_greedy_ids: logits on {logits.device}, lengths "
                         f"on {lengths.device}; need both on one CUDA device")
    B, T, V = logits.shape
    if V < 1 or not 0 <= blank < V:
        raise ValueError(f"ctc_greedy_ids: V={V}, blank={blank}")
    logits, lengths = logits.contiguous(), lengths.contiguous()
    ids = torch.empty((B, T), dtype=torch.int32, device=logits.device)
    counts = torch.empty((B,), dtype=torch.int32, device=logits.device)
    err = kernels.lib().ctc_greedy(
        logits.data_ptr(), lengths.data_ptr(), ids.data_ptr(),
        counts.data_ptr(), B, T, V, blank, kernels.stream_ptr(logits.device))
    kernels.check(err, "ctc_greedy")
    ctc_greedy_ids.launches += 1
    return ids, counts


ctc_greedy_ids.launches = 0
