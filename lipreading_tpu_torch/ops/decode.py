"""Decoding on the device: CTC greedy collapse and the attention decoder's
greedy and beam searches (counterpart of ``lipreading_tpu/ops/decode.py``
and of the Pallas kernel ``ctc_greedy_ids_pallas`` in
``lipreading_tpu/ops/decode_pallas.py``).

``ctc_greedy_ids`` is the wrapper of the CUDA kernel
(``csrc/ctc_greedy.cu``); ``ctc_greedy_ids_reference`` is its plain PyTorch
version. The wrapper takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. ``greedy_plan`` is the
kernel's launch, which the wrapper hands to the C entry.

``greedy_decode`` and ``beam_search`` step a model-agnostic ``step_fn``
under ``early_exit_scan``, a Python loop that stops once every row has
finished (one host read a step). The beam folds its W beams into the batch
([B*W] states) and ranks candidates with ``top_k``, which orders them as
``lax.top_k`` does: ties are common (a dead beam's -1e30 absorbs any score
added to it), and the order of tied candidates decides which beams survive.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lipreading_tpu_torch import kernels, profiling

NEG_INF = -1e30

# the greedy kernel's launch: the most threads a block (one a frame), and
# the dynamic shared memory a block may use, in floats (the H100's 227 KB
# less 1 KB for the kernel's static arrays)
GREEDY_MAX_THREADS = 1024
GREEDY_SMEM_FLOATS = (232448 - 1024) // 4


class GreedyPlan(NamedTuple):
    sV: int          # row stride of the staged logits, in floats
    chunk: int       # frames a chunk (one thread a frame)
    nbuf: int        # staged buffers: 1, 2 (double-buffered), 0 (a warp a
                     # frame from device memory)
    buf_floats: int  # floats a buffer
    threads: int     # a block (one block an utterance)
    smem: int        # bytes of dynamic shared memory a block


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


def greedy_plan(T: int, V: int) -> GreedyPlan:
    """The greedy kernel's launch for utterances of T frames over V labels,
    as ``ctc_greedy_ids`` hands it to the C entry: a row stride of V floats (odd V) or V + 1 (even V: no bank conflicts);
    one chunk of T frames if their rows fit in shared memory, else
    double-buffered chunks of as many frames (a multiple of 32) as two
    buffers hold, else a warp a frame in chunks of up to 1024 frames. The
    chunks start at 0, chunk, 2 chunk, ..."""
    sV = V if V & 1 else V + 1
    one = min(GREEDY_MAX_THREADS, (GREEDY_SMEM_FLOATS - 8) // sV)
    two = min(GREEDY_MAX_THREADS, ((GREEDY_SMEM_FLOATS // 2 - 8) // sV) & ~31)
    if T <= one:
        chunk, nbuf = max(T, 1), 1
    elif two >= 32:
        chunk, nbuf = two, 2
    else:
        chunk, nbuf = min(GREEDY_MAX_THREADS, T), 0
    buf = (chunk * sV + 4 + 3) & ~3 if nbuf else 0
    threads = -(-chunk // 32) * 32
    return GreedyPlan(sV, chunk, nbuf, buf, threads,
                      (nbuf * buf if nbuf else threads) * 4)


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
    p = greedy_plan(T, V)
    err = kernels.lib().ctc_greedy(
        logits.data_ptr(), lengths.data_ptr(), ids.data_ptr(),
        counts.data_ptr(), B, T, V, blank, p.sV, p.chunk, p.nbuf,
        p.buf_floats, p.threads, p.smem, kernels.stream_ptr(logits.device))
    kernels.check(err, "ctc_greedy")
    ctc_greedy_ids.launches += 1
    return ids, counts


ctc_greedy_ids.launches = 0


def tree_map(fn, tree):
    """``fn`` over every tensor of a nest of dicts, lists and tuples; other
    leaves (a cache's int position) pass through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_device(tree) -> torch.device:
    """The device of the first tensor in ``tree``."""
    found: list[torch.Tensor] = []
    tree_map(found.append, tree)
    if not found:
        raise ValueError("tree_device: no tensor in the tree")
    return found[0].device


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of each row of ``x`` [..., N] -> (values,
    indices int64), in ``lax.top_k``'s order: highest first, the lower index
    first among equal values. ``torch.topk`` promises no order for ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def early_exit_scan(body, carry, finished_of, bufs, max_len: int):
    """Run ``body(carry) -> (carry, ys)`` up to ``max_len`` times, stopping
    once ``finished_of(carry)`` is all true; step t writes ys into row t of
    each of ``bufs`` ([max_len, ...], written in place).

    The caller prefills ``bufs`` with exactly what the skipped steps would
    have written (the beams: eos tokens and identity back-pointers; greedy:
    eos). Each step reads ``finished`` on the host: one device sync a step.
    ``early_exit_scan.steps`` counts the steps taken over all calls.
    Traced (``profiling``): the spans ``wait.beam`` (each read of
    ``finished``) and ``beam.step`` (each step's launches), and the
    counter ``beam.steps``. Returns (carry, bufs)."""
    t = 0
    while t < max_len:
        with profiling.span("wait.beam"):
            done = bool(finished_of(carry).all())
        if done:
            break
        with profiling.span("beam.step"):
            carry, ys = body(carry)
            for b, y in zip(bufs, ys):
                b[t] = y
        t += 1
    early_exit_scan.steps += t
    profiling.count("beam.steps", t)
    return carry, bufs


early_exit_scan.steps = 0


def greedy_decode(step_fn, state, batch: int, max_len: int, sos: int,
                  eos: int):
    """Autoregressive argmax decode -> (ids [B, max_len] int32, lengths [B]
    int32) on the device of ``state``; positions at and after a row's eos
    hold eos."""
    device = tree_device(state)

    def body(carry):
        state, tok, finished, length = carry
        state, logp = step_fn(state, tok)
        nxt = torch.argmax(logp, dim=-1).to(torch.int32)
        nxt = torch.where(finished, eos, nxt)
        finished2 = finished | (nxt == eos)
        length = length + (~finished).to(torch.int32)
        return (state, nxt, finished2, length), (nxt,)

    tok0 = torch.full((batch,), sos, dtype=torch.int32, device=device)
    fin0 = torch.zeros((batch,), dtype=torch.bool, device=device)
    len0 = torch.zeros((batch,), dtype=torch.int32, device=device)
    toks0 = torch.full((max_len, batch), eos, dtype=torch.int32, device=device)
    (_, _, _, lengths), (toks,) = early_exit_scan(
        body, (state, tok0, fin0, len0), lambda c: c[2], (toks0,), max_len)
    ids = toks.T                                            # [B, max_len]
    pos = torch.arange(max_len, device=device)[None, :]
    return torch.where(pos < lengths[:, None], ids, eos), lengths


def beam_rows(src_beam: torch.Tensor) -> torch.Tensor:
    """[B, W] source beams -> [B*W] rows of the beam-folded batch: row
    (b, w) of the next step comes from row (b, src_beam[b, w])."""
    batch, beam = src_beam.shape
    first = beam * torch.arange(batch, device=src_beam.device)[:, None]
    return (src_beam + first).reshape(batch * beam)


def backtrack_best(toks: torch.Tensor, srcs: torch.Tensor,
                   scores: torch.Tensor, lengths: torch.Tensor, eos: int,
                   length_penalty: float,
                   finished: torch.Tensor | None = None):
    """The beams' shared tail: follow the back-pointers ``srcs`` [L, B, W]
    from the final beams to step 0, pick each sample's best beam by its
    length-normalised score (among the finished beams when ``finished`` is
    given and any has finished) -> (ids [B, L], lengths [B]).
    ``backtrack_best.last_scores`` keeps the last call's selection scores
    [B, W], so a caller can read how far the best beam led the next."""
    L, batch, beam = toks.shape
    beam_idx = torch.arange(beam, device=toks.device)[None].expand(batch, beam)
    seq = torch.empty((batch, beam, L), dtype=toks.dtype, device=toks.device)
    for t in range(L - 1, -1, -1):
        seq[:, :, t] = torch.gather(toks[t], 1, beam_idx)
        beam_idx = torch.gather(srcs[t], 1, beam_idx)
    norm = ((lengths.float() + 5.0) / 6.0) ** length_penalty
    sel = scores / torch.clamp(norm, min=1e-6)
    if finished is not None:
        # an unfinished beam carries psi(prefix), the mass of all its
        # completions, which dominates any finished beam's full-sequence
        # score: pick among the finished ones where there are any
        masked = torch.where(finished, sel, NEG_INF)
        sel = torch.where(finished.any(dim=1, keepdim=True), masked, sel)
    backtrack_best.last_scores = sel
    best = torch.argmax(sel, dim=1)                         # [B]
    ids = torch.gather(seq, 1, best[:, None, None].expand(batch, 1, L))[:, 0]
    best_len = torch.gather(lengths, 1, best[:, None])[:, 0]
    pos = torch.arange(L, device=toks.device)[None, :]
    return torch.where(pos < best_len[:, None], ids, eos), best_len


backtrack_best.last_scores = None


def beam_init(batch: int, beam: int, max_len: int, sos: int, eos: int,
              device):
    """The beams' first carry and early-exit buffers: scores (0 for beam 0,
    -1e30 for the rest), sos tokens, nothing finished, zero lengths; eos
    tokens and identity back-pointers for the steps the early exit skips."""
    scores = torch.full((batch, beam), NEG_INF, device=device)
    scores[:, 0] = 0.0
    toks = torch.full((batch, beam), sos, dtype=torch.int32, device=device)
    fin = torch.zeros((batch, beam), dtype=torch.bool, device=device)
    lens = torch.zeros((batch, beam), dtype=torch.int32, device=device)
    toks_buf = torch.full((max_len, batch, beam), eos, dtype=torch.int32,
                          device=device)
    srcs_buf = torch.arange(beam, dtype=torch.int64, device=device)[
        None, None].expand(max_len, batch, beam).contiguous()
    return (scores, toks, fin, lens), (toks_buf, srcs_buf)


def beam_search(step_fn, init_state, batch: int, beam: int, max_len: int,
                sos: int, eos: int, length_penalty: float = 0.6):
    """Batched beam search. ``init_state``'s tensors must already be tiled
    to leading dim B*W (``tile_for_beams``). Returns (ids [B, max_len],
    lengths [B]) of the best beam per sample by length-normalised score.

    step_fn: (state[B*W...], tokens [B*W]) -> (state', logits [B*W, V])."""
    BW = batch * beam
    device = tree_device(init_state)

    def body(carry):
        state, scores, toks, finished, lengths = carry
        state, logp = step_fn(state, toks.reshape(BW))
        V = logp.shape[-1]
        logp = torch.log_softmax(logp.float(), dim=-1).reshape(batch, beam, V)
        # finished beams may only emit eos, at no cost
        eos_only = torch.full((V,), NEG_INF, device=logp.device)
        eos_only[eos] = 0.0
        logp = torch.where(finished[:, :, None], eos_only, logp)
        total = scores[:, :, None] + logp                   # [B, W, V]
        new_scores, idx = top_k(total.reshape(batch, beam * V), beam)
        src_beam = idx // V
        new_tok = (idx % V).to(torch.int32)
        rows = beam_rows(src_beam)
        state = tree_map(lambda x: x[rows], state)
        finished = torch.gather(finished, 1, src_beam)
        lengths = torch.gather(lengths, 1, src_beam)
        lengths = lengths + (~finished).to(torch.int32)
        finished = finished | (new_tok == eos)
        return (state, new_scores, new_tok, finished, lengths), (new_tok,
                                                                 src_beam)

    (scores0, toks0, fin0, len0), bufs = beam_init(batch, beam, max_len, sos,
                                                   eos, device)
    (_, scores, _, _, lengths), (toks, srcs) = early_exit_scan(
        body, (init_state, scores0, toks0, fin0, len0), lambda c: c[3],
        bufs, max_len)
    return backtrack_best(toks, srcs, scores, lengths, eos, length_penalty)


def tile_for_beams(tree, beam: int):
    """Repeat each tensor's batch dim W times: [B, ...] -> [B*W, ...]."""
    return tree_map(lambda x: torch.repeat_interleave(x, beam, dim=0), tree)
