"""CTC loss (counterpart of ``lipreading_tpu/ops/ctc.py`` and of the Pallas
lattice kernels in ``lipreading_tpu/ops/ctc_pallas.py``).

* ``ctc_loss``: the plain version, the alpha recursion written as a loop over
  T on [B, S] tensors (``ctc_lattice_fwd_reference``, the JAX package's
  ``lax.scan`` twin); autograd differentiates it. ``ctc_loss_mean``
  normalises it by label length.
* ``ctc_loss_lattice``: ``ctc_loss_pallas``'s counterpart. log_softmax, the
  extended labels, the skip flags and the gather into ``lp_ext`` stay in
  PyTorch autograd (``torch.gather``'s backward scatter-adds repeated label
  ids); the lattice recursions are ``CTCLattice``, an autograd function whose
  forward is ``ctc_lattice_fwd`` (kernel ``csrc/ctc_lattice.cu``, alpha
  recursion) and whose backward is ``ctc_lattice_bwd`` (beta recursion and
  state posteriors). Each wrapper runs its plain version
  (``*_reference``) only for tensors on the CPU; on CUDA tensors it
  launches its kernel or raises. ``lattice_plan`` maps the S states onto
  the kernels' warps and lanes.
* ``ctc_loss_best``: the lattice kernels for CUDA tensors, the plain
  ``ctc_loss`` for CPU tensors.

* ``ctc_viterbi_align``: max-product forced alignment through the CTC
  lattice (the streaming transcriber's beam commits). Plain PyTorch, as the
  JAX package leaves it to ``lax.scan``: a loop over T keeps the
  backpointers, a reverse loop reads the states back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lipreading_tpu_torch import kernels

NEG_INF = -1e30


def extend_labels(labels: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """[B, L] labels -> [B, 2L+1] blank-interleaved extended sequence."""
    B, L = labels.shape
    ext = torch.full((B, 2 * L + 1), blank, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _lattice_inputs(logits, labels, blank):
    """log_softmax, extended labels and skip flags, and the emission scores
    gathered onto the lattice -> (lp_ext [B, T, S] f32, skip [B, S] bool)."""
    S = 2 * labels.shape[1] + 1
    logp = torch.log_softmax(logits.float(), dim=-1)
    ext = extend_labels(labels.long(), blank)                       # [B, S]
    ext_prev2 = F.pad(ext, (2, 0), value=blank)[:, :S]
    skip = (ext != blank) & (ext != ext_prev2)
    idx = ext[:, None, :].expand(-1, logits.shape[1], -1)
    return torch.gather(logp, 2, idx), skip


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S] -> out[:, s] = x[:, s - n], NEG_INF for s < n."""
    return F.pad(x, (n, 0), value=NEG_INF)[:, :x.shape[1]]


def _final_ll(alpha_T: torch.Tensor, label_lengths: torch.Tensor):
    """log-likelihood from the last alpha row: logaddexp of the states
    2L and 2L-1 (the latter only when L > 0)."""
    S = alpha_T.shape[1]
    lab = label_lengths.long()
    last = torch.clamp(2 * lab, 0, S - 1)
    prev = torch.clamp(last - 1, 0, S - 1)
    a_last = torch.gather(alpha_T, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha_T, 1, prev[:, None])[:, 0]
    a_prev = torch.where(lab > 0, a_prev, NEG_INF)
    return torch.logaddexp(a_last, a_prev)


def _skip_ok(ext: torch.Tensor, blank: int) -> torch.Tensor:
    """[B, S] extended labels -> where the two-state skip is allowed: onto a
    label that differs from the label before it (never between repeats)."""
    ext_prev2 = F.pad(ext, (2, 0), value=blank)[:, :ext.shape[1]]
    return (ext != blank) & (ext != ext_prev2)


def ctc_viterbi_align(logp: torch.Tensor, labels: torch.Tensor,
                      input_lengths: torch.Tensor,
                      label_lengths: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """Viterbi (max-product) forced alignment of ``labels`` through the CTC
    lattice (counterpart of ``lipreading_tpu/ops/ctc.py``'s).

    logp [B, T, V] log-posteriors; labels [B, L] bare ids; input_lengths
    and label_lengths [B]. Returns [B, T] int32 per-frame emitted ids: the
    aligned label or blank; frames at or past ``input_length`` emit blank.
    Ties go as in the JAX package: staying beats the one-state move, which
    beats the skip, and at the end the last state beats the one before
    it. States past ``2 * label_length`` stay dead; an infeasible length
    saturates to the closest feasible prefix."""
    B, T, V = logp.shape
    S = 2 * labels.shape[1] + 1
    dev = logp.device
    logp = logp.float()
    ext = extend_labels(labels.long(), blank)                       # [B, S]
    skip_ok = _skip_ok(ext, blank)
    lp_ext = torch.gather(logp, 2, ext[:, None, :].expand(B, T, S))
    lp_ext = lp_ext.transpose(0, 1)                                  # [T, B, S]
    in_len = input_lengths.to(dev).long()
    lab_len = label_lengths.to(dev).long()

    usable = torch.arange(S, device=dev)[None, :] <= 2 * lab_len[:, None]
    dead = torch.where(usable, 0.0, NEG_INF)
    alpha = torch.full((B, S), NEG_INF, device=dev)
    alpha[:, 0] = lp_ext[0, :, 0]
    if S > 1:
        alpha[:, 1] = lp_ext[0, :, 1]
    alpha = alpha + dead

    neg = torch.tensor(NEG_INF, device=dev)
    choices = torch.zeros((max(T - 1, 0), B, S), dtype=torch.long,
                          device=dev)
    for t in range(1, T):
        a1 = _shift(alpha, 1)
        a2 = torch.where(skip_ok, _shift(alpha, 2), neg)
        better = a1 > alpha
        best = torch.where(better, a1, alpha)
        choice = better.long()
        better = a2 > best
        best = torch.where(better, a2, best)
        choice = torch.where(better, 2, choice)
        active = (t < in_len)[:, None]
        alpha = torch.where(active, best + lp_ext[t] + dead, alpha)
        choices[t - 1] = torch.where(active, choice, 0)

    last = torch.clamp(2 * lab_len, 0, S - 1)
    prev = torch.clamp(last - 1, 0, S - 1)
    a_last = torch.gather(alpha, 1, last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, prev[:, None])[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, neg)
    s = torch.where(a_last >= a_prev, last, prev)                   # [B]
    states = [None] * T
    for t in range(T - 1, 0, -1):
        states[t] = s
        c = torch.gather(choices[t - 1], 1, s[:, None])[:, 0]
        s = torch.where(t < in_len, s - c, s)
    states[0] = s
    emit = torch.gather(ext, 1, torch.stack(states, dim=1))         # [B, T]
    valid = torch.arange(T, device=dev)[None, :] < in_len[:, None]
    return torch.where(valid, emit, blank).int()


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-sample negative log-likelihood [B] (plain version: the forward
    kernel's plain version, differentiated by autograd).

    logits [B, T, V] unnormalised; labels [B, L] (no blanks, anything past
    label_lengths); input_lengths, label_lengths [B]."""
    lp_ext, skip = _lattice_inputs(logits, labels, blank)
    dev = lp_ext.device
    return ctc_lattice_fwd_reference(lp_ext, skip, input_lengths.to(dev),
                                     label_lengths.to(dev))[0]


def ctc_loss_mean(logits, labels, input_lengths, label_lengths,
                  blank: int = 0) -> torch.Tensor:
    """Mean over the batch of the NLL divided by the label length
    (``torch.nn.CTCLoss(reduction="mean")`` semantics)."""
    nll = ctc_loss(logits, labels, input_lengths, label_lengths, blank)
    denom = torch.clamp(label_lengths.to(nll.device).float(), min=1.0)
    return torch.mean(nll / denom)


# --- the lattice kernels and their plain versions ---------------------------

# the states a lane owns (K) that the kernels are built for, the most warps
# a sample takes (one block of 1024 threads), and so the most states a plan
# covers (L = 3071 labels)
LATTICE_K = (2, 4, 6)
LATTICE_MAX_WARPS = 32
LATTICE_MAX_S = 32 * LATTICE_MAX_WARPS * max(LATTICE_K)


def lattice_plan(S: int) -> tuple[int, int]:
    """(W, K) for S lattice states: W warps a sample, lane j of warp w owns
    the K states (32 w + j) K + k. K is even (a lane's even k are blank
    states, which take one lse): 2 while 32 warps cover S (up to 2048
    states), then 4, then 6; W is as few warps as cover S. chip_smoke.py's
    ``[ctc]`` times every K at S 81 and 513 (PERF.md section 6). Raises
    ValueError above ``LATTICE_MAX_S``."""
    if S < 1:
        raise ValueError(f"lattice_plan: S must be at least 1, got {S}")
    if S > LATTICE_MAX_S:
        raise ValueError(
            f"lattice_plan: S = {S} states is above the CTC lattice kernels' "
            f"limit of {LATTICE_MAX_S} (label length "
            f"{(LATTICE_MAX_S - 1) // 2}): {LATTICE_MAX_WARPS} warps of "
            f"{max(LATTICE_K)} states a lane")
    K = next(k for k in LATTICE_K if 32 * LATTICE_MAX_WARPS * k >= S)
    return -(-S // (32 * K)), K


def _skip_bytes(skip: torch.Tensor) -> torch.Tensor:
    """The kernels' uint8 skip flags: the bool flags' own bytes (a view: no
    copy, no launch)."""
    return skip.contiguous().view(torch.uint8)


def ctc_lattice_fwd_reference(lp_ext, skip, input_lengths, label_lengths):
    """Plain version of the forward kernel: -> (nll [B], alpha [B, T, S])."""
    B, T, S = lp_ext.shape
    idx = torch.arange(S, device=lp_ext.device)
    lab = label_lengths.long()
    first = torch.clamp(2 * lab, max=1)
    a = torch.where(idx[None] <= first[:, None], lp_ext[:, 0], NEG_INF)
    rows = [a]
    for t in range(1, T):
        m = torch.logaddexp(a, _shift(a, 1))
        m = torch.where(skip, torch.logaddexp(m, _shift(a, 2)), m)
        a = torch.where((t < input_lengths)[:, None], m + lp_ext[:, t], a)
        rows.append(a)
    return -_final_ll(a, lab), torch.stack(rows, dim=1)


def ctc_lattice_bwd_reference(lp_ext, skip, input_lengths, label_lengths,
                              alpha, nll, g):
    """Plain version of the backward kernel: d(sum g * nll) / d lp_ext.

    Input lengths are clamped to [0, T], as the kernel and the JAX package's
    scan loss take them: for a length above T the last frame is terminal."""
    B, T, S = lp_ext.shape
    idx = torch.arange(S, device=lp_ext.device)[None]
    lab = label_lengths.long()[:, None]
    inlen = torch.clamp(input_lengths.long(), 0, T)[:, None]
    last = torch.clamp(2 * lab, max=S - 1)
    terminal = torch.where((idx == last) | ((idx == last - 1) & (lab > 0)),
                           0.0, NEG_INF)
    skip2 = F.pad(skip, (0, 2), value=False)[:, 2:]          # skip[s + 2]
    neg = torch.full((B, S), NEG_INF, dtype=torch.float32,
                     device=lp_ext.device)

    def left(x, n):                                          # x[:, s + n]
        return F.pad(x, (0, n), value=NEG_INF)[:, n:]

    grads = [None] * T
    beta_next = neg
    for t in range(T - 1, -1, -1):
        bn = beta_next + lp_ext[:, min(t + 1, T - 1)]
        b2 = torch.where(skip2, left(bn, 2), NEG_INF)
        rec = torch.logaddexp(bn, torch.logaddexp(left(bn, 1), b2))
        beta = torch.where(t == inlen - 1, terminal,
                           torch.where(t >= inlen, neg, rec))
        gamma = torch.exp(alpha[:, t] + beta + nll[:, None])
        grads[t] = torch.where(t < inlen, -gamma * g[:, None], 0.0)
        beta_next = beta
    return torch.stack(grads, dim=1)


def _check_lattice(name, lp_ext, skip, input_lengths, label_lengths):
    if lp_ext.ndim != 3 or skip.shape != (lp_ext.shape[0], lp_ext.shape[2]):
        raise ValueError(f"{name}: lp_ext {tuple(lp_ext.shape)} and skip "
                         f"{tuple(skip.shape)} are not [B, T, S] and [B, S]")
    B = lp_ext.shape[0]
    if input_lengths.shape != (B,) or label_lengths.shape != (B,):
        raise ValueError(f"{name}: lengths must be [B] = [{B}]")
    if lp_ext.dtype != torch.float32 or skip.dtype != torch.bool:
        raise TypeError(f"{name}: need float32 lp_ext and bool skip, got "
                        f"{lp_ext.dtype} and {skip.dtype}")
    if (input_lengths.dtype != torch.int32
            or label_lengths.dtype != torch.int32):
        raise TypeError(f"{name}: need int32 lengths")
    tensors = (lp_ext, skip, input_lengths, label_lengths)
    if all(x.device.type == "cpu" for x in tensors):
        return False
    if lp_ext.device.type != "cuda" or any(x.device != lp_ext.device
                                           for x in tensors):
        raise ValueError(f"{name}: inputs on {[str(x.device) for x in tensors]}"
                         "; need all on the CPU or all on one CUDA device")
    return True


def ctc_lattice_fwd(lp_ext: torch.Tensor, skip: torch.Tensor,
                    input_lengths: torch.Tensor, label_lengths: torch.Tensor):
    """lp_ext [B, T, S] float32, skip [B, S] bool, int32 lengths [B] ->
    (nll [B], alpha [B, T, S]), both float32.

    On CUDA tensors this launches the forward lattice kernel (S at most
    ``LATTICE_MAX_S``); on CPU tensors it runs
    ``ctc_lattice_fwd_reference``."""
    if not _check_lattice("ctc_lattice_fwd", lp_ext, skip, input_lengths,
                          label_lengths):
        return ctc_lattice_fwd_reference(lp_ext, skip, input_lengths,
                                         label_lengths)
    B, T, S = lp_ext.shape
    W, K = lattice_plan(S)
    lp_ext = lp_ext.contiguous()
    alpha = torch.empty((B, T, S), dtype=torch.float32, device=lp_ext.device)
    nll = torch.empty((B,), dtype=torch.float32, device=lp_ext.device)
    err = kernels.lib().ctc_lattice_fwd(
        lp_ext.data_ptr(), _skip_bytes(skip).data_ptr(),
        input_lengths.contiguous().data_ptr(),
        label_lengths.contiguous().data_ptr(), alpha.data_ptr(),
        nll.data_ptr(), B, T, S, W, K, kernels.stream_ptr(lp_ext.device))
    kernels.check(err, "ctc_lattice_fwd")
    ctc_lattice_fwd.launches += 1
    return nll, alpha


def ctc_lattice_bwd(lp_ext, skip, input_lengths, label_lengths, alpha, nll,
                    g) -> torch.Tensor:
    """The forward's inputs, its saved alpha [B, T, S] and nll [B], and the
    upstream gradient g [B] (all float32) -> d(sum g * nll) / d lp_ext
    [B, T, S] float32, exactly 0 at frames at or past each input length.
    S at most ``LATTICE_MAX_S`` on CUDA tensors.

    On CUDA tensors this launches the backward lattice kernel; on CPU
    tensors it runs ``ctc_lattice_bwd_reference``."""
    on_cuda = _check_lattice("ctc_lattice_bwd", lp_ext, skip, input_lengths,
                             label_lengths)
    if (alpha.shape != lp_ext.shape or nll.shape != (lp_ext.shape[0],)
            or g.shape != nll.shape):
        raise ValueError("ctc_lattice_bwd: alpha, nll or g has the wrong shape")
    if any(x.dtype != torch.float32 or x.device != lp_ext.device
           for x in (alpha, nll, g)):
        raise TypeError("ctc_lattice_bwd: alpha, nll and g must be float32 "
                        f"on {lp_ext.device}")
    if not on_cuda:
        return ctc_lattice_bwd_reference(lp_ext, skip, input_lengths,
                                         label_lengths, alpha, nll, g)
    B, T, S = lp_ext.shape
    W, K = lattice_plan(S)
    lp_ext = lp_ext.contiguous()
    grad = torch.empty((B, T, S), dtype=torch.float32, device=lp_ext.device)
    err = kernels.lib().ctc_lattice_bwd(
        lp_ext.data_ptr(), _skip_bytes(skip).data_ptr(),
        input_lengths.contiguous().data_ptr(),
        label_lengths.contiguous().data_ptr(), alpha.contiguous().data_ptr(),
        nll.contiguous().data_ptr(), g.contiguous().data_ptr(),
        grad.data_ptr(), B, T, S, W, K, kernels.stream_ptr(lp_ext.device))
    kernels.check(err, "ctc_lattice_bwd")
    ctc_lattice_bwd.launches += 1
    return grad


ctc_lattice_fwd.launches = 0
ctc_lattice_bwd.launches = 0


class CTCLattice(torch.autograd.Function):
    """nll [B] = the lattice forward of lp_ext; its backward is the lattice
    backward (the JAX package's ``_ctc_lattice`` custom VJP)."""

    @staticmethod
    def forward(ctx, lp_ext, skip, input_lengths, label_lengths):
        nll, alpha = ctc_lattice_fwd(lp_ext, skip, input_lengths,
                                     label_lengths)
        ctx.save_for_backward(lp_ext, skip, input_lengths, label_lengths,
                              alpha, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        lp_ext, skip, input_lengths, label_lengths, alpha, nll = \
            ctx.saved_tensors
        grad = ctc_lattice_bwd(lp_ext, skip, input_lengths, label_lengths,
                               alpha, nll, g.float().contiguous())
        return grad, None, None, None


def ctc_loss_lattice(logits: torch.Tensor, labels: torch.Tensor,
                     input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                     blank: int = 0) -> torch.Tensor:
    """``ctc_loss`` with the recursions in the lattice kernels. [B] NLL.
    S is not padded: the Pallas version's 128-lane padding is a TPU tile."""
    lp_ext, skip = _lattice_inputs(logits, labels, blank)
    dev = lp_ext.device
    return CTCLattice.apply(lp_ext.contiguous(), skip,
                            input_lengths.to(dev, torch.int32),
                            label_lengths.to(dev, torch.int32))


def ctc_loss_best(logits, labels, input_lengths, label_lengths,
                  blank: int = 0) -> torch.Tensor:
    """The lattice kernels for CUDA tensors, the plain ``ctc_loss`` for CPU
    tensors."""
    if logits.device.type == "cuda":
        return ctc_loss_lattice(logits, labels, input_lengths, label_lengths,
                                blank)
    return ctc_loss(logits, labels, input_lengths, label_lengths, blank)
