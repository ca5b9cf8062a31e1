#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lipreading_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels of ``lipreading_tpu_torch/csrc`` (one ``nvcc``
   call, cached by a hash of the sources) and print the build seconds;
2. print the card's name and power limit as ``nvidia-smi`` reports them;
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time the kernel, the plain version and
   one PyTorch yardstick beside it;
4. drive the serving path: fixture clips at 160x160 -> ``preprocess_clips``
   -> the released ``transformer_hybrid_universal4`` model at full width ->
   ``greedy_conf`` -> transcripts, with every kernel's launch count set to 0
   just before and read just after; the transcripts must equal those of the
   same run on the CPU (plain versions there);
5. drive the training path: ``FusedTrainer`` warm-started from the release,
   full width and depth, with the release's dropout and ROI jitter, on a
   fixture corpus at batch 8: a few steps with finite losses and one
   launch of the ROI and of each CTC lattice kernel per step (counts set to
   0 just before, read just after), the time of each stage of a step, then
   steps on one fixed batch whose loss must fall, and a checkpoint saved and
   reloaded with equal parameters;
6. one step without dropout or jitter on 2 clips on the card and on the CPU
   (plain versions there): loss, gradients and updated parameters agree
   within limits that a planted fault on the card must break;
7. print the kernels' JSON line, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result. Float32 matrix products run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``); cuDNN keeps its default
TF32 setting, which touches only float32 convolutions: the face detector's,
which turn it off for themselves (``ops.roi.full_float32``).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RELEASE = "transformer_hybrid_universal4"
N_CLIPS = 8
MIN_FRAMES = 64
BUCKET = 32                 # clips are zero-padded to a multiple of this
FIRST_SEED = 100
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
ROI_TOL = 1e-4
# CTC lattice kernels vs their plain versions (the limits of
# tests/test_ctc_pallas.py): nll relative 1e-5 (same terms, same order; expf
# and log1pf differ from the CPU's by ulps over T steps), grads rtol 1e-3 /
# atol 1e-5
CTC_NLL_RTOL = 1e-5
CTC_GRAD_RTOL, CTC_GRAD_ATOL = 1e-3, 1e-5
CTC_B, CTC_T = 8, 128       # the path's batch and longest time bucket
TRAIN_CLIPS = 12            # fixture clips of the training corpus
TRAIN_STEPS = 10
STAGE_STEPS = 3             # steps timed stage by stage
FIXED_STEPS = 10            # steps on one fixed batch
TRAIN_DIR = os.path.join(ROOT, "runs", "chip_smoke_train")
# card vs CPU, one bf16 step: the card's reading must stay within each limit
# and a planted fault, the card's step with one clip's frame length one
# short (a masking off-by-one), must break it. Each limit sits between the
# two readings (PERF.md, section 6, PR 5)
PARITY_LIMITS = {
    "loss_rel": 1e-3,       # |loss a - loss b| / |loss b|
    "norm_rel": 1e-3,       # the same for the unclipped gradient norm
    "grad_1_cos": 1e-4,     # 1 - cosine of the two gradients
    "flip_share": 5e-3,     # weights whose first Adam step (lr sign g) differs
}

class SmokeError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeError(msg)


def time_ms(fn, iters: int = 50) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` runs, warmed."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fixture_batch():
    """The first N_CLIPS fixture clips of >= MIN_FRAMES frames, zero-padded
    to a common length -> (frames [B, T, H, W, 3] u8, lengths [B], texts)."""
    import numpy as np

    from lipreading_tpu_torch.fixtures import make_clip

    clips, seed = [], FIRST_SEED
    while len(clips) < N_CLIPS:
        c = make_clip(seed)
        if c.frames.shape[0] >= MIN_FRAMES:
            clips.append(c)
        seed += 1
    T = -(-max(c.frames.shape[0] for c in clips) // BUCKET) * BUCKET
    H, W = clips[0].frames.shape[1:3]
    frames = np.zeros((N_CLIPS, T, H, W, 3), np.uint8)
    lengths = np.zeros((N_CLIPS,), np.int32)
    for b, c in enumerate(clips):
        frames[b, :len(c.frames)] = c.frames
        lengths[b] = len(c.frames)
    return frames, lengths, [c.text for c in clips]


def phase_build():
    from lipreading_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.lib()
    log(f"[build] nvcc + load: {time.perf_counter() - t0:.2f} s "
        f"(nvcc alone {kernels.STATE.build_seconds:.2f} s; 0 = cached) "
        f"-> {kernels.STATE.path}")
    for line in kernels.STATE.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def path_inputs(frames, lengths, dev):
    """The ROI sampler's and the greedy kernel's inputs as the main path
    makes them: gray frames, integer and float mouth boxes, log-probs."""
    import torch

    from lipreading_tpu_torch.ops import detector as det_ops
    from lipreading_tpu_torch.ops import ert as ert_ops
    from lipreading_tpu_torch.ops import preprocess as pre
    from lipreading_tpu_torch.ops.roi import grayscale

    det, ert = dev["det"], dev["ert"]
    B, T, H, W, _ = frames.shape
    with torch.inference_mode():
        gray = grayscale(torch.as_tensor(frames, device="cuda").reshape(
            B * T, H, W, 3))
        lmk = ert_ops.predict_batch(ert, gray, det_ops.detect(det, gray))
        boxes_i = pre.mouth_boxes_from_landmarks(
            lmk, dev["cfg"].preprocess.roi_margin, H, W)
        boxes_f = pre.mouth_boxes_float(lmk, dev["cfg"].preprocess.roi_margin)
    return gray, boxes_i, boxes_f


def roi_bytes_needed(boxes, subpixel: bool, H: int, W: int, R: int) -> int:
    """Bytes of gray that the ROIs depend on: each frame's distinct tap rows
    times distinct tap columns, 4 bytes each (plus the boxes)."""
    import torch

    from lipreading_tpu_torch.ops.roi import _interp_weights_dense

    wy = _interp_weights_dense(boxes[:, 1], boxes[:, 2], H, R, subpixel)
    wx = _interp_weights_dense(boxes[:, 0], boxes[:, 2], W, R, subpixel)
    rows = (wy != 0).any(dim=1).sum(dim=1)        # [N] distinct rows touched
    cols = (wx != 0).any(dim=1).sum(dim=1)
    return int(torch.sum(rows * cols).item()) * 4 + boxes.numel() * 4


def phase_kernels(frames, lengths, dev) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from lipreading_tpu_torch.ops import decode, roi
    from lipreading_tpu_torch.text import Vocab

    cfg = dev["cfg"]
    pc = cfg.preprocess
    R = pc.roi_size
    gray, boxes_i, boxes_f = path_inputs(frames, lengths, dev)
    N, H, W = gray.shape
    rows = []

    # --- ROI sampler, both box modes (integer is the main path's) ---------
    kw = dict(mean=pc.normalize_mean, std=pc.normalize_std)
    errs = {}
    for name, boxes, sub in (("integer", boxes_i, False),
                             ("subpixel", boxes_f, True)):
        got = roi.sample_rois(gray, boxes, R, subpixel=sub, **kw)
        want = roi.sample_rois_reference(gray, boxes, R, subpixel=sub, **kw)
        torch.cuda.synchronize()
        errs[name] = (got - want).abs().max().item()
        check(torch.isfinite(got).all().item(), f"ROI {name}: non-finite")
        log(f"[roi] {name} boxes: max |kernel - plain| = {errs[name]:.3g} "
            f"(tolerance {ROI_TOL:g}: the kernel sums the two taps in "
            "another order than the dense float32 product)")
        check(errs[name] <= ROI_TOL, f"ROI {name} disagrees: {errs[name]}")

    # library yardstick: F.grid_sample, one call that bilinearly resamples
    # the same crops (without the normalisation and the crop-edge clamping)
    x0, y0, s = (boxes_i[:, k].float() for k in range(3))
    j = (torch.arange(R, device="cuda", dtype=torch.float32) + 0.5) / R
    gx = (x0[:, None] + j[None] * s[:, None]) * (2.0 / W) - 1.0
    gy = (y0[:, None] + j[None] * s[:, None]) * (2.0 / H) - 1.0
    grid = torch.stack([gx[:, None, :].expand(N, R, R),
                        gy[:, :, None].expand(N, R, R)], dim=-1)
    g4 = gray[:, None]
    ms = time_ms(lambda: roi.sample_rois(gray, boxes_i, R, **kw))
    plain = time_ms(lambda: roi.sample_rois_reference(gray, boxes_i, R, **kw))
    lib = time_ms(lambda: F.grid_sample(g4, grid, mode="bilinear",
                                        align_corners=False))
    nbytes = roi_bytes_needed(boxes_i, False, H, W, R) + N * R * R * 4
    b_ms, b_by = bound_ms(nbytes, 10.0 * N * R * R)
    log(f"[roi] N={N} H={H} W={W} R={R}: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, F.grid_sample {lib:.4f} ms, bound "
        f"{b_ms * 1e3:.3f} us ({b_by}, {nbytes} B)")
    rows.append(dict(
        name="roi_sampler", route="cuda",
        source="lipreading_tpu_torch/csrc/roi_sampler.cu",
        replaces="lipreading_tpu/ops/roi.py:107",
        launches=0, max_abs_err=max(errs.values()), ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib))

    # --- CTC greedy: path shape plus the edge cases -------------------------
    V, blank = cfg.model.vocab_size, Vocab().blank_id
    B, T = frames.shape[:2]
    g = torch.Generator(device="cpu").manual_seed(0)
    cases = []
    for (b, t, v) in ((B, T, V), (B, 1, V), (B, 128, V), (3, 1000, V)):
        # small integers make ties common: the first maximum must win
        lg = torch.randint(0, 4, (b, t, v), generator=g).float()
        ln = torch.randint(0, t + 1, (b,), generator=g, dtype=torch.int32)
        ln[0] = 0
        ln[-1] = t
        cases.append((lg.cuda(), ln.cuda()))
    worst = 0
    for lg, ln in cases:
        ids, cnt = decode.ctc_greedy_ids(lg, ln, blank)
        rids, rcnt = decode.ctc_greedy_ids_reference(lg, ln, blank)
        torch.cuda.synchronize()
        bad = int((ids != rids).sum().item() + (cnt != rcnt).sum().item())
        log(f"[greedy] B={lg.shape[0]} T={lg.shape[1]} V={lg.shape[2]}: "
            f"{bad} ids or counts differ from the plain version")
        check(bad == 0, "CTC greedy disagrees with its plain version")
        worst = max(worst, bad)
    lg, ln = cases[0]
    ms = time_ms(lambda: decode.ctc_greedy_ids(lg, ln, blank))
    plain = time_ms(lambda: decode.ctc_greedy_ids_reference(lg, ln, blank))

    def library():
        raw = lg.argmax(-1)
        prev = F.pad(raw[:, :-1], (1, 0), value=blank)
        t_idx = torch.arange(T, device="cuda")[None]
        keep = (raw != blank) & (raw != prev) & (t_idx < ln[:, None])
        pos = torch.where(keep, torch.cumsum(keep, 1) - 1, T)
        out = torch.full((B, T + 1), blank, dtype=raw.dtype, device="cuda")
        return out.scatter_(1, pos, raw)[:, :T], keep.sum(1)

    composite = time_ms(library)
    valid = int(torch.clamp(ln, 0, T).sum().item())
    nbytes = valid * V * 4 + B * 4 + B * T * 4 + B * 4
    b_ms, b_by = bound_ms(nbytes, valid * V)
    log(f"[greedy] B={B} T={T} V={V}: kernel {ms:.4f} ms, plain {plain:.4f} "
        f"ms, argmax+mask+cumsum+scatter {composite:.4f} ms (a yardstick of "
        f"several calls: no single PyTorch call computes this, so "
        f"library_ms is null), bound {b_ms * 1e3:.4f} us ({b_by}, "
        f"{nbytes} B)")
    rows.append(dict(
        name="ctc_greedy", route="cuda",
        source="lipreading_tpu_torch/csrc/ctc_greedy.cu",
        replaces="lipreading_tpu/ops/decode_pallas.py:22",
        launches=0, max_abs_err=float(worst), ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return rows


def load_port(device: str):
    from lipreading_tpu_torch.io import load_assets, load_release_model
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch

    model, cfg = load_release_model(RELEASE, device=device)
    det_np, ert_np = load_assets()
    return {"model": model, "cfg": cfg,
            "det": params_to_torch(det_np, device),
            "ert": model_to_torch(ert_np, device)}


def run_path(frames, lengths, port):
    from lipreading_tpu_torch.infer import transcribe_greedy

    return transcribe_greedy(port["model"], port["cfg"], port["det"],
                             port["ert"], frames, lengths)


def phase_path(frames, lengths, texts, gpu, rows):
    import torch

    from lipreading_tpu_torch.infer import greedy_conf
    from lipreading_tpu_torch.metrics import corpus_cer
    from lipreading_tpu_torch.ops.decode import ctc_greedy_ids
    from lipreading_tpu_torch.ops.preprocess import preprocess_clips
    from lipreading_tpu_torch.ops.roi import sample_rois

    wrappers = {"roi_sampler": sample_rois, "ctc_greedy": ctc_greedy_ids}
    B, T = frames.shape[:2]
    log(f"[path] {B} clips x {T} frames at {frames.shape[2]}x"
        f"{frames.shape[3]}, lengths {lengths.tolist()}, release {RELEASE}")
    run_path(frames, lengths, gpu)                  # warm-up
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    hyps, flags = run_path(frames, lengths, gpu)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    path_rows = [r for r in rows if r["name"] in wrappers]
    for row in path_rows:
        row["launches"] = wrappers[row["name"]].launches
    log(f"[path] frames -> transcripts: {dt * 1e3:.1f} ms host clock "
        f"({B * T / dt:.0f} padded frames/s), launches "
        + ", ".join(f"{r['name']}={r['launches']}" for r in path_rows))
    for r in path_rows:
        check(r["launches"] > 0, f"{r['name']} never launched on the path")

    # outputs: finite, of the expected shape; and the time of each stage
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clips_t = torch.as_tensor(frames, device="cuda")
        lens_t = torch.as_tensor(lengths, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rois = preprocess_clips(gpu["det"], gpu["ert"], clips_t,
                                gpu["cfg"].preprocess)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ids, cnt, conf, enc = greedy_conf(gpu["model"], gpu["cfg"], rois,
                                          lens_t)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    log(f"[path] stages (host clock, synchronised): frames to card "
        f"{(t1 - t0) * 1e3:.2f} ms, preprocess_clips {(t2 - t1) * 1e3:.2f} "
        f"ms, greedy_conf {(t3 - t2) * 1e3:.2f} ms")
    R = gpu["cfg"].preprocess.roi_size
    check(tuple(rois.shape) == (B, T, R, R), f"rois {tuple(rois.shape)}")
    check(tuple(ids.shape) == (B, T), f"ids {tuple(ids.shape)}")
    check(tuple(enc.shape) == (B, T, gpu["cfg"].model.tf_dim),
          f"enc {tuple(enc.shape)}")
    for name, x in (("rois", rois), ("conf", conf), ("enc", enc)):
        check(torch.isfinite(x.float()).all().item(), f"{name} not finite")

    cer = corpus_cer(hyps, texts)
    for h, t, f in zip(hyps, texts, flags):
        log(f"[path]   {h!r:32} ref {t!r:32} margin flag {bool(f)}")
    log(f"[path] corpus CER {cer:.4f}; {int(flags.sum())} of {B} clips below "
        "the cascade's margin (the beam leg is not ported yet)")

    # the same run on the CPU, through the plain versions
    t0 = time.perf_counter()
    cpu_hyps, cpu_flags = run_path(frames, lengths, load_port("cpu"))
    log(f"[path] CPU run ({time.perf_counter() - t0:.1f} s): transcripts "
        f"{'equal' if cpu_hyps == hyps else 'DIFFER'}, margin flags "
        f"{'equal' if (cpu_flags == flags).all() else 'differ'}")
    check(cpu_hyps == hyps, f"GPU transcripts {hyps} != CPU {cpu_hyps}")


def ctc_case(V: int, L: int):
    """The CTC lattice kernels' inputs at the training path's shape: B = 8,
    T = 128, S = 2 L + 1 from random log-probs; label lengths mixed with a
    0 and L, input lengths mixed with one below T; a repeated label."""
    import numpy as np
    import torch

    from lipreading_tpu_torch.ops import ctc

    rng = np.random.default_rng(5)
    B, T = CTC_B, CTC_T
    logits = torch.from_numpy(rng.normal(0, 2, (B, T, V)).astype(np.float32))
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    labels[:, 1] = labels[:, 0]
    lab = rng.integers(1, L + 1, B).astype(np.int32)
    lab[0], lab[-1] = 0, L
    inl = np.minimum(np.maximum(2 * lab + 2, rng.integers(T // 2, T + 1, B)),
                     T).astype(np.int32)
    inl[0], inl[-1] = T // 3, T
    labels_t = torch.from_numpy(labels)
    lp_ext, skip = ctc._lattice_inputs(logits, labels_t, 0)
    return {"logits": logits.cuda(), "labels": labels_t.cuda(),
            "lp_ext": lp_ext.cuda(), "skip": skip.cuda(),
            "inl": torch.from_numpy(inl).cuda(),
            "lab": torch.from_numpy(lab).cuda()}


def phase_ctc_kernels(cfg) -> list[dict]:
    """Both CTC lattice kernels against their plain versions at the path's
    shape, with times, bounds and F.ctc_loss as the yardstick."""
    import torch
    import torch.nn.functional as F

    from lipreading_tpu_torch.ops import ctc

    c = ctc_case(cfg.model.vocab_size, cfg.data.max_chars)
    lp, skip, inl, lab = c["lp_ext"], c["skip"], c["inl"], c["lab"]
    B, T, S = lp.shape
    g = 1.0 / torch.clamp(lab.float(), min=1.0) / B     # d mean(nll / len)
    nll, alpha = ctc.ctc_lattice_fwd(lp, skip, inl, lab)
    grad = ctc.ctc_lattice_bwd(lp, skip, inl, lab, alpha, nll, g)
    nll_w, alpha_w = ctc.ctc_lattice_fwd_reference(lp, skip, inl, lab)
    grad_w = ctc.ctc_lattice_bwd_reference(lp, skip, inl, lab, alpha_w,
                                           nll_w, g)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(nll).all() and torch.isfinite(grad).all()),
          "CTC lattice: non-finite nll or grad")
    nll_rel = ((nll - nll_w).abs() / nll_w.abs().clamp(min=1.0)).max().item()
    nll_err = (nll - nll_w).abs().max().item()
    g_excess = ((grad - grad_w).abs()
                - (CTC_GRAD_ATOL + CTC_GRAD_RTOL * grad_w.abs())).max().item()
    g_err = (grad - grad_w).abs().max().item()
    t_idx = torch.arange(T, device="cuda")[None, :, None]
    past = (grad.abs() * (t_idx >= inl[:, None, None])).sum().item()
    log(f"[ctc] B={B} T={T} S={S} lengths {inl.tolist()} labels "
        f"{lab.tolist()}: nll max |kernel - plain| = {nll_err:.3g} "
        f"(relative {nll_rel:.3g}, limit {CTC_NLL_RTOL:g}); grad max "
        f"|kernel - plain| = {g_err:.3g} (limit rtol {CTC_GRAD_RTOL:g} / atol "
        f"{CTC_GRAD_ATOL:g}, excess {g_excess:.3g}); grad past the input "
        f"lengths sums to {past}")
    check(nll_rel <= CTC_NLL_RTOL, f"CTC lattice nll disagrees: {nll_rel}")
    check(g_excess <= 0.0, f"CTC lattice grad disagrees: {g_err}")
    check(past == 0.0, "CTC lattice grad is not 0 past the input length")

    # yardstick: F.ctc_loss on the same log-probs (its own alpha and beta)
    logp = torch.log_softmax(c["logits"], dim=-1).transpose(0, 1).contiguous()
    logp_g = logp.clone().requires_grad_()
    targets, inl64, lab64 = c["labels"].long(), inl.long(), lab.long()

    def lib_fwd():
        return F.ctc_loss(logp, targets, inl64, lab64, reduction="none")

    def lib_fwd_bwd():
        logp_g.grad = None
        F.ctc_loss(logp_g, targets, inl64, lab64,
                   reduction="none").sum().backward()

    lib_nll = lib_fwd()
    torch.cuda.synchronize()
    log(f"[ctc] F.ctc_loss vs kernel nll: max |diff| "
        f"{(lib_nll - nll).abs().max().item():.3g} (a yardstick only)")
    ms_f = time_ms(lambda: ctc.ctc_lattice_fwd(lp, skip, inl, lab))
    ms_b = time_ms(lambda: ctc.ctc_lattice_bwd(lp, skip, inl, lab, alpha, nll,
                                               g))
    plain_f = time_ms(lambda: ctc.ctc_lattice_fwd_reference(lp, skip, inl,
                                                            lab), iters=5)
    plain_b = time_ms(lambda: ctc.ctc_lattice_bwd_reference(
        lp, skip, inl, lab, alpha, nll, g), iters=5)
    lib_f = time_ms(lib_fwd)
    lib_fb = time_ms(lib_fwd_bwd)

    # what this run's data needs: rows t < input length are read, every row
    # of alpha and of the gradient is written
    n = torch.clamp(inl, 0, T)
    rows_f = int(torch.clamp(n, min=1).sum().item())
    rows_b = int(n.sum().item())
    steps = int(torch.clamp(n - 1, min=0).sum().item())
    n_skip = skip.sum(1)
    skip_steps = int((torch.clamp(n - 1, min=0) * n_skip).sum().item())
    small = B * S + 2 * B * 4                   # skip flags and lengths
    bytes_f = rows_f * S * 4 + small + B * T * S * 4 + B * 4
    bytes_b = (steps * S * 4 + rows_b * S * 4 + small + 2 * B * 4
               + B * T * S * 4)
    # one logaddexp is 6 operations (max, sub, abs, exp, log1p, add)
    ops_f = steps * S * 7 + skip_steps * 6
    ops_b = rows_b * S * (3 + 12 + 5)
    bf, byf = bound_ms(bytes_f, ops_f)
    bb, byb = bound_ms(bytes_b, ops_b)
    log(f"[ctc] forward: kernel {ms_f:.4f} ms, plain {plain_f:.4f} ms, "
        f"F.ctc_loss forward {lib_f:.4f} ms, bound {bf * 1e3:.3f} us ({byf}, "
        f"{bytes_f} B, {ops_f} ops)")
    log(f"[ctc] backward: kernel {ms_b:.4f} ms, plain {plain_b:.4f} ms, "
        f"F.ctc_loss forward+backward {lib_fb:.4f} ms (its backward needs "
        f"its own forward), bound {bb * 1e3:.3f} us ({byb}, {bytes_b} B, "
        f"{ops_b} ops)")
    return [
        dict(name="ctc_lattice_fwd", route="cuda",
             source="lipreading_tpu_torch/csrc/ctc_lattice.cu",
             replaces="lipreading_tpu/ops/ctc_pallas.py:46", launches=0,
             max_abs_err=nll_err, ms=ms_f, plain_ms=plain_f, bound_ms=bf,
             bound_by=byf, library_ms=lib_f),
        dict(name="ctc_lattice_bwd", route="cuda",
             source="lipreading_tpu_torch/csrc/ctc_lattice.cu",
             replaces="lipreading_tpu/ops/ctc_pallas.py:79", launches=0,
             max_abs_err=g_err, ms=ms_b, plain_ms=plain_b, bound_ms=bb,
             bound_by=byb, library_ms=lib_fb),
    ]


def release_train_cfg(**overrides):
    """The release's config (dropout 0.1, roi_augment 0.15), with
    overrides."""
    from lipreading_tpu_torch.io import load_release

    tree, cfg = load_release(RELEASE)
    return tree, (cfg.override(**overrides) if overrides else cfg)


def make_trainer(cfg, tree, dev, device, workdir):
    """A FusedTrainer warm-started from ``tree``, or initialised from the
    config's seed when ``tree`` is None."""
    from lipreading_tpu_torch.train.loop import FusedTrainer

    tr = FusedTrainer(cfg, workdir, dev["det"], dev["ert"], device=device)
    tr.logger.echo = False
    if tree is not None:
        tr.warm_start(tree)
    return tr


def det_loss(tr, batch) -> float:
    """The batch's loss without dropout or jitter (``rng=None``)."""
    import torch

    from lipreading_tpu_torch.data.pipeline import video_batch_to_device
    from lipreading_tpu_torch.models.lipreader import compute_loss

    with torch.no_grad():
        mb = tr.model_batch(video_batch_to_device(batch, tr.device))
        loss, _ = compute_loss(tr.model, tr.cfg, mb, train=True, gen=None)
    return float(loss)


def phase_train(gpu, rows):
    """FusedTrainer on the card: steps with launch counts, stage times, a
    fixed batch whose loss falls, a checkpoint round trip."""
    import torch

    from lipreading_tpu_torch.data.pipeline import (
        FixtureVideoDataset,
        VideoBatchIterator,
    )
    from lipreading_tpu_torch.ops.ctc import ctc_lattice_bwd, ctc_lattice_fwd
    from lipreading_tpu_torch.ops.roi import sample_rois

    tree, cfg = release_train_cfg()
    t0 = time.perf_counter()
    ds = FixtureVideoDataset(TRAIN_CLIPS, seed=1, cfg=cfg.data)
    it = VideoBatchIterator(ds, cfg.data.batch_size, seed=cfg.train.seed)
    log(f"[train] corpus: {TRAIN_CLIPS} fixture clips -> {len(ds)} samples "
        f"({time.perf_counter() - t0:.1f} s to render); release {RELEASE}, "
        f"full width and depth, dropout {cfg.model.dropout}, roi_augment "
        f"{cfg.train.roi_augment}, batch {cfg.data.batch_size}, "
        f"{cfg.model.dtype}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    tr = make_trainer(cfg, tree, gpu, "cuda", TRAIN_DIR)
    tr.train_step(next(it))                    # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()

    wrappers = {"roi_sampler": sample_rois, "ctc_lattice_fwd": ctc_lattice_fwd,
                "ctc_lattice_bwd": ctc_lattice_bwd}
    for w in wrappers.values():
        w.launches = 0
    step_ms, frames, losses = [], 0, []
    for _ in range(TRAIN_STEPS):
        batch = next(it)
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        frames += batch.frames.shape[0] * batch.frames.shape[1]
        losses.append({k: float(v) for k, v in m.items()})
    launches = {k: w.launches for k, w in wrappers.items()}
    for r in rows:
        if r["name"] in ("ctc_lattice_fwd", "ctc_lattice_bwd"):
            r["launches"] = launches[r["name"]]
    for i, m in enumerate(losses):
        log(f"[train]   step {i + 2}: loss {m['loss']:.4f} ctc "
            f"{m['ctc_loss']:.4f} att {m['att_loss']:.4f} grad_norm "
            f"{m['grad_norm']:.3f} ({step_ms[i]:.1f} ms)")
    total = sum(step_ms)
    log(f"[train] {TRAIN_STEPS} steps: {total / TRAIN_STEPS:.1f} ms per step "
        f"(host clock, synchronised), {frames / total * 1e3:.0f} padded "
        f"frames/s; launches {launches} "
        f"(per step {({k: v / TRAIN_STEPS for k, v in launches.items()})})")
    for m in losses:
        check(all(map(lambda v: v == v and abs(v) != float("inf"),
                      m.values())), f"non-finite step metrics {m}")
    for k, v in launches.items():
        check(v == TRAIN_STEPS, f"{k}: {v} launches in {TRAIN_STEPS} "
              "training steps, want one per step")

    # where a step's time goes: each stage closed by a synchronise
    stages = {}
    shapes = []
    for _ in range(STAGE_STEPS):
        batch = next(it)
        tr.train_step(batch, stage_ms=stages)
        shapes.append(tuple(batch.frames.shape[:2]))
    log(f"[train] stages (mean of {STAGE_STEPS} steps, batches {shapes}, "
        "host clock, synchronised): " + ", ".join(
            f"{k} {v / STAGE_STEPS:.2f} ms" for k, v in stages.items()))
    nbytes = batch.frames.nbytes
    log(f"[train] host copy: uint8 frames of the last batch {nbytes} B "
        f"(pageable host memory)")

    # checkpoint: save, reload into a fresh trainer, parameters equal
    path = tr.save(it)
    tr2 = make_trainer(cfg, tree, gpu, "cuda", TRAIN_DIR)
    it_state = tr2.restore(path)
    same = all(torch.equal(a, b) for a, b in
               zip(tr.model.state_dict().values(),
                   tr2.model.state_dict().values()))
    same_opt = all(torch.equal(tr.opt.mu[k], tr2.opt.mu[k])
                   and torch.equal(tr.opt.nu[k], tr2.opt.nu[k])
                   for k in tr.opt.mu) and tr.opt.count == tr2.opt.count
    log(f"[train] checkpoint {os.path.basename(path)} "
        f"({os.path.getsize(path)} B): reloaded step {tr2.step}, params "
        f"{'equal' if same else 'DIFFER'}, optimizer state "
        f"{'equal' if same_opt else 'DIFFERS'}, iterator {it_state}")
    check(same and same_opt and tr2.step == tr.step,
          "checkpoint round trip changed the state")
    del tr, tr2

    # one fixed batch: its loss (no dropout, no jitter) must fall. The
    # release already fits the fixtures (loss ~1e-4), so this starts from
    # the config's seeded initialisation; the release's 200 warm-up steps
    # would keep the rate near 0, so none here
    _, cfg_fix = release_train_cfg(**{"train.warmup_steps": 0})
    tr = make_trainer(cfg_fix, None, gpu, "cuda", TRAIN_DIR)
    batch = ds.batch(list(range(cfg.data.batch_size)),
                     max(cfg.data.time_buckets))
    before = det_loss(tr, batch)
    seen = [float(tr.train_step(batch)["loss"]) for _ in range(FIXED_STEPS)]
    after = det_loss(tr, batch)
    log(f"[train] fixed batch {tuple(batch.frames.shape[:2])}, from the "
        f"seeded initialisation, lr "
        f"{cfg_fix.train.learning_rate}: loss without dropout {before:.4f} "
        f"-> {after:.4f} after {FIXED_STEPS} steps; step losses "
        + " ".join(f"{v:.4f}" for v in seen))
    check(after < before, f"fixed-batch loss did not fall: {before} -> {after}")
    del tr
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def parity_readings(a: dict, b: dict, lr: float) -> dict:
    """How far step ``a`` is from step ``b``, in the terms of
    ``PARITY_LIMITS``."""
    import torch

    diffs = torch.cat([(a["params"][k] - b["params"][k]).abs().reshape(-1)
                       for k in a["params"]])
    return {
        "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
        "norm_rel": abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"],
        "grad_1_cos": 1.0 - float(torch.nn.functional.cosine_similarity(
            a["grads"], b["grads"], dim=0)),
        "flip_share": float((diffs > lr).float().mean()),
    }


def phase_train_parity(gpu):
    """One step without dropout or jitter on 2 clips, on the card and on the
    CPU (plain versions), from the same seeded initialisation (the release's
    loss, ~1e-4, leaves gradients too small to compare in bfloat16). Two
    controls beside it: a planted fault on the card, which every limit must
    catch, and the CPU in float32, which reads how far bf16 rounding alone
    moves the step (reported, not gated)."""
    import dataclasses

    import torch

    from lipreading_tpu_torch.data.pipeline import FixtureVideoDataset

    over = {"model.dropout": 0.0, "train.roi_augment": 0.0,
            "train.warmup_steps": 0}
    _, cfg = release_train_cfg(**over)
    _, cfg32 = release_train_cfg(**dict(over, **{"model.dtype": "float32"}))
    ds = FixtureVideoDataset(1, seed=2, cfg=cfg.data)
    batch = ds.batch([0, 1], 32)
    short = batch.frame_lengths.copy()
    short[-1] -= 1
    faulty = dataclasses.replace(batch, frame_lengths=short)
    cpu = load_port("cpu")
    out = {}
    for name, c, b, dev, device in (
            ("card", cfg, batch, gpu, "cuda"),
            ("card_fault", cfg, faulty, gpu, "cuda"),
            ("cpu", cfg, batch, cpu, "cpu"),
            ("cpu_f32", cfg32, batch, cpu, "cpu")):
        t0 = time.perf_counter()
        tr = make_trainer(c, None, dev, device, TRAIN_DIR + "_" + name)
        m = tr.train_step(b)
        out[name] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {k: p.detach().cpu() for k, p in
                       tr.model.named_parameters()},
            "grads": torch.cat([p.grad.detach().double().cpu().reshape(-1)
                                for p in tr.model.parameters()]),
            "s": time.perf_counter() - t0}
        del tr
        shutil.rmtree(TRAIN_DIR + "_" + name, ignore_errors=True)
    lr = cfg.train.learning_rate
    read = {name: parity_readings(out[name], out["cpu"], lr)
            for name in ("card", "card_fault", "cpu_f32")}
    log(f"[parity] seeded initialisation, batch "
        f"{tuple(batch.frames.shape[:2])}, lengths "
        f"{batch.frame_lengths.tolist()} (fault {short.tolist()}), lr {lr} "
        "at step 0: " + "; ".join(
            f"{k} loss {v['loss']:.6f} grad_norm {v['grad_norm']:.5f} "
            f"({v['s']:.1f} s)" for k, v in out.items()))
    for k, lim in PARITY_LIMITS.items():
        log(f"[parity]   {k}: card vs cpu {read['card'][k]:.4g}, limit "
            f"{lim:g}, planted fault vs cpu {read['card_fault'][k]:.4g}; cpu "
            f"float32 vs cpu {read['cpu_f32'][k]:.4g}")
    for k, lim in PARITY_LIMITS.items():
        check(read["card"][k] <= lim,
              f"parity: card vs CPU {k} {read['card'][k]} > {lim}")
        check(read["card_fault"][k] > lim,
              f"parity: the planted fault's {k} {read['card_fault'][k]} is "
              f"within the limit {lim}: the limit would pass a faulty step")


def main() -> int:
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        log(f"chip_smoke: FAIL: {e}")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: FAIL: no CUDA device (this script never falls back "
            "to the CPU)")
        return 1
    try:
        import lipreading_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: FAIL: the port is not beside this script: {e}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"matmul TF32 off, cuDNN TF32 {torch.backends.cudnn.allow_tf32} "
        "(the detector turns it off for its own convolutions)")
    try:
        phase_build()
        smi = nvidia_smi_line()
        log(f"[card] {smi}")
        frames, lengths, texts = fixture_batch()
        gpu = load_port("cuda")
        rows = phase_kernels(frames, lengths, gpu)
        rows += phase_ctc_kernels(gpu["cfg"])
        phase_path(frames, lengths, texts, gpu, rows)
        phase_train(gpu, rows)
        phase_train_parity(gpu)
    except Exception as e:  # every phase failure ends here, without a result
        import traceback

        traceback.print_exc()
        log(f"chip_smoke: FAIL: {type(e).__name__}: {e}")
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
