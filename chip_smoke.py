#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lipreading_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels of ``lipreading_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together, then one link; cached by a hash of
   the sources), print the build seconds, each kernel's registers and
   spills (the Hopper flash kernels must not spill, and those that trade
   registers with ``setmaxnreg`` must be built for its pool) and how many
   ``HGMMA`` and ``UTMALDG`` instructions the library holds (both > 0);
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

Flash attention (``model.flash_attention=1``) adds three phases:

* ``[flash]``: the forward (with and without lse), the fused backward and
  the two-pass pair against their plain versions at the path's shape
  (B 4, T 1024, H 4, Dh 64, ragged lengths with a 0), at T 8192 and at a
  ragged B 3, T 200, H 2, Dh 100 (lengths 200, 1, 0; not timed), in bf16
  and float32, within limits that a planted fault (each key mask one short)
  must break; two launches of the two-pass pair giving the same bytes;
  each kernel's own device time (CUDA events around its bare C entry), its
  TFLOP/s and share of the bound, the wrapper's time, the plain version's
  and SDPA's device time (its kernels' sum in ``torch.profiler``, the
  backward's kernels apart) beside them; the ``auto`` policy's readings
  (forward + backward under xla, fused and pallas);
* ``[path-flash]``: the release with flash on transcribes the short clips of
  ``[path]`` and 4 long clips (about 1000 frames, padded to 1024, rendered
  in worker processes meanwhile), with one forward launch per encoder layer;
  the transcripts must equal the CPU's (the long clips from the card's
  ROIs); flash off beside it, reported;
* ``[train-flash]``: fine-tuning on the long clips under each backward
  policy with the launches of each step counted (they are the flash rows'
  ``launches``), one float32 step's gradient of pallas and fused against
  xla within limits that a planted fault must break, a fixed batch whose
  loss falls, and peak memory with flash on and off.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result. Float32 matrix products and cuDNN convolutions run in
full float32 (TF32 off).
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

# flash attention (universal4's encoder: tf_dim 256, 4 heads, Dh 64)
FLASH_ON = {"model.flash_attention": 1}
FLASH_H, FLASH_DH = 4, 64
# (case, B, T, H, Dh, lengths, timed): the path's shape, ragged with a 0; a
# long one; and, for correctness only, a ragged one whose head dim takes
# the wrapper's padded copy (200-byte rows) and whose T ends mid-tile, with
# samples of length 1 and 0
FLASH_CASES = (("path", 4, 1024, FLASH_H, FLASH_DH, (1024, 1000, 517, 0), True),
               ("long", 2, 8192, FLASH_H, FLASH_DH, (8192, 6001), True),
               ("ragged", 3, 200, 2, 100, (200, 1, 0), False))
FLASH_AUTO_T = (64, 128, 256, 512, 1024, 2048, 8192)
# kernel vs plain, max|kernel - plain| / max|plain| of each output. Each
# limit sits between the card's readings and a planted fault's (each key
# mask one short): PERF.md section 6, flash attention
FLASH_LIMITS = {"float32": 2e-5, "bfloat16": 1e-2}
FLASH_REPLACES = {
    "fwd": "lipreading_tpu/ops/flash_attention.py:74",
    "fused": "lipreading_tpu/ops/flash_attention.py:326",
    "dq": "lipreading_tpu/ops/flash_attention.py:228",
    "dkv": "lipreading_tpu/ops/flash_attention.py:274",
}
FLASH_ROW = {"fwd": "flash_fwd", "fused": "flash_bwd_fused",
             "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}
# the source of each row's (bf16) kernel
FLASH_SOURCE = dict.fromkeys(
    FLASH_ROW, "lipreading_tpu_torch/csrc/flash_attention_sm90.cu")
# bf16 device times (ms) of the two-pass pair's earlier kernels, float32 FMA
# on the CUDA cores, at the timed cases (chip_smoke.py's [flash] on an
# NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md section 6, row 7): printed
# beside the tensor-core kernels' own
CUDA_CORE_PAIR_MS = {("dq", 1024): 0.2777, ("dkv", 1024): 0.4585,
                     ("dq", 8192): 9.3753, ("dkv", 8192): 12.5711}
# the Hopper kernels whose warpgroups trade registers with setmaxnreg, and
# the registers a thread of each must be built for: the producer warpgroup
# gives (168 - 56) x 128 to the two consumer warpgroups, 256 x (224 - 168)
# (csrc/flash_attention_sm90.cu, kBwdRegs)
SM90_SETMAXNREG = ("bwd_kernel", "bwd_dq_kernel")
SM90_BWD_REGS = 168
# one float32 step's gradient under pallas and fused against xla: limits
# between the readings and a planted fault's (PERF.md section 6, flash
# attention)
FLASH_GRAD_LIMITS = {"grad_rel": 3e-5, "grad_1_cos": 1e-9}
FLASH_TRAIN_STEPS = 3       # steps under each backward policy
FLASH_FIXED_STEPS = 5       # steps on the fixed long batch
# long clips: about 4 frames a character, padded to the encoder's 1024 rows
LONG_TEXTS = (
    "the quick brown fox jumps over the lazy dog while seven bright "
    "students read their notes aloud in the quiet hall and the old clock on "
    "the wall keeps ticking slowly as rain falls on the window and a small "
    "bird sings its morning song near the door",
    "we walked along the river after dinner and talked about the long "
    "summer days when the fields were green and the children played near "
    "the water until the sun went down behind the hills and the first stars "
    "came out over the old stone bridge",
    "please bring the blue book from the kitchen table and put it next to "
    "the lamp in my room because i want to finish reading the last chapter "
    "before the train leaves tomorrow morning at half past eight from the "
    "station near the old market",
    "every morning she opens the window to let the fresh air into the house "
    "then she makes a cup of tea and sits by the garden where the roses grow "
    "tall and the bees move from flower to flower in the warm light of the "
    "early sun on a clear day",
)
LONG_SEED = 500
LONG_BUCKET = 1024
LONG_MAX_CHARS = 256        # whole transcripts as targets (sos and eos too)


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


def device_ms(fn, iters: int) -> tuple[float, dict]:
    """Device milliseconds per call of ``fn()``: the device time of every
    kernel, fill and copy that ``torch.profiler`` records over ``iters``
    warmed calls, summed and divided by ``iters`` -> (ms, {name: ms}).
    Fails if the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            split[e.name] = (split.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / iters)
    check(sum(split.values()) > 0, "torch.profiler recorded no device time")
    return sum(split.values()), split


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


def sass_counts(path: str) -> dict:
    """How many tensor-core (HGMMA) and TMA-load (UTMALDG) instructions
    ``cuobjdump --dump-sass`` finds in the library."""
    from lipreading_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", path], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    return {op: sum(line.split()[1:2] == [op] or f" {op}." in line
                    or f" {op} " in line for line in out.stdout.splitlines())
            for op in ("HGMMA", "UTMALDG")}


def kernel_name(mangled: str) -> str:
    """``name<template args>`` of a kernel from its mangled name."""
    import re

    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            n = int(mangled[i:m.end()])
            name = mangled[m.end():m.end() + n]
            if name.endswith("_kernel"):
                # template arguments: types by letter, values as L<type>nE
                t = re.match(r"I((?:L[a-z]\d+E|[a-z])+)E",
                             mangled[m.end() + n:])
                if not t:
                    return name
                args = [v or {"f": "float"}.get(c, c) for v, c in
                        re.findall(r"L[a-z](\d+)E|([a-z])", t.group(1))]
                return f"{name}<{','.join(args)}>"
    return mangled


def phase_build():
    """Build, print each kernel's registers and spills as ptxas reports them
    (the Hopper flash kernels must not spill; those that use setmaxnreg
    must be built for its pool) and the SASS counts."""
    import re

    from lipreading_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.lib()
    log(f"[build] nvcc + load: {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc and link {kernels.STATE.build_seconds:.2f} s; 0 = "
        f"cached) -> {kernels.STATE.path}")
    source, entry, spills, regs = "", "", {}, {}
    for line in kernels.STATE.build_log.splitlines():
        if line.startswith("== "):
            source = line[3:]
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = f"{source}:{kernel_name(m.group(1))}"
        if "spill" in line or "registers" in line:
            log(f"[build] {entry} {line.strip()}")
        if "sm90" in source:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills[entry] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry.split(":")[-1].split("<")[0] in SM90_SETMAXNREG:
                regs[entry] = int(m.group(1))
    if kernels.STATE.build_seconds:
        check(spills and not any(spills.values()),
              f"Hopper flash kernels spill: {spills}")
        # before any launch: a count below this would leave setmaxnreg
        # waiting for registers that no warp frees
        found = {e.split(":")[-1].split("<")[0] for e in regs}
        check(found == set(SM90_SETMAXNREG)
              and all(r == SM90_BWD_REGS for r in regs.values()),
              f"Hopper setmaxnreg kernels built for {regs} registers, want "
              f"{SM90_BWD_REGS} (setmaxnreg's pool) for each of "
              f"{SM90_SETMAXNREG}")
    counts = sass_counts(kernels.STATE.path)
    log(f"[build] SASS: {counts['HGMMA']} HGMMA (wgmma) and "
        f"{counts['UTMALDG']} UTMALDG (TMA load) instructions")
    check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
          f"no tensor-core or TMA instructions in the library: {counts}")


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


def load_port(device: str, overrides: dict | None = None):
    from lipreading_tpu_torch.io import load_assets, load_release_model
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch

    model, cfg = load_release_model(RELEASE, device=device,
                                    overrides=overrides)
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

    # an input length above T counts as T, in the kernel and in its plain
    # version alike (ROADMAP F2)
    inl_over = inl.clone()
    inl_over[1] = T + 7
    nll_o, alpha_o = ctc.ctc_lattice_fwd(lp, skip, inl_over, lab)
    grad_o = ctc.ctc_lattice_bwd(lp, skip, inl_over, lab, alpha_o, nll_o, g)
    nll_ow, alpha_ow = ctc.ctc_lattice_fwd_reference(lp, skip, inl_over, lab)
    grad_ow = ctc.ctc_lattice_bwd_reference(lp, skip, inl_over, lab,
                                            alpha_ow, nll_ow, g)
    torch.cuda.synchronize()
    o_excess = ((grad_o - grad_ow).abs()
                - (CTC_GRAD_ATOL + CTC_GRAD_RTOL * grad_ow.abs())).max().item()
    o_live = grad_ow[1].abs().sum().item()
    log(f"[ctc] input length {T + 7} > T = {T} on sample 1: grad max "
        f"|kernel - plain| = {(grad_o - grad_ow).abs().max().item():.3g} "
        f"(excess {o_excess:.3g}), plain grad of that sample sums to "
        f"{o_live:.3g} in absolute value (0 would be the unclamped rule)")
    check(o_excess <= 0.0, f"CTC lattice grad with a length above T: {o_excess}")
    check(o_live > 0.0, "the plain backward zeroes a length above T")

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


def flash_inputs(seed: int, B: int, T: int, lengths, dtype,
                 H: int = FLASH_H, Dh: int = FLASH_DH):
    """q, k, v, dO [B, T, H, Dh] ~ N(0, 1) from a seed, cast to ``dtype``,
    and int32 lengths, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shape = (B, T, H, Dh)
    xs = [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
          .to("cuda", dtype) for _ in range(4)]
    return (*xs, torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def rel_err(got, want) -> float:
    """max|got - want| / max|want| (float64)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def lse_err(got, want, lengths) -> float:
    """rel_err over the rows of samples with a key; the rows of a sample of
    length 0 must be equal (-1e30 on both sides)."""
    import torch

    live = lengths > 0
    if not torch.equal(got[~live], want[~live]):
        return float("inf")
    return rel_err(got[live], want[live])


def flash_all(q, k, v, ln, g, bwd_in=None):
    """Every flash kernel once -> {name: outputs}; the backwards take
    ``bwd_in`` (g gated, delta, lse) when given, else the forward's."""
    from lipreading_tpu_torch.ops import flash_attention as fa

    out = fa.flash_fwd(q, k, v, ln)
    out_l, lse_f = fa.flash_fwd(q, k, v, ln, return_lse=True)
    gg, delta, lse = bwd_in or (*fa.bwd_inputs(out_l, g, ln), lse_f)
    return {"fwd": (out,), "fwd_lse": (out_l, lse_f),
            "fused": fa.flash_bwd_fused(q, k, v, ln, gg, delta, lse),
            "dq": (fa.flash_bwd_dq(q, k, v, ln, gg, delta, lse),),
            "dkv": fa.flash_bwd_dkv(q, k, v, ln, gg, delta, lse),
            "_bwd_in": (gg, delta, lse)}


def flash_errors(got: dict, q, k, v, ln) -> dict:
    """Each kernel's output against its plain version on the same inputs:
    {kernel: (relative error, max abs error)}."""
    from lipreading_tpu_torch.ops import flash_attention as fa

    want, lse_w = fa.flash_fwd_reference(q, k, v, ln, return_lse=True)
    gg, delta, lse = got["_bwd_in"]
    dq_w, dk_w, dv_w = fa.flash_bwd_fused_reference(q, k, v, ln, gg, delta,
                                                    lse)
    pairs = {"fwd": [(got["fwd"][0], want)],
             "fwd_lse": [(got["fwd_lse"][0], want)],
             "fused": list(zip(got["fused"], (dq_w, dk_w, dv_w))),
             "dq": [(got["dq"][0], dq_w)],
             "dkv": list(zip(got["dkv"], (dk_w, dv_w)))}
    errs = {}
    for name, ps in pairs.items():
        errs[name] = (max(rel_err(a, b) for a, b in ps),
                      max(float((a.double() - b.double()).abs().max())
                          for a, b in ps))
    errs["fwd_lse"] = (max(errs["fwd_lse"][0],
                           lse_err(got["fwd_lse"][1], lse_w, ln)),
                       errs["fwd_lse"][1])
    return errs


def flash_work(name: str, B: int, T: int, lengths, elt: int):
    """(FLOPs, bytes) of a flash kernel at the path's H and Dh. The FLOPs
    are units x H Dh T sum(lengths) (queries all T rows, keys the valid
    ones: the kernels skip key tiles past the length), in units of B H T^2
    Dh: 4 forward, 10 fused backward, 6 dq and 8 dk/dv (14 two-pass); the
    bytes read each input once and write each output once."""
    units = {"fwd": 4, "fused": 10, "dq": 6, "dkv": 8}[name]
    flops = units * FLASH_H * FLASH_DH * T * float(sum(lengths))
    x = B * T * FLASH_H * FLASH_DH * elt        # one [B, T, H, Dh] tensor
    rows = B * FLASH_H * T * 4                   # one float32 row vector
    nbytes = {"fwd": 4 * x, "fused": 7 * x + 2 * rows, "dq": 5 * x + 2 * rows,
              "dkv": 6 * x + 2 * rows}[name] + B * 4
    return flops, nbytes


def flash_bound(name: str, B: int, T: int, lengths, elt: int):
    """(ms, bound_by) of a flash kernel at these shapes: its FLOPs over the
    card's dense bf16 peak against its bytes over 3.35 TB/s."""
    from lipreading_tpu_torch.flops import device_peak_flops

    flops, nbytes = flash_work(name, B, T, lengths, elt)
    t_ops = flops / device_peak_flops("bfloat16") * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bare(q, k, v, ln, gg, delta, lse) -> dict:
    """Each flash kernel's C entry as a bare ctypes launch on preallocated
    outputs (no checks, no allocation, no Python wrapper): what the card
    spends on the kernel itself. The fused entry's dq workspace is zeroed
    once, not before each launch: its values do not change the work."""
    import math

    import torch

    from lipreading_tpu_torch import kernels

    lib = kernels.lib()
    B, T, H, Dh = q.shape
    geo = (B, T, H, Dh, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(Dh),
           kernels.stream_ptr(q.device))
    out = torch.empty_like(q)
    ws = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ins = [x.data_ptr() for x in (q, k, v, ln, gg, delta, lse)]
    o, w, gq, gk, gv = (x.data_ptr() for x in (out, ws, dq, dk, dv))
    return {
        "fwd": lambda: lib.flash_fwd(*ins[:4], o, None, *geo),
        "fused": lambda: lib.flash_bwd_fused(*ins, w, gq, gk, gv, *geo),
        "dq": lambda: lib.flash_bwd_dq(*ins, gq, *geo),
        "dkv": lambda: lib.flash_bwd_dkv(*ins, gk, gv, *geo),
        "_keep": (out, ws, dq, dk, dv),   # the outputs live while timed
    }


def sdpa_device_ms(q, k, v, g, ln, iters: int) -> dict:
    """SDPA with the boolean key mask on the same inputs, by device time
    (``device_ms``): the forward alone (no grad), and the training forward
    + backward with the backward's kernels apart (those the forward with
    grad does not launch, or launches for less time) -> {"fwd", "fwd_bwd",
    "bwd": ms, "bwd_kernels": {name: ms}}."""
    import torch
    import torch.nn.functional as F

    T = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # [B, H, T, Dh]
    mask = (torch.arange(T, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]
    leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
    gt = g.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    def fwd_grad():
        F.scaled_dot_product_attention(*leaves, attn_mask=mask)

    def fwd_bwd():
        for x in leaves:
            x.grad = None
        F.scaled_dot_product_attention(*leaves, attn_mask=mask).backward(gt)

    f = device_ms(fwd, iters)[0]
    fg, split_f = device_ms(fwd_grad, iters)
    fb, split_fb = device_ms(fwd_bwd, iters)
    bwd = {n: t - split_f.get(n, 0.0) for n, t in split_fb.items()
           if t - split_f.get(n, 0.0) > 1e-4}
    return {"fwd": f, "fwd_bwd": fb, "bwd": fb - fg, "bwd_kernels": bwd}


def phase_flash_kernels() -> list[dict]:
    """The four flash kernels against their plain versions at the path's
    shape and at a long one, in bf16 and float32, each limit checked against
    the card's reading and a planted fault (the key mask one short), the
    two-pass pair's bytes equal over two launches; device times, bounds and
    SDPA's device time as the yardstick; the auto policy's readings (xla,
    fused and pallas, forward plus backward)."""
    import torch

    from lipreading_tpu_torch import kernels
    from lipreading_tpu_torch.ops import flash_attention as fa

    rows = {}
    for case, B, T, H, Dh, lengths, timed in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype)[6:]
            q, k, v, g, ln = flash_inputs(T + B, B, T, lengths, dtype, H, Dh)
            got = flash_all(q, k, v, ln, g)
            torch.cuda.synchronize()
            errs = flash_errors(got, q, k, v, ln)
            # planted fault: each sample's last valid key masked off
            bad = flash_all(q, k, v, torch.clamp(ln - 1, min=0), g,
                            got["_bwd_in"])
            bad_errs = flash_errors(bad, q, k, v, ln)
            lim = FLASH_LIMITS[dname]
            zero = [b for b, n in enumerate(lengths) if n == 0]
            for name, (e, e_abs) in errs.items():
                log(f"[flash] {case} B={B} T={T} H={H} Dh={Dh} "
                    f"{dname} lengths {list(lengths)}: {name} max|kernel - "
                    f"plain| / max|plain| = {e:.3g} (abs {e_abs:.3g}), limit "
                    f"{lim:g}, planted fault {bad_errs[name][0]:.3g}")
            for name, (e, e_abs) in errs.items():
                check(e <= lim, f"flash {name} {case} {dname}: {e} > {lim}")
                check(bad_errs[name][0] > lim,
                      f"flash {name} {case} {dname}: the planted fault's "
                      f"{bad_errs[name][0]} is within the limit {lim}")
            outs = [x for key, xs in got.items() if key != "_bwd_in"
                    for x in xs[:1 if key == "fwd_lse" else None]]
            for x in outs:
                check(bool(torch.isfinite(x.float()).all()),
                      f"flash {case} {dname}: non-finite output")
                for b in zero:
                    check(x[b].abs().max().item() == 0.0,
                          f"flash {case} {dname}: length 0 is not 0")
            # the two-pass pair writes without atomics: the same bytes again
            again = (fa.flash_bwd_dq(q, k, v, ln, *got["_bwd_in"]),
                     *fa.flash_bwd_dkv(q, k, v, ln, *got["_bwd_in"]))
            same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip((*got["dq"], *got["dkv"]), again))
            log(f"[flash] {case} {dname}: dq, dk, dv of a second launch of "
                f"the two-pass pair {'equal' if same else 'DIFFER from'} the "
                "first, byte for byte")
            check(same, f"flash two-pass {case} {dname}: not reproducible")
            del again
            if dtype != torch.bfloat16 or not timed:
                continue
            iters = 20 if T <= 1024 else 3
            gg, delta, lse = got["_bwd_in"]
            bare = flash_bare(q, k, v, ln, gg, delta, lse)
            dev_ms = {}
            for n in ("fwd", "fused", "dq", "dkv"):
                kernels.check(bare[n](), f"bare {n}")
                dev_ms[n] = time_ms(bare[n], 50 if T <= 1024 else 10)
            ms = {
                "fwd": time_ms(lambda: fa.flash_fwd(q, k, v, ln), iters),
                "fused": time_ms(lambda: fa.flash_bwd_fused(
                    q, k, v, ln, gg, delta, lse), iters),
                "dq": time_ms(lambda: fa.flash_bwd_dq(
                    q, k, v, ln, gg, delta, lse), iters),
                "dkv": time_ms(lambda: fa.flash_bwd_dkv(
                    q, k, v, ln, gg, delta, lse), iters),
            }
            plain_fwd = time_ms(lambda: fa.flash_fwd_reference(q, k, v, ln),
                                max(2, iters // 5))
            plain_bwd = time_ms(lambda: fa.flash_bwd_fused_reference(
                q, k, v, ln, gg, delta, lse), max(2, iters // 5))
            # SDPA with the boolean key mask, by device time
            sd = sdpa_device_ms(q, k, v, g, ln, iters)
            log(f"[flash] {case} bf16 SDPA device time (torch.profiler): "
                f"forward {sd['fwd']:.4f} ms, forward+backward "
                f"{sd['fwd_bwd']:.4f} ms, of which backward {sd['bwd']:.4f} "
                "ms in " + "; ".join(f"{n[:80]} {t:.4f}" for n, t in
                                     sd["bwd_kernels"].items()))
            elt = q.element_size()
            for name in ("fwd", "fused", "dq", "dkv"):
                b_ms, b_by = flash_bound(name, B, T, lengths, elt)
                flops = flash_work(name, B, T, lengths, elt)[0]
                plain = plain_fwd if name == "fwd" else plain_bwd
                lib = sd["fwd"] if name == "fwd" else sd["fwd_bwd"]
                old = CUDA_CORE_PAIR_MS.get((name, T))
                log(f"[flash] {case} bf16 {name}: kernel device "
                    f"{dev_ms[name]:.4f} ms ({flops / dev_ms[name] / 1e9:.1f} "
                    f"TFLOP/s, {b_ms / dev_ms[name]:.1%} of the bound"
                    + (f"; CUDA-core version {old:.4f} ms, "
                       f"{old / dev_ms[name]:.1f}x" if old else "")
                    + f"), wrapper {ms[name]:.4f} ms, plain {plain:.4f} ms, "
                    f"SDPA {'forward' if name == 'fwd' else 'forward+backward'}"
                    f" device {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
                if case == "path":
                    err = max(errs[name][1], errs["fwd_lse"][1]) \
                        if name == "fwd" else errs[name][1]
                    rows[name] = dict(
                        name=FLASH_ROW[name], route="cuda",
                        source=FLASH_SOURCE[name],
                        replaces=FLASH_REPLACES[name], launches=0,
                        max_abs_err=err, ms=dev_ms[name], plain_ms=plain,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                        wrapper_ms=ms[name])
            del bare
            del q, k, v, g, got, bad
            torch.cuda.empty_cache()

    # the auto policy: forward + backward under xla, fused and pallas
    line = []
    for T in FLASH_AUTO_T:
        q, k, v, g, ln = flash_inputs(T, 2, T, (T, 3 * T // 4), torch.bfloat16)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        t = {}
        for bwd in ("xla", "fused", "pallas"):
            def step():
                for x in leaves:
                    x.grad = None
                fa.flash_attention(*leaves, ln, bwd=bwd).backward(g)
            t[bwd] = time_ms(step, 10 if T <= 2048 else 3)
        line.append(f"T={T} xla {t['xla']:.4f} fused {t['fused']:.4f} "
                    f"pallas {t['pallas']:.4f}")
        del q, k, v, g, leaves
        torch.cuda.empty_cache()
    log(f"[flash] auto policy, B=2 H={FLASH_H} Dh={FLASH_DH} bf16, lengths "
        f"(T, 3T/4), forward+backward ms: " + "; ".join(line)
        + f" (auto takes fused from T={fa.AUTO_FUSED_MIN_T})")
    return [rows[n] for n in ("fwd", "fused", "dq", "dkv")]


def render_long(i: int):
    """Long fixture clip ``i`` (LONG_TEXTS[i], about 4 frames a character)
    -> (frames [T, H, W, 3] uint8, text). Runs in a worker process."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from lipreading_tpu_torch.fixtures import make_clip

    c = make_clip(LONG_SEED + i, text=LONG_TEXTS[i])
    return c.frames, c.text


def start_long_clips():
    """Render the long clips in worker processes while the card works."""
    import concurrent.futures as cf
    import multiprocessing as mp

    pool = cf.ProcessPoolExecutor(len(LONG_TEXTS),
                                  mp_context=mp.get_context("spawn"))
    return pool, [pool.submit(render_long, i) for i in range(len(LONG_TEXTS))]


def long_clips(futures):
    """The rendered long clips, zero-padded to LONG_BUCKET -> (frames
    [B, T, H, W, 3] u8, lengths [B], texts)."""
    import numpy as np

    res = [f.result(timeout=600) for f in futures]
    H, W = res[0][0].shape[1:3]
    frames = np.zeros((len(res), LONG_BUCKET, H, W, 3), np.uint8)
    lengths = np.zeros((len(res),), np.int32)
    for b, (f, _) in enumerate(res):
        check(len(f) <= LONG_BUCKET, f"long clip {b}: {len(f)} frames")
        frames[b, :len(f)] = f
        lengths[b] = len(f)
    return frames, lengths, [t for _, t in res]


def reset(wrappers):
    for w in wrappers:
        w.launches = 0


def phase_path_flash(frames, lengths, gpu, long):
    """Serving with model.flash_attention=1: the short clips of [path] and
    the long clips, on the card and on the CPU, one forward kernel launch
    per encoder layer per forward; flash off beside it."""
    import torch

    from lipreading_tpu_torch.infer import greedy_conf
    from lipreading_tpu_torch.metrics import corpus_cer
    from lipreading_tpu_torch.ops import flash_attention as fa
    from lipreading_tpu_torch.ops.preprocess import preprocess_clips
    from lipreading_tpu_torch.text import Vocab

    on = load_port("cuda", FLASH_ON)
    cpu_on = load_port("cpu", FLASH_ON)
    layers = on["cfg"].model.tf_layers
    run_path(frames, lengths, on)                   # warm-up
    torch.cuda.synchronize()
    reset(fa.WRAPPERS)
    hyps, _ = run_path(frames, lengths, on)
    n = fa.flash_fwd.launches
    cpu_hyps, _ = run_path(frames, lengths, cpu_on)
    off_hyps, _ = run_path(frames, lengths, gpu)
    log(f"[path-flash] {len(hyps)} short clips x {frames.shape[1]} frames, "
        f"flash on: {n} forward kernel launches ({layers} layers); card vs "
        f"CPU transcripts {'equal' if hyps == cpu_hyps else 'DIFFER'}; flash "
        f"off on the card {'equal' if hyps == off_hyps else 'differs'} "
        f"(reported, not gated: at bf16 the two are different functions)")
    check(n == layers, f"flash_fwd: {n} launches in one forward, want {layers}")
    check(hyps == cpu_hyps, f"flash card {hyps} != CPU {cpu_hyps}")

    lf, ll, lt = long
    vocab = Vocab()

    def texts(ids, cnt):
        ids, cnt = ids.cpu().numpy(), cnt.cpu().numpy()
        return [vocab.decode(ids[b, :cnt[b]]) for b in range(len(cnt))]

    with torch.inference_mode():
        rois = preprocess_clips(gpu["det"], gpu["ert"],
                                torch.as_tensor(lf, device="cuda"),
                                gpu["cfg"].preprocess)
        lens = torch.as_tensor(ll, device="cuda")
        out = {}
        for name, port in (("on", on), ("off", gpu)):
            greedy_conf(port["model"], port["cfg"], rois, lens)   # warm-up
            torch.cuda.synchronize()
            reset(fa.WRAPPERS)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            ids, cnt, conf, enc = greedy_conf(port["model"], port["cfg"],
                                              rois, lens)
            torch.cuda.synchronize()
            out[name] = dict(
                texts=texts(ids, cnt), ms=(time.perf_counter() - t0) * 1e3,
                launches=fa.flash_fwd.launches,
                peak=torch.cuda.max_memory_allocated() - base)
            check(bool(torch.isfinite(enc.float()).all()),
                  f"long clips, flash {name}: non-finite encoder states")
        t0 = time.perf_counter()
        cids, ccnt, _, _ = greedy_conf(cpu_on["model"], cpu_on["cfg"],
                                       rois.cpu(), lens.cpu())
        cpu_s = time.perf_counter() - t0
    cpu_texts = texts(cids, ccnt)
    on_t, off_t = out["on"]["texts"], out["off"]["texts"]
    for h, o, t in zip(on_t, off_t, lt):
        log(f"[path-flash]   long: {h[:60]!r}... (flash off "
            f"{'same' if h == o else 'differs'}) ref {t[:40]!r}...")
    log(f"[path-flash] {len(lt)} long clips, lengths {ll.tolist()} padded to "
        f"{LONG_BUCKET}, ROIs from the card: greedy_conf flash on "
        f"{out['on']['ms']:.1f} ms, peak {out['on']['peak'] / 2**20:.1f} MiB "
        f"above the resident state, {out['on']['launches']} forward kernel "
        f"launches; flash off {out['off']['ms']:.1f} ms, peak "
        f"{out['off']['peak'] / 2**20:.1f} MiB (host clock, synchronised); "
        f"CER flash on {corpus_cer(on_t, lt):.4f}, off "
        f"{corpus_cer(off_t, lt):.4f}; card vs CPU ({cpu_s:.1f} s) "
        f"transcripts {'equal' if on_t == cpu_texts else 'DIFFER'}")
    check(out["on"]["launches"] == layers,
          f"long clips: {out['on']['launches']} forward launches")
    check(out["off"]["launches"] == 0, "flash off launched the flash kernel")
    check(on_t == cpu_texts, f"long clips: card {on_t} != CPU {cpu_texts}")
    del on, cpu_on, rois


def long_batch(long, cfg):
    """The long clips as one training batch at LONG_BUCKET frames."""
    from lipreading_tpu_torch.data.pipeline import FixtureVideoDataset

    lf, ll, lt = long
    ds = FixtureVideoDataset(0, seed=0, cfg=cfg.data)
    ds.samples = [(lf[b, :ll[b]], lt[b]) for b in range(len(lt))]
    return ds.batch(list(range(len(lt))), LONG_BUCKET)


def flat_grads(tr, batch) -> tuple[float, "torch.Tensor"]:
    """One step's loss and flat gradient (float64, host) without dropout
    or jitter, no update."""
    import torch

    from lipreading_tpu_torch.data.pipeline import video_batch_to_device
    from lipreading_tpu_torch.models.lipreader import compute_loss

    mb = tr.model_batch(video_batch_to_device(batch, tr.device))
    tr.model.zero_grad(set_to_none=True)
    loss, _ = compute_loss(tr.model, tr.cfg, mb, train=True, gen=None)
    loss.backward()
    return loss.item(), torch.cat([p.grad.detach().double().cpu().reshape(-1)
                                   for p in tr.model.parameters()])


def grad_readings(a, b) -> dict:
    """How far gradient ``a`` is from ``b``: ||a - b|| / ||b|| and
    1 - cosine."""
    import torch

    return {"grad_rel": float((a - b).norm() / b.norm()),
            "grad_1_cos": 1.0 - float(torch.nn.functional.cosine_similarity(
                a, b, dim=0))}


def phase_train_flash(gpu, long, rows):
    """Fine-tuning with model.flash_attention=1 on the long clips: each
    backward policy for a few steps with launch counts, one step's gradient
    of pallas and fused against xla (float32) with a planted fault, a fixed
    batch whose loss falls, peak memory with flash on and off."""
    import torch

    from lipreading_tpu_torch.ops import flash_attention as fa

    over = {"model.flash_attention": 1, "data.max_chars": LONG_MAX_CHARS}
    tree, base = release_train_cfg(**over)
    batch = long_batch(long, base)
    layers = base.model.tf_layers
    log(f"[train-flash] batch {tuple(batch.frames.shape[:2])}, lengths "
        f"{batch.frame_lengths.tolist()}, labels {batch.ctc_lengths.tolist()}"
        f" chars; release {RELEASE} warm start, dropout "
        f"{base.model.dropout}, roi_augment {base.train.roi_augment}, "
        f"{base.model.dtype}")
    totals = dict.fromkeys((w.__name__ for w in fa.WRAPPERS), 0)
    for pol in ("xla", "pallas", "fused"):
        cfg = base.override(**{"model.flash_bwd": pol})
        tr = make_trainer(cfg, tree, gpu, "cuda", TRAIN_DIR)
        tr.train_step(batch)                     # warm-up
        torch.cuda.synchronize()
        reset(fa.WRAPPERS)
        ms, losses = [], []
        for _ in range(FLASH_TRAIN_STEPS):
            t0 = time.perf_counter()
            m = tr.train_step(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v) for k, v in m.items()})
        got = {w.__name__: w.launches for w in fa.WRAPPERS}
        want = {"flash_fwd": layers,
                "flash_bwd_fused": layers if pol == "fused" else 0,
                "flash_bwd_dq": layers if pol == "pallas" else 0,
                "flash_bwd_dkv": layers if pol == "pallas" else 0}
        log(f"[train-flash] flash_bwd={pol}: {FLASH_TRAIN_STEPS} steps, "
            f"losses {[round(x['loss'], 4) for x in losses]}, ms per step "
            f"{[round(x, 1) for x in ms]} (host clock, synchronised), "
            f"launches {got}")
        for m in losses:
            check(all(v == v and abs(v) != float("inf") for v in m.values()),
                  f"flash_bwd={pol}: non-finite step metrics {m}")
        for k, v in want.items():
            check(got[k] == v * FLASH_TRAIN_STEPS,
                  f"flash_bwd={pol}: {k} launched {got[k]} times in "
                  f"{FLASH_TRAIN_STEPS} steps, want {v} per step")
            totals[k] += got[k]
        del tr
    for r in rows:
        if r["name"] in totals:
            r["launches"] = totals[r["name"]]

    # one step's gradient, float32 (where flash and the einsum attention
    # are the same function): pallas and fused against xla, and a planted
    # fault (the fused backward with each key mask one short)
    f32 = {"model.dropout": 0.0, "train.roi_augment": 0.0,
           "model.dtype": "float32"}
    grads = {}
    real_fused = fa.flash_bwd_fused

    def short_mask(q, k, v, lengths, *rest):
        return real_fused(q, k, v, torch.clamp(lengths - 1, min=0), *rest)

    short_mask.launches = 0     # the wrapper counts under its module name

    for name, pol in (("xla", "xla"), ("pallas", "pallas"),
                      ("fused", "fused"), ("fault", "fused")):
        cfg = base.override(**dict(f32, **{"model.flash_bwd": pol}))
        tr = make_trainer(cfg, None, gpu, "cuda", TRAIN_DIR)
        fa.flash_bwd_fused = short_mask if name == "fault" else real_fused
        try:
            grads[name] = flat_grads(tr, batch)
        finally:
            fa.flash_bwd_fused = real_fused
        del tr
    ref = grads["xla"][1]
    read = {n: grad_readings(grads[n][1], ref)
            for n in ("pallas", "fused", "fault")}
    log(f"[train-flash] float32 step from the seeded initialisation, loss "
        f"{grads['xla'][0]:.6f} (xla) {grads['pallas'][0]:.6f} (pallas) "
        f"{grads['fused'][0]:.6f} (fused)")
    for k, lim in FLASH_GRAD_LIMITS.items():
        log(f"[train-flash]   {k} against xla: pallas {read['pallas'][k]:.4g}"
            f", fused {read['fused'][k]:.4g}, limit {lim:g}, planted fault "
            f"{read['fault'][k]:.4g}")
    for k, lim in FLASH_GRAD_LIMITS.items():
        for n in ("pallas", "fused"):
            check(read[n][k] <= lim, f"flash_bwd={n} grads vs xla: {k} "
                  f"{read[n][k]} > {lim}")
        check(read["fault"][k] > lim, f"the planted fault's {k} "
              f"{read['fault'][k]} is within the limit {lim}")

    # a fixed batch from the seeded initialisation: its loss must fall
    cfg = base.override(**{"model.flash_bwd": "fused",
                           "train.warmup_steps": 0})
    tr = make_trainer(cfg, None, gpu, "cuda", TRAIN_DIR)
    before = det_loss(tr, batch)
    seen = [float(tr.train_step(batch)["loss"])
            for _ in range(FLASH_FIXED_STEPS)]
    after = det_loss(tr, batch)
    log(f"[train-flash] fixed batch, flash_bwd=fused, seeded "
        f"initialisation: loss without dropout {before:.4f} -> {after:.4f} "
        f"after {FLASH_FIXED_STEPS} steps; step losses "
        + " ".join(f"{v:.4f}" for v in seen))
    check(after < before, f"flash fixed-batch loss did not fall: {before} -> "
          f"{after}")
    del tr

    # peak device memory of one step, flash on (fused) and off
    peak = {}
    for name, o in (("on", {"model.flash_bwd": "fused"}),
                    ("off", {"model.flash_attention": 0})):
        tr = make_trainer(base.override(**o), tree, gpu, "cuda", TRAIN_DIR)
        tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        tr.train_step(batch)
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
        del tr
    log(f"[train-flash] peak device memory of one step above the resident "
        f"state: flash on {peak['on']:.1f} MiB, off {peak['off']:.1f} MiB")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


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
    torch.backends.cudnn.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "matmul and cuDNN TF32 off")
    pool = None
    try:
        pool, long_futures = start_long_clips()
        phase_build()
        smi = nvidia_smi_line()
        log(f"[card] {smi}")
        frames, lengths, texts = fixture_batch()
        gpu = load_port("cuda")
        rows = phase_kernels(frames, lengths, gpu)
        rows += phase_ctc_kernels(gpu["cfg"])
        rows += phase_flash_kernels()
        phase_path(frames, lengths, texts, gpu, rows)
        t0 = time.perf_counter()
        long = long_clips(long_futures)
        log(f"[path-flash] long clips rendered in worker processes "
            f"(waited {time.perf_counter() - t0:.1f} s)")
        phase_path_flash(frames, lengths, gpu, long)
        phase_train(gpu, rows)
        phase_train_flash(gpu, long, rows)
        phase_train_parity(gpu)
    except Exception as e:  # every phase failure ends here, without a result
        import traceback

        traceback.print_exc()
        log(f"chip_smoke: FAIL: {type(e).__name__}: {e}")
        return 1
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
