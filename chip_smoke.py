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
4. drive the main path: fixture clips at 160x160 -> ``preprocess_clips``
   -> the released ``transformer_hybrid_universal4`` model at full width ->
   ``greedy_conf`` -> transcripts, with every kernel's launch count set to 0
   just before and read just after; the transcripts must equal those of the
   same run on the CPU (plain versions there);
5. print the kernels' JSON line, the ``nvidia-smi`` line and, last,
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
    for row in rows:
        row["launches"] = wrappers[row["name"]].launches
    log(f"[path] frames -> transcripts: {dt * 1e3:.1f} ms host clock "
        f"({B * T / dt:.0f} padded frames/s), launches "
        + ", ".join(f"{r['name']}={r['launches']}" for r in rows))
    for r in rows:
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
        phase_path(frames, lengths, texts, gpu, rows)
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
