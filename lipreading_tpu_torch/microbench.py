"""Kernel microbenchmarks (counterpart of ``scripts/microbench.py``):

    python -m lipreading_tpu_torch.microbench [frames=384] [reps=20] \\
        [device=cuda]

Each op is timed by ``profiling.Timer`` (the wall clock, the device
synchronised before each reading) over ``reps`` calls after warm-up, and
its ms and items/s printed, in the JAX script's order:

* grayscale, detector, the ERT cascade, the ROI kernel and its plain
  version, and the whole preprocess, over ``frames`` frames of
  ``make_clip(100 + i)``;
* the CTC loss forward and gradient, kernel and plain, and CTC greedy
  decode, kernel and plain, at B 16, T 128, V 31, L 40 (from
  ``default_rng(0)``);
* encoder self-attention at T 128, 512 and 1024 (B 8, H 4, Dh 64, bf16):
  the plain version, which holds [B, H, T, T], against the flash kernel.

Row names follow the JAX script's with ``_pallas`` as ``_kernel`` and
``_xla`` / ``_scan`` as ``_plain``. A ``_plain`` row calls the plain
PyTorch version itself and launches no kernel; with ``device=cpu`` every
row runs plain. Each row also records the kernels it launched
(``profiling.launches_since``).
"""

from __future__ import annotations

import sys

ATTN_T = (128, 512, 1024)


def microbench(frames: int = 384, reps: int = 20, device: str = "cuda"
               ) -> list[dict]:
    """The table's rows: {"op", "ms", "items_per_s", "launches"}."""
    import numpy as np
    import torch

    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.io import load_preprocessors
    from lipreading_tpu_torch.ops import ctc as ctc_ops
    from lipreading_tpu_torch.ops import decode as dec_ops
    from lipreading_tpu_torch.ops import detector as det_ops
    from lipreading_tpu_torch.ops import ert as ert_ops
    from lipreading_tpu_torch.ops import flash_attention as fa
    from lipreading_tpu_torch.ops import roi as roi_ops
    from lipreading_tpu_torch.ops.preprocess import (
        mouth_boxes_from_landmarks,
        preprocess_frames,
    )
    from lipreading_tpu_torch.profiling import (
        Timer,
        entry_device,
        launch_counts,
        launches_since,
    )

    dev = entry_device(device)
    n = frames
    det, ert, _ = load_preprocessors("ert", device=dev)
    clips = [make_clip(100 + i) for i in range(max(1, n // 56))]
    fr = np.concatenate([c.frames for c in clips])[:n]
    n = fr.shape[0]
    with torch.inference_mode():
        fj = torch.from_numpy(fr).to(dev)
        gray = roi_ops.grayscale(fj)
        boxes = det_ops.detect(det, gray)
        lms = ert_ops.predict_batch(ert, gray, boxes)
        mb = mouth_boxes_from_landmarks(lms, 0.3, 160, 160)

    rng = np.random.default_rng(0)
    B, T, V, L = 16, 128, 31, 40
    logits = torch.from_numpy(
        rng.normal(0, 2, (B, T, V)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(
        rng.integers(3, V, (B, L)).astype(np.int32)).to(dev)
    in_lens = torch.from_numpy(
        rng.integers(90, T + 1, (B,)).astype(np.int32)).to(dev)
    lab_lens = torch.from_numpy(
        rng.integers(1, 20, (B,)).astype(np.int32)).to(dev)
    ctc_args = (labels, in_lens, lab_lens)

    def grad_of(loss_fn):
        def f(x):
            x = x.detach().requires_grad_(True)
            return torch.autograd.grad(loss_fn(x, *ctc_args).sum(), x)[0]
        return f

    def inference(fn):
        def f(*a):
            with torch.inference_mode():
                return fn(*a)
        return f

    rows = [
        ("grayscale", roi_ops.grayscale, (fj,), n),
        ("detector", lambda g: det_ops.detect(det, g), (gray,), n),
        ("ert_cascade", lambda g, b: ert_ops.predict_batch(ert, g, b),
         (gray, boxes), n),
        ("roi_kernel", lambda g, m: roi_ops.sample_rois(g, m, 96),
         (gray, mb), n),
        ("roi_plain", lambda g, m: roi_ops.sample_rois_reference(g, m, 96),
         (gray, mb), n),
        ("preprocess_full", lambda f: preprocess_frames(det, ert, f),
         (fj,), n),
        ("ctc_fwd_plain",
         lambda x: ctc_ops.ctc_loss(x, *ctc_args).sum(), (logits,), B),
        ("ctc_fwd_kernel",
         lambda x: ctc_ops.ctc_loss_lattice(x, *ctc_args).sum(),
         (logits,), B),
        ("ctc_grad_plain", grad_of(ctc_ops.ctc_loss), (logits,), B),
        ("ctc_grad_kernel", grad_of(ctc_ops.ctc_loss_lattice), (logits,), B),
        ("ctc_decode_plain",
         lambda x: dec_ops.ctc_greedy_ids_reference(x, in_lens),
         (logits,), B),
        ("ctc_decode_kernel", lambda x: dec_ops.ctc_greedy_ids(x, in_lens),
         (logits,), B),
    ]
    for Ta in ATTN_T:
        Ba, H, Dh = 8, 4, 64
        qkv = [torch.from_numpy(rng.normal(0, 1, (Ba, Ta, H, Dh))
                                .astype(np.float32)).to(dev, torch.bfloat16)
               for _ in range(3)]
        lens = torch.from_numpy(
            rng.integers(Ta // 2, Ta + 1, (Ba,)).astype(np.int32)).to(dev)
        rows.append((f"attn_plain_T{Ta}", fa.reference_attend,
                     (*qkv, lens), Ba * Ta))
        rows.append((f"attn_flash_T{Ta}", fa.flash_attention,
                     (*qkv, lens), Ba * Ta))

    out = []
    for name, fn, fargs, items in rows:
        if not name.startswith("ctc_grad"):
            fn = inference(fn)
        before = launch_counts()
        t = Timer(fn).measure(*fargs, reps=reps)
        out.append({"op": name, "ms": t * 1e3, "items_per_s": items / t,
                    "launches": launches_since(before)})
    return out


def main(argv: list[str]) -> list[dict]:
    from lipreading_tpu_torch.config import parse_overrides
    from lipreading_tpu_torch.profiling import device_label, entry_device

    args = parse_overrides(argv)
    n = int(args.pop("frames", 384))
    reps = int(args.pop("reps", 20))
    device = str(args.pop("device", "cuda"))
    if args:
        raise SystemExit(f"unknown args: {sorted(args)}")
    dev = entry_device(device)
    print(f"device={device_label(dev)} frames={n} reps={reps}", flush=True)
    rows = microbench(n, reps, device)
    print(f"{'op':18s} {'ms':>9s} {'items/s':>12s}")
    for r in rows:
        print(f"{r['op']:18s} {r['ms']:9.3f} {r['items_per_s']:12.0f}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
