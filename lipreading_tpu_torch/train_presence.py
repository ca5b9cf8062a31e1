"""Train the face-presence heads on the frozen shipped detector trunks
(counterpart of ``scripts/train_presence.py``):

    python -m lipreading_tpu_torch.train_presence [seed=0] [n_clips=24]
        [variants=default,robust] [out_dir=assets] [device=cuda]

The detector weights stay as they are; only the small two-layer head that
tells a face from no face is trained, with faceless frames and synthetic
extremes as negatives. For each variant it prints the held-out confidence
on face and faceless frames and writes ``presence.npz`` (or
``presence_<variant>.npz``) into ``out_dir`` (by default the shipped
``assets/``, which it overwrites). It runs on the GPU unless ``device=cpu``
is given.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def parse_args(argv: list[str]) -> dict:
    from lipreading_tpu_torch.config import parse_overrides
    from lipreading_tpu_torch.io import ASSETS_DIR

    args = parse_overrides(argv)
    kw = {"seed": int(args.pop("seed", 0)),
          "n_clips": int(args.pop("n_clips", 24)),
          "variants": args.pop("variants", "default,robust").split(","),
          "out_dir": args.pop("out_dir", ASSETS_DIR),
          "device": args.pop("device", "cuda")}
    if args:
        raise SystemExit(f"unknown arguments {sorted(args)}")
    return kw


def negatives(seed: int, H: int, W: int, variation: float) -> np.ndarray:
    """Faceless fixture backgrounds across styles, grayed by a channel mean
    (as the JAX script grays them), then 9 synthetic extremes 4 times each
    -> [M, H, W] float32."""
    from lipreading_tpu_torch.fixtures import render_faceless_frames

    rng = np.random.default_rng(seed)
    negs = [render_faceless_frames(seed + i, 6,
                                   variation=variation if i % 2 else 0.0)
            for i in range(10)]
    neg = np.concatenate(negs).astype(np.float32).mean(-1)
    extremes = np.stack([
        np.zeros((H, W), np.float32),
        np.full((H, W), 255.0, np.float32),
        np.full((H, W), 230.0, np.float32),
        np.full((H, W), 200.0, np.float32),
        np.full((H, W), 160.0, np.float32),
        rng.normal(128, 40, (H, W)).clip(0, 255).astype(np.float32),
        rng.normal(200, 20, (H, W)).clip(0, 255).astype(np.float32),
        np.tile(np.linspace(0, 255, W, dtype=np.float32)[None, :], (H, 1)),
        np.tile(np.linspace(0, 255, H, dtype=np.float32)[:, None], (1, W)),
    ])
    return np.concatenate([neg, np.repeat(extremes, 4, axis=0)])


def max_conf(det, head, frames: np.ndarray, device) -> np.ndarray:
    """Each frame's highest per-cell face-presence probability."""
    import torch

    from lipreading_tpu_torch.ops import detector as det_ops
    from lipreading_tpu_torch.ops.roi import resize_frames

    with torch.no_grad():
        feats, _ = det_ops.forward_features(det, resize_frames(
            torch.as_tensor(frames, device=device), det_ops.INPUT))
        p = torch.sigmoid(det_ops.presence_logits(head, feats))
    return p.reshape(p.shape[0], -1).amax(1).cpu().numpy()


def main(argv: list[str]) -> dict:
    import torch

    from lipreading_tpu_torch.fixtures import make_clips, render_faceless_frames
    from lipreading_tpu_torch.io import load_assets
    from lipreading_tpu_torch.ops import detector as det_ops
    from lipreading_tpu_torch.preproc_training import (
        _collect_frames,
        report_time,
        save_presence,
        train_presence_head,
    )

    kw = parse_args(argv)
    seed, device = kw["seed"], kw["device"]
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to train on the CPU")
    t0 = time.perf_counter()
    os.makedirs(kw["out_dir"], exist_ok=True)
    heads = {}
    for variant in kw["variants"]:
        variation = 0.6 if variant == "robust" else 0.0
        det_np, _ = load_assets(variant=variant)
        clips = make_clips(seed + 31, kw["n_clips"], variation=variation)
        gray, boxes, _ = _collect_frames(clips, stride=3)
        H, W = gray.shape[1:]
        head = train_presence_head(det_np, gray,
                                   negatives(seed, H, W, variation), boxes,
                                   seed=seed, device=device)

        # separation on held-out frames
        test = make_clips(seed + 777_101, 4, variation=variation)
        tg, _, _ = _collect_frames(test, stride=4)
        tneg = np.concatenate(
            [render_faceless_frames(seed + 500 + i, 8, variation=variation)
             for i in range(3)]).astype(np.float32).mean(-1)
        tneg = np.concatenate(
            [tneg, np.full((1, H, W), 255.0, np.float32),
             np.zeros((1, H, W), np.float32),
             np.full((1, H, W), 215.0, np.float32)])
        det = det_ops.params_to_torch(det_np, device)
        head_t = {k: torch.as_tensor(v, device=device) for k, v in head.items()}
        pos_c = max_conf(det, head_t, tg, device)
        neg_c = max_conf(det, head_t, tneg, device)
        print(f"[{variant}] held-out face conf: min={pos_c.min():.3f} "
              f"mean={pos_c.mean():.3f} | faceless conf: "
              f"max={neg_c.max():.3f} mean={neg_c.mean():.3f}")
        sfx = "" if variant == "default" else f"_{variant}"
        path = os.path.join(kw["out_dir"], f"presence{sfx}.npz")
        save_presence(head, path)
        print(f"wrote {path}")
        heads[variant] = head
    report_time("train_presence", t0, device)
    return heads


if __name__ == "__main__":
    main(sys.argv[1:])
