"""Fused fine-tuning on the GPU (counterpart of ``scripts/train.py`` with
``fused=1``):

    python -m lipreading_tpu_torch.train preset=transformer-patchify \\
        workdir=runs/ft init_from=transformer_hybrid_universal4 steps=10 \\
        [n_clips=24] [data_seed=1] [resume=1] [device=cuda] [key=value ...]

Raw uint8 fixture frames (rendered from ``data_seed``) -> on-device
detection, landmarks and ROIs -> the model's hybrid loss -> backward ->
AdamW, ``steps`` times (default ``train.total_steps``), then a checkpoint in
``workdir/ckpt``. ``init_from=`` warm-starts the parameters from a release in
``assets/`` or from a checkpoint ``.msgpack`` (fresh optimizer, step 0);
``resume=1`` continues from the latest checkpoint in ``workdir``. Any dotted
config field can be overridden (``train.learning_rate=1e-4``). It runs on
the GPU unless ``device=cpu`` is given.

Not ported yet, each refused with its slice: ``fused=0`` (the dataview
path), ``tracked``, ``preprocess.landmarker=conv``, ``variation`` and
``train.remat=1``; and evaluation on held-out clips, which needs the joint
beam, so a run that would reach ``train.eval_every`` stops before its first
step (``Trainer.fit`` refuses it).
"""

from __future__ import annotations

import os
import sys

SLICE = {
    "fused": "fused=0 trains from a prebuilt ROI dataview (data/dataset.py, "
             "data/dataview.py), a later slice of the port (ROADMAP queue 1 "
             "item 9)",
    "tracked": "the tracked fused step is a later slice of the port "
               "(ROADMAP queue 1 item 6)",
    "variation": "appearance-varied corpora and the robust assets are a "
                 "later slice of the port (ROADMAP queue 1 item 12)",
}


def _refuse(key: str, value: str) -> None:
    raise NotImplementedError(f"{key}={value}: {SLICE[key]}")


def main(argv: list[str]) -> dict:
    from lipreading_tpu_torch.config import parse_overrides, preset

    args = parse_overrides(argv)
    if args.get("fused", "1") not in ("1", "true") or "dataview" in args:
        _refuse("fused", args.get("fused", "0"))
    args.pop("fused", None)
    if args.get("tracked", "0") not in ("0", "false"):
        _refuse("tracked", args["tracked"])
    args.pop("tracked", None)
    for key in ("variation", "variation_max", "assets_variant"):
        if key in args:
            _refuse("variation", f"{key}={args[key]}")
    cfg = preset(args.pop("preset", "transformer-patchify"))
    workdir = args.pop("workdir", f"runs/{cfg.name}")
    steps = int(args.pop("steps", 0)) or None
    resume = args.pop("resume", "0") in ("1", "true")
    init_from = args.pop("init_from", None)
    n_clips = int(args.pop("n_clips", 24))
    data_seed = int(args.pop("data_seed", 1))
    device = args.pop("device", "cuda")
    if args:
        cfg = cfg.override(**args)
    if cfg.preprocess.landmarker == "conv":
        raise NotImplementedError(
            "preprocess.landmarker=conv: the conv landmarker is a later "
            "slice of the port (ROADMAP queue 1 item 6)")
    if cfg.train.remat:
        raise NotImplementedError(
            "train.remat=1: rematerialising the frontend is a later slice "
            "of the port (ROADMAP queue 1 item 9)")

    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to train on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False

    from lipreading_tpu_torch.data.pipeline import (
        FixtureVideoDataset,
        VideoBatchIterator,
    )
    from lipreading_tpu_torch.io import load_assets, load_release
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch
    from lipreading_tpu_torch.train.checkpoint import load_checkpoint
    from lipreading_tpu_torch.train.loop import FusedTrainer

    det_np, ert_np = load_assets()
    trainer = FusedTrainer(cfg, workdir, params_to_torch(det_np, device),
                           model_to_torch(ert_np, device), device=device)
    if init_from:
        if os.path.exists(init_from):
            _, p0, _, _, _ = load_checkpoint(init_from)
            trainer.warm_start(p0)
            print(f"warm-started params from {init_from}")
        else:
            try:
                tree, _ = load_release(init_from)
            except FileNotFoundError:
                raise SystemExit(f"init_from: no release asset {init_from!r}")
            trainer.warm_start(tree)
            print(f"warm-started params from assets/{init_from}")
    it_state = trainer.restore() if resume else {}
    if it_state:
        print(f"resumed at step {trainer.step}")
    ds = FixtureVideoDataset(n_clips, seed=data_seed, cfg=cfg.data)
    it = (VideoBatchIterator.from_state(ds, cfg.data.batch_size, it_state)
          if it_state else
          VideoBatchIterator(ds, cfg.data.batch_size, seed=cfg.train.seed))
    print(f"training {cfg.name} ({cfg.encoder}/{cfg.decoder}) on {len(ds)} "
          f"samples, device {trainer.device}")
    last = trainer.fit(it, steps=steps)
    trainer.save(it)
    print("final:", last)
    return last


if __name__ == "__main__":
    main(sys.argv[1:])
