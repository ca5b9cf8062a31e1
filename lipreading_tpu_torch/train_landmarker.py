"""Distil the ERT cascade into the conv landmarker (counterpart of
``scripts/train_landmarker.py``):

    python -m lipreading_tpu_torch.train_landmarker [variant=default]
        [n_clips=48] [steps=4000] [seed=0] [variation=0.0]
        [out=assets/landmarker_conv.npz] [gate_cer=1]
        [gate_release=transformer_hybrid_universal] [mouth_weight=4.0]
        [box_weight=1.0] [roi_loss=0.0] [width=1.0] [device=cuda]

The teacher is the shipped detector and ERT of ``variant``; the targets are
the ERT's own landmarks behind the detector's boxes. ``roi_loss`` > 0 also
distils on the sub-pixel mouth ROIs' pixels. Before saving it prints the
gate metrics on 6 held-out clips: the landmark error against the ERT in
pixels, the share of frames whose rounded mouth box is the ERT's, and the
normalised ROI difference of the two preprocessing paths. ``gate_cer=1``
also decodes 12 held-out clips with the release model behind both paths
(beam 8, char-LM 0.4) and prints the transcript CER of each and their
difference. The weights are saved either way, to ``out`` (by default the
shipped asset, which it overwrites). It runs on the GPU unless
``device=cpu`` is given.
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
    variant = args.pop("variant", "default")
    sfx = "" if variant == "default" else f"_{variant}"
    kw = {"variant": variant,
          "n_clips": int(args.pop("n_clips", 48)),
          "steps": int(args.pop("steps", 4000)),
          "seed": int(args.pop("seed", 0)),
          "variation": float(args.pop("variation", 0.0)),
          "out": args.pop("out", os.path.join(ASSETS_DIR,
                                              f"landmarker_conv{sfx}.npz")),
          "gate_cer": args.pop("gate_cer", "1") in ("1", "true"),
          "gate_release": args.pop("gate_release",
                                   "transformer_hybrid_universal"),
          "mouth_weight": float(args.pop("mouth_weight", 4.0)),
          "box_weight": float(args.pop("box_weight", 1.0)),
          "roi_loss": float(args.pop("roi_loss", 0.0)),
          "width": float(args.pop("width", 1.0)),
          "device": args.pop("device", "cuda")}
    if args:
        raise SystemExit(f"unknown arguments {sorted(args)}")
    return kw


def main(argv: list[str]) -> dict:
    import torch

    from lipreading_tpu_torch.config import PreprocessConfig
    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.io import load_assets
    from lipreading_tpu_torch.ops import landmarker as lmk
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch
    from lipreading_tpu_torch.ops.preprocess import preprocess_clips
    from lipreading_tpu_torch.preproc_training import (
        conv_box_agreement,
        conv_landmarker_error,
        report_time,
        save_landmarker,
        train_conv_landmarker,
    )

    kw = parse_args(argv)
    seed, variation, device = kw["seed"], kw["variation"], kw["device"]
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to train on the CPU")
    t0 = time.perf_counter()
    det_np, ert_np = load_assets(variant=kw["variant"])
    clips = [make_clip(seed * 100_000 + 31 + i, variation=variation)
             for i in range(kw["n_clips"])]
    print(f"distilling ERT ({kw['variant']}) -> conv landmarker on "
          f"{sum(c.num_frames for c in clips)} frames")
    lm = train_conv_landmarker(det_np, ert_np, clips, seed=seed,
                               steps=kw["steps"],
                               mouth_weight=kw["mouth_weight"],
                               box_weight=kw["box_weight"],
                               roi_loss_weight=kw["roi_loss"],
                               width=kw["width"], device=device)

    held = [make_clip(seed * 100_000 + 999_431 + i, variation=variation)
            for i in range(6)]
    report = {"err_px": conv_landmarker_error(lm, det_np, ert_np, held,
                                              device=device),
              "agreement": conv_box_agreement(lm, det_np, ert_np, held,
                                              device=device)}
    print(f"held-out landmark error vs ERT: {report['err_px']:.3f} px")
    print(f"held-out rounded-box agreement vs ERT: "
          f"{report['agreement']:.3f} (box flips are what shift ROI pixels)")

    # downstream: the normalised ROI difference between the two paths
    det = params_to_torch(det_np, device)
    T = min(c.num_frames for c in held[:2])
    stack = torch.as_tensor(np.stack([c.frames[:T] for c in held[:2]]),
                            device=device)
    with torch.no_grad():
        roi_e = preprocess_clips(det, model_to_torch(ert_np, device), stack,
                                 PreprocessConfig())
        roi_c = preprocess_clips(det, lmk.params_to_torch(lm, device), stack,
                                 PreprocessConfig(landmarker="conv"))
    d = (roi_e - roi_c).abs()
    print(f"downstream ROI |diff|: mean {float(d.mean()):.4f} max "
          f"{float(d.max()):.4f} (normalized units; 1 gray level = "
          f"{1/255/0.165:.4f})")

    if kw["gate_cer"]:
        report["cers"] = gate_transcript_cer(
            lm, det_np, ert_np, kw["gate_release"], variation, seed,
            device=device)[0]

    os.makedirs(os.path.dirname(os.path.abspath(kw["out"])), exist_ok=True)
    save_landmarker(lm, kw["out"])
    print(f"saved {kw['out']}")
    report_time("train_landmarker", t0, device)
    return report


def gate_transcript_cer(lm, det_np, ert_np, release, variation, seed,
                        n_clips=12, device="cuda"):
    """The transcript gate: the release model's corpus CER behind the conv
    path and behind the ERT path on held-out clips (beam 8, char-LM 0.4)
    -> ({"ert": CER, "conv": CER}, {"ert": hyps, "conv": hyps}), or
    (None, None) where the release is not in ``assets/``."""
    import torch

    from lipreading_tpu_torch.config import PreprocessConfig
    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.infer import transcribe
    from lipreading_tpu_torch.io import ASSETS_DIR, load_release_model
    from lipreading_tpu_torch.metrics import corpus_cer
    from lipreading_tpu_torch.ops import landmarker as lmk
    from lipreading_tpu_torch.ops.detector import params_to_torch
    from lipreading_tpu_torch.ops.ert import model_to_torch
    from lipreading_tpu_torch.ops.preprocess import preprocess_padded

    if not all(os.path.exists(os.path.join(ASSETS_DIR, f"{release}.{ext}"))
               for ext in ("msgpack", "json")):
        print(f"# transcript gate skipped: no release asset {release!r}")
        return None, None
    model, cfg = load_release_model(release, device)
    det = params_to_torch(det_np, device)
    paths = {"ert": (model_to_torch(ert_np, device), PreprocessConfig()),
             "conv": (lmk.params_to_torch(lm, device),
                      PreprocessConfig(landmarker="conv"))}
    cers, hyps = {}, {}
    for name, (landmarker, pcfg) in paths.items():
        hyps[name], refs = [], []
        for i in range(n_clips):
            clip = make_clip(seed * 100_000 + 717_171 + i,
                             variation=variation)
            rois = preprocess_padded(det, landmarker, clip.frames, pcfg)
            T = rois.shape[0]
            P = -(-T // 64) * 64
            rois = np.pad(rois, ((0, P - T), (0, 0), (0, 0)))
            with torch.no_grad():
                hyps[name].append(transcribe(
                    model, cfg, rois[None], np.asarray([T], np.int32),
                    beam=8, lm_weight=0.4)[0])
            refs.append(clip.text)
        cers[name] = corpus_cer(hyps[name], refs)
    delta = cers["conv"] - cers["ert"]
    print(f"transcript gate ({release}, {n_clips} clips, "
          f"variation={variation}): CER ert={cers['ert']:.4f} "
          f"conv={cers['conv']:.4f} delta={delta:+.4f} "
          f"{'PASS' if delta <= 0.005 else 'FAIL (>0.005)'}")
    return cers, hyps


if __name__ == "__main__":
    main(sys.argv[1:])
