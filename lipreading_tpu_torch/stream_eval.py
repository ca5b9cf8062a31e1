"""The styled multi-clip stream ladder (counterpart of
``scripts/stream_eval.py``): for each release, the CER of two styled
clips streamed back to back against the per-clip decode floor.

    python -m lipreading_tpu_torch.stream_eval \\
        [releases=universal,universal4] [variation=0.6] [pairs=3] [beam=4] \\
        [lm_weight=0.4] [window=64] [assets_variant=robust] [tracked=1] \\
        [device=cuda]

Stream p is ``make_clip(33001 + 100 p)`` then ``make_clip(33002 + 100 p)``
at ``variation``. Each prints the floor (both clips decoded alone, padded
to the longer one, through ``preprocess_clips`` and ``transcribe``), plain
streaming (untracked) and, with ``tracked=1``, tracked streaming with the
hard-cut flush; then each release's means.
"""

from __future__ import annotations

import sys


def stream_text(model, cfg, prep, frames, window: int, beam: int,
                lm_weight: float, tracked: bool) -> str:
    """``frames`` in chunks of 8 through ``StreamingTranscriber`` (a decode
    every 12 frames) -> the final transcript."""
    from lipreading_tpu_torch.streaming import StreamingTranscriber

    det, lmk, presence = prep
    st = StreamingTranscriber(model, cfg, det, lmk, window=window,
                              decode_every=12, chunk_bucket=8, beam=beam,
                              lm_weight=lm_weight, tracked=tracked,
                              presence=presence if tracked else None)
    for lo in range(0, frames.shape[0], 8):
        st.feed(frames[lo:lo + 8])
    return st.finish()


def main(argv: list[str]) -> dict:
    from lipreading_tpu_torch.config import parse_overrides

    args = parse_overrides(argv)
    releases = str(args.get("releases", "universal,universal4")).split(",")
    variation = float(args.get("variation", 0.6))
    pairs = int(args.get("pairs", 3))
    beam = int(args.get("beam", 4))
    lm_weight = float(args.get("lm_weight", 0.4))
    window = int(args.get("window", 64))
    assets_variant = str(args.get("assets_variant", "robust"))
    tracked = bool(int(args.get("tracked", 1)))
    device = str(args.get("device", "cuda"))

    import numpy as np
    import torch

    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.infer import transcribe
    from lipreading_tpu_torch.io import load_preprocessors, load_release_model
    from lipreading_tpu_torch.metrics import cer
    from lipreading_tpu_torch.ops.preprocess import preprocess_clips

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    streams = [(33001 + 100 * p, 33002 + 100 * p) for p in range(pairs)]
    out = {}
    for rel_name in releases:
        try:
            model, cfg = load_release_model(
                f"transformer_hybrid_{rel_name}", device=device)
        except FileNotFoundError:
            print(f"{rel_name}: release not found, skipped")
            continue
        prep = load_preprocessors(cfg.preprocess.landmarker, assets_variant,
                                  tracked=True, device=device)
        rows = []
        for seeds in streams:
            clips = [make_clip(s, cfg.data, variation=variation)
                     for s in seeds]
            frames = np.concatenate([c.frames for c in clips])
            truth = " ".join(c.text for c in clips)
            T = max(c.frames.shape[0] for c in clips)
            batch = np.zeros((len(clips), T) + clips[0].frames.shape[1:],
                             clips[0].frames.dtype)
            for i, c in enumerate(clips):
                batch[i, :c.frames.shape[0]] = c.frames
            with torch.inference_mode():     # default preprocessing, as
                rois = preprocess_clips(        # the JAX script's floor
                    prep[0], prep[1], torch.as_tensor(batch, device=device))
            hyps = transcribe(model, cfg, rois,
                              np.asarray([c.frames.shape[0] for c in clips]),
                              beam=beam, lm_weight=lm_weight)
            floor = cer(" ".join(hyps), truth)
            plain = cer(stream_text(model, cfg, prep, frames, window, beam,
                                    lm_weight, False), truth)
            trk = (cer(stream_text(model, cfg, prep, frames, window, beam,
                                   lm_weight, True), truth)
                   if tracked else None)
            rows.append((seeds, floor, plain, trk))
            print(f"{rel_name} {seeds}: floor={floor:.4f} plain={plain:.4f}"
                  + (f" tracked+cutflush={trk:.4f}" if trk is not None
                     else ""), flush=True)
        f = np.mean([r[1] for r in rows])
        pl = np.mean([r[2] for r in rows])
        print(f"{rel_name} MEAN over {len(rows)} streams: floor={f:.4f} "
              f"plain={pl:.4f}"
              + (f" tracked+cutflush={np.mean([r[3] for r in rows]):.4f}"
                 if tracked else ""), flush=True)
        out[rel_name] = rows
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
