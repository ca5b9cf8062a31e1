"""Batch-knee sweep of the decode operating points (counterpart of
``scripts/bench_decode_knee.py``):

    python -m lipreading_tpu_torch.bench_decode_knee \\
        [sections=flagship,cascade,greedy] [Bs=16,32,64,128] [reps=5] \\
        [clips=128] [device=cuda]

Sections, each over fixture clips ``make_clip(100 + i)`` (rendered on the
host before anything is timed) stacked to B rows:

* ``flagship``: the ``transformer_hybrid`` release's joint beam 8 with
  char-LM 0.4 (``infer.transcribe``) on clip-aligned T 64, from ROIs
  preprocessed once before the timing;
* ``cascade``: ``infer.transcribe_cascade`` (beam 8, LM 0.4) on whole clips
  at the 96-frame bucket, with the share of clips rescored;
* ``greedy``: frames -> ``preprocess_frames`` -> the ``bigru_ctc`` release
  -> CTC greedy ids at T 64, one call end to end. The JAX script loads its
  package's default release here, which is ``bigru_ctc``; the port's
  default is another, so the name is given.

It prints one JSON line per (section, B) with the JAX keys (``section``,
``B``, ``ms_per_call``, ``fps``, and ``rescored_frac`` for the cascade)
and ``device``. Each time is ``profiling.Timer``'s: the wall clock over
``reps`` calls after one warm-up call, the device synchronised before each
reading.
"""

from __future__ import annotations

import json
import sys

SECTIONS = ("flagship", "cascade", "greedy")
GREEDY_RELEASE = "bigru_ctc"    # the JAX package's default release


def stack_clips(clips, B: int, Tc: int):
    """B rows of the clips (cycled), each cut or zero-padded to Tc frames
    -> (frames [B, Tc, H, W, 3] uint8, lengths [B])."""
    import numpy as np

    sh = clips[0].frames.shape[1:]
    st = np.zeros((B, Tc) + sh, np.uint8)
    ln = np.zeros((B,), np.int32)
    for i in range(B):
        f = clips[i % len(clips)].frames[:Tc]
        st[i, : f.shape[0]] = f
        ln[i] = f.shape[0]
    return st, ln


def knee(sections=SECTIONS, Bs=(16, 32, 64, 128), reps: int = 5,
         n_clips: int = 128, device: str = "cuda",
         release: str = "transformer_hybrid", log=None) -> list[dict]:
    """One row per (section, B): the JAX keys, ``device`` and the kernels
    each section's timed calls launched (``launches``)."""
    import torch

    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.infer import transcribe, transcribe_cascade
    from lipreading_tpu_torch.io import load_preprocessors, load_release_model
    from lipreading_tpu_torch.models.lipreader import ctc_logits, encode
    from lipreading_tpu_torch.ops.decode import ctc_greedy_ids
    from lipreading_tpu_torch.ops.preprocess import (
        preprocess_clips,
        preprocess_frames,
    )
    from lipreading_tpu_torch.profiling import (
        Timer,
        device_label,
        entry_device,
        launch_counts,
        launches_since,
    )

    dev = entry_device(device)
    log = log or (lambda s: None)
    label = device_label(dev)
    det, ert, _ = load_preprocessors("ert", device=dev)
    need = min(n_clips, max(Bs))
    print(f"# rendering {need} fixture clips...", file=sys.stderr)
    clips = [make_clip(100 + i) for i in range(need)]
    print(f"# device={label}", file=sys.stderr)
    rows = []

    def emit(row, before):
        row["device"] = label
        row["launches"] = launches_since(before)
        rows.append(row)
        log(json.dumps({k: v for k, v in row.items() if k != "launches"}))

    if "flagship" in sections or "cascade" in sections:
        fmodel, fcfg = load_release_model(release, device=dev)

    def rois_of(B, Tc):
        st, ln = stack_clips(clips, B, Tc)
        with torch.inference_mode():
            rois = preprocess_clips(det, ert, torch.from_numpy(st).to(dev),
                                    fcfg.preprocess)
        return rois, torch.from_numpy(ln).to(dev), int(ln.sum())

    if "flagship" in sections:
        for B in Bs:
            before = launch_counts()
            rois, lens, nfr = rois_of(B, 64)
            dt = Timer(lambda: transcribe(fmodel, fcfg, rois, lens, beam=8,
                                          lm_weight=0.4),
                       warmup=1).measure(reps=reps)
            emit({"section": "flagship", "B": B,
                  "ms_per_call": round(dt * 1e3, 1),
                  "fps": round(nfr / dt, 1)}, before)

    if "cascade" in sections:
        for B in Bs:
            before = launch_counts()
            rois, lens, nfr = rois_of(B, 96)
            n_res = []

            def call():
                _, nr = transcribe_cascade(fmodel, fcfg, rois, lens, beam=8,
                                           lm_weight=0.4)
                n_res.append(nr)

            dt = Timer(call, warmup=1).measure(reps=reps)
            emit({"section": "cascade", "B": B,
                  "ms_per_call": round(dt * 1e3, 1),
                  "fps": round(nfr / dt, 1),
                  "rescored_frac": round(sum(n_res[1:]) / (reps * B), 3)},
                 before)

    if "greedy" in sections:
        model, cfg = load_release_model(GREEDY_RELEASE, device=dev)
        Tc = 64
        R = cfg.preprocess.roi_size
        for B in Bs:
            st, _ = stack_clips(clips, B, Tc)
            lens = torch.full((B,), Tc, dtype=torch.int32, device=dev)
            flat = torch.from_numpy(st).to(dev)

            @torch.inference_mode()
            def e2e(fr):
                rois = preprocess_frames(
                    det, ert, fr.reshape(-1, *fr.shape[2:]), cfg.preprocess)
                enc = encode(model, cfg, rois.reshape(B, Tc, R, R), lens)
                return ctc_greedy_ids(ctc_logits(model, enc), lens)

            before = launch_counts()
            dt = Timer(e2e, warmup=1).measure(flat, reps=reps)
            emit({"section": "greedy", "B": B,
                  "ms_per_call": round(dt * 1e3, 1),
                  "fps": round(B * Tc / dt, 1)}, before)
    return rows


def main(argv: list[str], release: str = "transformer_hybrid"
         ) -> list[dict]:
    from lipreading_tpu_torch.config import parse_overrides

    args = parse_overrides(argv)
    sections = str(args.pop("sections", ",".join(SECTIONS))).split(",")
    Bs = [int(x) for x in str(args.pop("Bs", "16,32,64,128")).split(",")]
    reps = int(args.pop("reps", 5))
    n_clips = int(args.pop("clips", 128))
    device = str(args.pop("device", "cuda"))
    if args:
        raise SystemExit(f"unknown args: {sorted(args)}")
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"unknown sections {sorted(unknown)}; have "
                         f"{list(SECTIONS)}")
    return knee(sections, Bs, reps, n_clips, device, release,
                log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main(sys.argv[1:])
