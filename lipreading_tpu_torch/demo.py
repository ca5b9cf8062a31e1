"""One video to its transcript (counterpart of ``scripts/demo.py``, the
workflow's demo step):

    python -m lipreading_tpu_torch.demo [preset=bigru-ctc] \\
        [workdir=runs/<preset>] [video=clip.mp4 | fixture_seed=3] [beam=] \\
        [release=bigru_ctc] [lm_weight=0.0] [lexicon=0] [stream=0] \\
        [gap_flush=25] [cut_flush=8.0] [tracked=] [assets_variant=] \\
        [device=cuda] [key=value ...]

The model: the latest checkpoint of ``workdir`` with the config the trainer
wrote there (``preset=`` where there is none), else the release
``release=`` with any ``key=value`` overrides applied to its config, else
random weights (with a warning). Three modes:

* untracked batch (the default for fixture clips): ``preprocess_padded``,
  the ROIs padded to a multiple of 64, ``transcribe``;
* tracked batch (``tracked=1``, the default for ``video=``): the presence
  head flags frames without a confident face, which are skipped, and
  ``transcribe_segmented`` decodes by shot (runs of ``gap_flush`` no-face
  frames, and hard cuts of the frame signature unless ``cut_flush=0``);
* ``stream=N``: the frames in chunks of N through ``StreamingTranscriber``
  (window 64, a decode every 16 frames), the transcript after each chunk.

A ``*_robust`` release pairs with the robust preprocessing assets unless
``assets_variant=`` says otherwise. It runs on the GPU unless
``device=cpu`` is given; ``video=`` needs OpenCV.
"""

from __future__ import annotations

import os
import sys
import time


def load_model(cfg, workdir: str, release: str, overrides: dict, device):
    """The model to run, on ``device`` -> (model, cfg)."""
    from lipreading_tpu_torch.io import from_jax_params, load_release
    from lipreading_tpu_torch.models.lipreader import LipReader, init_model
    from lipreading_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )

    path = latest_checkpoint(os.path.join(workdir, "ckpt"))
    tree = None
    if path:
        _, tree, _, _, _ = load_checkpoint(path)
    else:
        try:
            # the release's config replaces cfg: the overrides apply to it
            tree, cfg = load_release(release, overrides=overrides or None)
            print(f"using release checkpoint assets/{release}.msgpack")
        except FileNotFoundError:
            print("WARNING: no checkpoint; transcribing with random weights")
    if tree is None:
        return init_model(cfg, device=device).eval(), cfg
    model = LipReader(cfg)
    model.load_state_dict(from_jax_params(tree, cfg))
    return model.to(device).eval(), cfg


def load_prep(cfg, assets_variant: str, tracked: bool, device):
    """(detector, landmarker, presence head or None) on ``device``: the
    landmarker is the ERT or, with ``preprocess.landmarker=conv``, the
    conv landmarker of ``assets_variant``; the presence head is the robust
    one for the robust assets, else the default one."""
    from lipreading_tpu_torch.io import load_preprocessors, load_presence
    from lipreading_tpu_torch.ops.detector import params_to_torch

    try:
        det, lmk, _ = load_preprocessors(cfg.preprocess.landmarker,
                                         assets_variant, device=device)
    except FileNotFoundError:
        raise SystemExit(
            f"preprocess.landmarker=conv but no conv landmarker asset for "
            f"variant {assets_variant!r} (scripts/train_landmarker.py)")
    presence = None
    if tracked:
        pres = load_presence(variant=assets_variant
                             if assets_variant == "robust" else "default")
        if pres is None:
            raise SystemExit(
                "tracked preprocessing (the default for real video) needs "
                "the face-presence head asset (scripts/train_presence.py); "
                "pass tracked=0 to force the unguarded single-box path")
        presence = params_to_torch(pres, device)
    return det, lmk, presence


def main(argv: list[str]) -> str:
    """Run the demo; returns the transcript."""
    from lipreading_tpu_torch.config import (
        load_workdir_config,
        parse_overrides,
        preset,
    )

    args = parse_overrides(argv)
    preset_name = args.pop("preset", "bigru-ctc")
    workdir = args.pop("workdir", f"runs/{preset_name}")
    cfg = load_workdir_config(workdir) or preset(preset_name)
    video = args.pop("video", None)
    fixture_seed = int(args.pop("fixture_seed", 3))
    beam = int(args.pop("beam", cfg.train.beam_width))
    release = args.pop("release", "bigru_ctc")
    lm_weight = float(args.pop("lm_weight", 0.0))
    use_lexicon = args.pop("lexicon", "0") in ("1", "true")
    stream = int(args.pop("stream", 0))          # > 0: chunk size
    gap_flush = int(args.pop("gap_flush", 25))
    cut_flush = float(args.pop("cut_flush", 8.0))
    tracked = args.pop("tracked", "1" if video is not None else "0") \
        in ("1", "true")
    assets_variant = args.pop(
        "assets_variant", "robust" if release.endswith("_robust") else "default")
    device = args.pop("device", "cuda")
    overrides = dict(args)
    if overrides:
        cfg = cfg.override(**overrides)

    import numpy as np
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to run the demo on "
                         "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    if video:
        from lipreading_tpu_torch.data.video import decode_video

        frames, _ = decode_video(video)
        ref = None
    else:
        from lipreading_tpu_torch.fixtures import make_clip

        clip = make_clip(fixture_seed, cfg.data)
        frames, ref = clip.frames, clip.text
    model, cfg = load_model(cfg, workdir, release, overrides, device)
    det, lmk, presence = load_prep(cfg, assets_variant, tracked, device)

    if stream:
        from lipreading_tpu_torch.streaming import StreamingTranscriber

        st = StreamingTranscriber(model, cfg, det, lmk, window=64,
                                  decode_every=16, beam=beam,
                                  lm_weight=lm_weight, presence=presence,
                                  tracked=tracked, gap_flush=gap_flush,
                                  cut_flush=cut_flush)
        t0 = time.perf_counter()
        for lo in range(0, len(frames), stream):
            hyp = st.feed(frames[lo:lo + stream])
            print(f"  t={lo + stream:4d}: {hyp!r}")
        hyp = st.finish()
        dt = time.perf_counter() - t0
        _print_result(hyp, ref)
        print(f"{len(frames)} frames streamed in {dt:.2f}s")
        return hyp

    from lipreading_tpu_torch.infer import (
        frame_signature,
        transcribe,
        transcribe_segmented,
    )
    from lipreading_tpu_torch.ops.preprocess import (
        preprocess_padded,
        preprocess_padded_tracked,
    )

    t0 = time.perf_counter()
    if tracked:
        rois, valid = preprocess_padded_tracked(det, presence, lmk, frames,
                                                cfg.preprocess)
        n_bad = int((~valid).sum())
        if n_bad:
            print(f"  {n_bad}/{len(valid)} frames flagged no-face "
                  f"(skipped, not transcribed as garbage)")
        hyp, segments = transcribe_segmented(
            model, cfg, rois, valid, gap=gap_flush, beam=beam,
            sig=frame_signature(frames) if cut_flush > 0 else None,
            lm_weight=lm_weight, use_lexicon=use_lexicon)
        if not segments:
            print("transcript: ''  (no confident face in any frame)")
            return ""
        if len(segments) > 1:
            for (lo, hi), text in segments:
                print(f"  shot [{lo:4d}:{hi:4d}): {text!r}")
    else:
        rois = preprocess_padded(det, lmk, frames, cfg.preprocess)
        T = rois.shape[0]
        rois = np.pad(rois, ((0, -T % 64), (0, 0), (0, 0)))
        hyp = transcribe(model, cfg, rois[None], np.asarray([T], np.int32),
                         beam=beam, lm_weight=lm_weight,
                         use_lexicon=use_lexicon)[0]
    dt = time.perf_counter() - t0
    _print_result(hyp, ref)
    print(f"{len(frames)} frames in {dt:.2f}s "
          f"({len(frames) / dt:.0f} frames/s)")
    return hyp


def _print_result(hyp: str, ref: str | None) -> None:
    print(f"transcript: {hyp!r}")
    if ref is not None:
        from lipreading_tpu_torch.metrics import cer

        print(f"reference : {ref!r}  (CER {cer(hyp, ref):.3f})")


if __name__ == "__main__":
    main(sys.argv[1:])
