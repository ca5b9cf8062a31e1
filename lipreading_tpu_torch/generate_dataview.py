"""Build a cached ROI dataview (counterpart of ``scripts/generate_dataview.py``):

    python -m lipreading_tpu_torch.generate_dataview out=data/dataviews/train \\
        [n_clips=40] [seed=1] [gt_landmarks=0] [tracked=0] [keep_invalid=0] \\
        [landmarker=ert|conv] [variation=0.0] [variation_max=] \\
        [assets_variant=] [device=cuda]
    python -m lipreading_tpu_torch.generate_dataview out=... video=clip.mp4 \\
        vtt=clip.vtt [tracked=1] [device=cuda]
    python -m lipreading_tpu_torch.generate_dataview out=... merge=viewA,viewB

Fixture builds render ``n_clips`` clips and preprocess them on the device
(``data.dataview.build_fixture_dataview``): the fixture's own landmarks
with ``gt_landmarks=1``; ``tracked=1`` drops each sample's faceless frames,
or keeps them with a stored mask (``keep_invalid=1``); ``variation`` /
``variation_max`` style the clips (a per-clip level in [variation,
variation_max)) and select the robust assets unless ``assets_variant=`` is
given. ``video=`` decodes a video (OpenCV), preprocesses it on the device
in chunks of 256 frames (tracked by default: a cutaway must give flagged
frames, not a face that is not there) and cuts samples at its VTT cues.
``merge=`` joins views into one. It runs on the GPU unless ``device=cpu``
is given.
"""

from __future__ import annotations

import sys

CHUNK = 256


def build_from_video(out: str, video: str, vtt: str, tracked: bool,
                     device) -> int:
    """A dataview of one video's cue samples (frame masks stored when
    tracked) -> the number of samples."""
    import numpy as np

    from lipreading_tpu_torch.config import DataConfig, PreprocessConfig
    from lipreading_tpu_torch.data.dataview import DataviewWriter, roi_to_u8
    from lipreading_tpu_torch.data.video import decode_video
    from lipreading_tpu_torch.io import load_preprocessors
    from lipreading_tpu_torch.ops.preprocess import (
        preprocess_padded,
        preprocess_padded_tracked,
    )
    from lipreading_tpu_torch.vtt import align_cues_to_frames, parse_vtt

    pre_cfg = PreprocessConfig()
    det, lmk, presence = load_preprocessors(tracked=tracked, device=device)
    frames, fps = decode_video(video)
    writer = DataviewWriter(out, DataConfig(fps=fps), pre_cfg)
    rois, valids = [], []
    for lo in range(0, len(frames), CHUNK):
        chunk = frames[lo:lo + CHUNK]
        if tracked:
            r, v = preprocess_padded_tracked(det, presence, lmk, chunk,
                                             pre_cfg, bucket=CHUNK)
        else:
            r = preprocess_padded(det, lmk, chunk, pre_cfg, bucket=CHUNK)
            v = np.ones(len(chunk), bool)
        rois.append(r)
        valids.append(v)
    roi_u8 = roi_to_u8(np.concatenate(rois), pre_cfg)
    valid = np.concatenate(valids)
    with open(vtt) as f:
        cues = parse_vtt(f.read())
    for j, (first, last, text) in enumerate(
            align_cues_to_frames(cues, fps, len(frames))):
        writer.add(f"video_cue{j:04d}", roi_u8[first:last], text,
                   frame_valid=valid[first:last] if tracked else None)
    writer.finalize()
    flag = (f" ({int((~valid).sum())}/{len(valid)} frames flagged no-face)"
            if tracked else "")
    print(f"wrote {len(writer.entries)} samples to {out}{flag}")
    return len(writer.entries)


def main(argv: list[str]):
    from lipreading_tpu_torch.config import (
        DataConfig,
        PreprocessConfig,
        parse_overrides,
    )
    from lipreading_tpu_torch.train.__main__ import variation_args

    args = parse_overrides(argv)
    out = args.pop("out", "data/dataviews/train")
    device = args.pop("device", "cuda")
    if "merge" in args:
        from lipreading_tpu_torch.data.dataview import merge_dataviews

        paths = [p for p in args.pop("merge").split(",") if p]
        if args:
            raise SystemExit(f"unknown arguments {sorted(args)}")
        view = merge_dataviews(out, paths)
        print(f"merged {len(paths)} views -> {len(view)} samples at {out}")
        return view

    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to build on the CPU")
    if "video" in args:
        return build_from_video(out, args.pop("video"), args.pop("vtt"),
                                args.pop("tracked", "1") in ("1", "true"),
                                device)
    from lipreading_tpu_torch.data.dataview import build_fixture_dataview

    n_clips = int(args.pop("n_clips", 40))
    seed = int(args.pop("seed", 1))
    gt = args.pop("gt_landmarks", "0") in ("1", "true")
    tracked = args.pop("tracked", "0") in ("1", "true")
    keep_invalid = args.pop("keep_invalid", "0") in ("1", "true")
    landmarker = args.pop("landmarker", "ert")
    variation, assets_variant = variation_args(args)
    if args:
        raise SystemExit(f"unknown arguments {sorted(args)}")
    view = build_fixture_dataview(
        out, n_clips=n_clips, seed=seed, data_cfg=DataConfig(),
        pre_cfg=PreprocessConfig(landmarker=landmarker),
        use_ground_truth_landmarks=gt, tracked=tracked,
        keep_invalid=keep_invalid, variation=variation,
        assets_variant=assets_variant, device=device)
    print(f"wrote {len(view)} samples to {out}")
    return view


if __name__ == "__main__":
    main(sys.argv[1:])
