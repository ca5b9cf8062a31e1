"""Sustained batch serving: video clips -> transcripts on one GPU
(counterpart of ``iter_batches``, ``serve`` and ``main`` in
``scripts/serve.py``).

    python -m lipreading_tpu_torch.serve [videos=dir_or_glob]
        [out=transcripts.jsonl] [release=transformer_hybrid_universal4]
        [landmarker=conv] [B=16] [bucket=96] [beam=8] [lm_weight=0.4]
        [workers=auto] [clips=64] [tracked=1] [passes=1]
        [device=cuda|cpu] [source=mp4|render]

The loop, as the JAX server runs it:

  ShmVideoDecodePool        worker processes decode (or render) clips into
                            shared-memory slots
  batch assembly            [B, bucket, H, W, 3] uint8, a ragged tail
                            padded with the last clip
  PinnedPrefetcher          page-locked staging and a copy to the card on
                            a side stream, two batches ahead
  preprocess_clips_tracked  detector + presence head, tracking, landmarks
                            (conv: a crop by the ROI kernel and 4 convs),
                            mouth ROIs (the ROI kernel, sub-pixel boxes)
  transcribe_cascade        CTC greedy on every clip (the greedy kernel);
                            the joint beam with the char LM only on the
                            clips its triggers flag, of those valid on
                            each frame of their length

A clip with frames without a face inside its length (``valid`` false) is
left out of the batch's rescore leg and decoded on its own by shot
(``infer.transcribe_segmented(cascade=True)``, its ROIs staying on the
device); the JAX server drops ``valid``. The first batch warms up (the cascade at
``margin=inf`` on every row count its rescore leg can take: each multiple
of ``rescore_bucket`` up to B) and is then served for its results; latency
is measured on the batches after it. Each of those prints its stage split
(host clock, synchronised after each stage).

``release`` is any release of ``assets/``: ``bigru_ctc`` (the conv3d stem
and the bi-GRU; its cascade rescores with the CTC prefix beam and the LM),
``transformer_hybrid``, ``transformer_hybrid_robust``,
``transformer_hybrid_universal`` (the conv3d stem and the transformer),
``transformer_hybrid_universal3`` or ``transformer_hybrid_universal4``
(the default here and in ``scripts/serve.py``). The conv3d-stem releases
pool their GroupNorm statistics over time, padded frames included, so a
clip's transcript depends on the bucket it is padded to.

``source``: ``mp4`` writes the fixture clips ``make_clip(100 + i)`` as mp4
files and decodes them in the workers (OpenCV), as the JAX server does;
``render`` renders the same clips in the workers, without a codec. The
default is ``mp4`` when ``videos=`` is given or OpenCV imports, else
``render``; the report says which ran.

It prints one JSON report as its last line: ``serving_sustained_fps``
(real frames of the steady batches over the wall time from the end of the
first batch to the end of the last), ``latency_p50_ms`` and
``latency_p95_ms`` (per steady batch), ``rescored_frac`` (clips the batch
cascade sent to the joint beam, of all clips), ``segmented_clips``,
``cer`` and ``serving_cer`` (when the truth is known), ``stages_ms`` (the
median of each stage over the steady batches), ``setup_s`` (loading, the
warm-up and the first batch), ``run_s`` (the whole call, the ring's
shutdown included) and the run's settings.
"""

from __future__ import annotations

import glob as globmod
import json
import os
import sys
import tempfile
import time

import numpy as np

from lipreading_tpu_torch import profiling
from lipreading_tpu_torch.profiling import StageClock

RESCORE_BUCKET = 8           # transcribe_cascade's default rescore_bucket
STAGES = ("h2d", "detect", "track", "landmarks", "roi", "greedy", "rescore",
          "segmented")


def iter_batches(clips, n: int, B: int, bucket: int, hw):
    """``n`` decoded clips ([T, H, W, 3] uint8, in order) -> (frames [B,
    bucket, H, W, 3] uint8, lengths [B] int32, clip indices); the rows past
    a ragged tail repeat its last clip."""
    H, W = hw
    done = 0
    while done < n:
        nb = min(B, n - done)
        frames = np.zeros((B, bucket, H, W, 3), np.uint8)
        lens = np.zeros((B,), np.int32)
        for k in range(nb):
            f = next(clips)
            t = min(f.shape[0], bucket)
            frames[k, :t] = f[:t]
            lens[k] = t
        for k in range(nb, B):
            frames[k] = frames[nb - 1]
            lens[k] = lens[nb - 1]
        yield frames, lens, list(range(done, done + nb))
        done += nb


def load_server(release: str = "transformer_hybrid_universal4",
                landmarker: str = "conv", tracked: bool = True,
                device="cuda") -> dict:
    """The release, the detector, the landmarker and (tracked) the presence
    head on ``device`` -> the dict ``serve_batch`` takes."""
    import torch

    from lipreading_tpu_torch import io

    device = torch.device(device)
    model, cfg = io.load_release_model(release, device=device)
    cfg = cfg.override(**{"preprocess.landmarker": landmarker})
    det, lmk, presence = io.load_preprocessors(landmarker, tracked=tracked,
                                               device=device)
    return {"model": model, "cfg": cfg, "device": device, "det": det,
            "lmk": lmk, "presence": presence}


def preprocess_batch(srv: dict, frames, mark=None):
    """Frames [B, T, H, W, 3] uint8 on the server's device -> (ROIs [B, T,
    R, R], valid [B, T] bool): tracked with the presence head, else every
    frame valid."""
    import torch

    from lipreading_tpu_torch.ops.preprocess import (
        preprocess_clips,
        preprocess_clips_tracked,
    )

    mark = mark or (lambda stage: None)
    pc = srv["cfg"].preprocess
    if srv["presence"] is not None:
        return preprocess_clips_tracked(srv["det"], srv["presence"],
                                        srv["lmk"], frames, pc, mark=mark)
    rois = preprocess_clips(srv["det"], srv["lmk"], frames, pc)
    mark("roi")
    return rois, torch.ones(rois.shape[:2], dtype=torch.bool,
                            device=rois.device)


def serve_batch(srv: dict, frames, lens, beam: int = 8,
                lm_weight: float = 0.4, margin: float = 8.0, mark=None):
    """One batch: frames [B, T, H, W, 3] uint8 and lengths [B] on the
    server's device -> (transcripts, flags [B] bool: the batch cascade
    rescored the clip, segmented [B] bool: the clip was decoded by shot).

    The batch goes through one ``transcribe_cascade`` whose rescore leg
    takes only the clips valid on every frame of their length; a clip with
    an invalid frame inside its length is decoded on its own by
    ``transcribe_segmented(cascade=True)`` from its ROIs on the device,
    and is not counted as rescored. The greedy leg keeps all B rows: a
    batch of the whole clips alone would give the encoder a new row count
    in most batches, which no warm-up covers.

    ``mark`` a ``StageClock``'s ``mark`` also traces the batch
    (``profiling.unit("serve.batch")``): its spans and counters add to
    ``profiling.trace_totals()``."""
    import torch

    from lipreading_tpu_torch.infer import (
        transcribe_cascade,
        transcribe_segmented,
    )

    model, cfg = srv["model"], srv["cfg"]
    clock = getattr(mark, "__self__", None)
    traced = clock.device if isinstance(clock, StageClock) else None
    mark = mark or (lambda stage: None)
    with torch.inference_mode(), profiling.unit("serve.batch", traced):
        rois, valid = preprocess_batch(srv, frames, mark)
        with profiling.span("wait.lengths"):
            lens_np = lens.cpu().numpy()
        with profiling.span("wait.valid"):
            valid_np = valid.cpu().numpy()
        B = len(lens_np)
        segmented = np.asarray([not valid_np[k, :lens_np[k]].all()
                                for k in range(B)])
        texts: list[str] = [""] * B
        flags = np.zeros(B, bool)
        if not segmented.all():
            texts, flags = transcribe_cascade(
                model, cfg, rois, lens, beam=beam, lm_weight=lm_weight,
                margin=margin, return_flags=True, mark=mark,
                rows=~segmented)
        for k in np.flatnonzero(segmented):
            n = int(lens_np[k])
            with profiling.span("serve.clip"):
                texts[k], _ = transcribe_segmented(
                    model, cfg, rois[k, :n], valid_np[k, :n], cascade=True,
                    beam=beam, lm_weight=lm_weight)
        mark("segmented")
    return texts, flags, segmented


def warm_up(srv: dict, frames, lens, beam: int, lm_weight: float,
            rescore_bucket: int = RESCORE_BUCKET) -> None:
    """The batch's ROIs through the cascade at ``margin=inf`` (every row
    through the joint beam) on the first ``min(P, B)`` rows, for each
    multiple P of ``rescore_bucket`` that a batch of B rows can reach, so
    that no steady batch is the first to run a rescore shape."""
    import torch

    from lipreading_tpu_torch.infer import transcribe_cascade

    B = frames.shape[0]
    top = -(-B // rescore_bucket) * rescore_bucket
    with torch.inference_mode():
        rois, _ = preprocess_batch(srv, frames)
        for P in range(rescore_bucket, top + 1, rescore_bucket):
            n = min(P, B)
            transcribe_cascade(srv["model"], srv["cfg"], rois[:n], lens[:n],
                               beam=beam, lm_weight=lm_weight,
                               margin=float("inf"),
                               rescore_bucket=rescore_bucket)


def resolve_source(source: str | None, videos) -> str:
    """``source=`` as given, or the default: mp4 with ``videos=`` or where
    OpenCV imports, else render."""
    if source is None:
        if videos is not None:
            return "mp4"
        try:
            import cv2  # noqa: F401
        except ImportError:
            return "render"
        return "mp4"
    if source not in ("mp4", "render"):
        raise ValueError(f"source={source!r}: need mp4 or render")
    if source == "render" and videos is not None:
        raise ValueError("videos= names files to decode: source=render "
                         "renders the fixture clips instead")
    return source


def serve(videos=None, out_path=None,
          release: str = "transformer_hybrid_universal4",
          landmarker: str = "conv", B: int = 16, bucket: int = 96,
          beam: int = 8, lm_weight: float = 0.4, workers="auto",
          n_clips: int = 64, tracked: bool = True, passes: int = 1,
          device: str = "cuda", source: str | None = None,
          log=print) -> dict:
    """Run the serving loop; returns the report (see the module doc).
    ``log`` prints the stage split of each steady batch."""
    import torch

    from lipreading_tpu_torch.data.pipeline import (
        PinnedPrefetcher,
        ShmVideoDecodePool,
        _decode_frames,
        _render_frames,
    )
    from lipreading_tpu_torch.data.video import decode_video, write_video
    from lipreading_tpu_torch.fixtures import clip_text, make_clip
    from lipreading_tpu_torch.metrics import corpus_cer

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda, but torch sees no CUDA device "
                           "(device=cpu runs the plain versions)")
    source = resolve_source(source, videos)
    t_setup = time.perf_counter()
    srv = load_server(release, landmarker, tracked, dev)
    cfg = srv["cfg"]

    tmpdir, truths = None, None
    if source == "render":
        seeds = [100 + i for i in range(n_clips)]
        jobs = [(s, bucket) for s in seeds]
        names = [f"make_clip({s})" for s in seeds]
        truths = [clip_text(s) for s in seeds]
        work_fn = _render_frames
        H, W = cfg.data.frame_height, cfg.data.frame_width
    else:
        if videos is None:
            tmpdir = tempfile.TemporaryDirectory()
            paths, truths = [], []
            for i in range(n_clips):
                c = make_clip(100 + i)
                p = os.path.join(tmpdir.name, f"clip{i:04d}.mp4")
                write_video(p, c.frames, fps=25.0)
                paths.append(p)
                truths.append(c.text)
        elif os.path.isdir(videos):
            paths = sorted(globmod.glob(os.path.join(videos, "**", "*.mp4"),
                                        recursive=True))
        else:
            paths = sorted(globmod.glob(videos))
        if not paths:
            raise FileNotFoundError(f"no mp4s match {videos!r}")
        jobs = [(p, bucket) for p in paths]
        names = paths
        work_fn = _decode_frames
        H, W = decode_video(paths[0], max_frames=1)[0].shape[1:3]
    jobs, names = jobs * passes, names * passes
    if truths is not None:
        truths = truths * passes

    nw = (max(1, (os.cpu_count() or 1) - 1) if workers == "auto"
          else int(workers))
    results: list[str | None] = [None] * len(jobs)
    n_rescored = n_segmented = n_frames_done = 0
    lat, stages = [], {k: [] for k in STAGES}
    t_run = t_end = None
    try:
        with ShmVideoDecodePool(workers=nw, slot_frames=bucket,
                                frame_hw=(H, W), work_fn=work_fn) as pool:
            pf = PinnedPrefetcher(
                iter_batches(pool.imap_jobs(jobs), len(jobs), B, bucket,
                             (H, W)), dev)
            try:
                for (frames, lens), (c0, c1), (_, lens_np, idxs) in pf:
                    first = t_run is None
                    if first:
                        warm_up(srv, frames, lens, beam, lm_weight)
                    clock = StageClock(dev)
                    t0 = time.perf_counter()
                    texts, flags, seg = serve_batch(srv, frames, lens, beam,
                                                    lm_weight,
                                                    mark=clock.mark)
                    dt = time.perf_counter() - t0
                    for j, i in enumerate(idxs):
                        results[i] = texts[j]
                        n_rescored += bool(flags[j])
                        n_segmented += bool(seg[j])
                    t_end = time.perf_counter()
                    if first:
                        t_run = t_end       # set-up ends, the steady clock
                        continue            # starts
                    lat.append(dt)
                    n_frames_done += int(lens_np[:len(idxs)].sum())
                    split = dict(clock.ms)
                    split["h2d"] = c0.elapsed_time(c1) if c0 is not None else 0.0
                    for k in STAGES:
                        stages[k].append(split.get(k, 0.0))
                    log(f"[serve] batch {len(lat)} stages ms (host clock, "
                        "synchronised; h2d: the side stream's copy, device): "
                        + ", ".join(f"{k} {split.get(k, 0.0):.3f}"
                                    for k in STAGES)
                        + f"; latency {dt * 1e3:.3f}")
            finally:
                pool.stop()
                pf.close()
    finally:
        if tmpdir is not None:
            tmpdir.cleanup()
    wall = t_end - t_run if t_run is not None else 0.0

    if out_path:
        with open(out_path, "w") as f:
            for name, t in zip(names, results):
                f.write(json.dumps({"video": name, "transcript": t}) + "\n")

    report = {
        "serving_sustained_fps": (n_frames_done / wall
                                  if wall > 0 and n_frames_done else None),
        "clips": len(jobs),
        "B": B,
        "bucket": bucket,
        "tracked": tracked,
        "landmarker": landmarker,
        "beam": beam,
        "workers": nw,
        "source": source,
        "rescored_frac": n_rescored / len(jobs),
        "segmented_clips": n_segmented,
        "latency_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                           if lat else None),
        "latency_p95_ms": (float(np.percentile(lat, 95)) * 1e3
                           if lat else None),
        "stages_ms": ({k: float(np.median(v)) for k, v in stages.items()}
                      if lat else None),
        "setup_s": t_run - t_setup if t_run is not None else None,
        "run_s": time.perf_counter() - t_setup,
        "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "transcripts": results,
    }
    if truths is not None:
        report["cer"] = corpus_cer([r or "" for r in results], truths)
        report["serving_cer"] = report["cer"]
    return report


def main(argv: list[str]) -> None:
    from lipreading_tpu_torch.config import parse_overrides

    args = parse_overrides(argv)
    kw = dict(
        videos=args.pop("videos", None),
        out_path=args.pop("out", None),
        release=str(args.pop("release", "transformer_hybrid_universal4")),
        landmarker=str(args.pop("landmarker", "conv")),
        B=int(args.pop("B", 16)),
        bucket=int(args.pop("bucket", 96)),
        beam=int(args.pop("beam", 8)),
        lm_weight=float(args.pop("lm_weight", 0.4)),
        workers=args.pop("workers", "auto"),
        n_clips=int(args.pop("clips", 64)),
        tracked=bool(int(args.pop("tracked", 1))),
        passes=int(args.pop("passes", 1)),
        device=str(args.pop("device", "cuda")),
        source=args.pop("source", None),
    )
    if args:
        raise SystemExit(f"unknown args: {sorted(args)}")
    report = serve(**kw)
    report.pop("transcripts")
    print(json.dumps(report))


if __name__ == "__main__":
    main(sys.argv[1:])
