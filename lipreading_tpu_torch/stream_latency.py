"""Streaming real-time factor and per-chunk latency (counterpart of
``scripts/stream_latency.py``):

    python -m lipreading_tpu_torch.stream_latency [release=universal4] \\
        [clips=3] [chunk=8] [window=64] [beam=4] [lm_weight=0.4] \\
        [assets_variant=robust] [configs=greedy,quality] [device=cuda]

A stream of ``clips`` fixture clips (``make_clip(33001 + i)``) is fed
chunk by chunk (``chunk`` frames, chunk / 25 s of video) through
``StreamingTranscriber``; each config runs once to warm up, then once
timed. On the GPU each chunk's time is read after
``torch.cuda.synchronize()``. Configs:

* ``greedy``: untracked, beam 1, window 64, a decode every 12 frames;
* ``quality``: tracked with ``cut_flush``, the CTC prefix beam with
  char-LM fusion (``beam``, ``lm_weight``) for the live tail and the
  commits, the joint beam over each segment.

Prints one JSON line a config: ``rtf`` (processing time over the stream's
duration at 25 fps; below 1 keeps up with the stream), ``margin``
(1 / rtf), ``chunk_ms_p50`` / ``_p95`` / ``_max``, ``finish_ms``,
``chunks``, ``chunk_frames``, ``stream_s`` and ``cer``.
"""

from __future__ import annotations

import json
import sys
import time

FPS = 25.0


def build(kind: str, model, cfg, prep, window: int, chunk: int, beam: int,
          lm_weight: float):
    """The transcriber of config ``kind`` ("greedy" or "quality")."""
    from lipreading_tpu_torch.streaming import StreamingTranscriber

    det, lmk, presence = prep
    if kind == "greedy":
        return StreamingTranscriber(model, cfg, det, lmk, window=window,
                                    decode_every=12, chunk_bucket=chunk,
                                    beam=1)
    if kind == "quality":
        return StreamingTranscriber(model, cfg, det, lmk, window=window,
                                    decode_every=12, chunk_bucket=chunk,
                                    beam=beam, lm_weight=lm_weight,
                                    tracked=True, presence=presence)
    raise SystemExit(f"config {kind!r}: need greedy or quality")


def run_stream(st, frames, chunk: int, sync=None):
    """Feed ``frames`` in chunks -> (final transcript, each chunk's ms,
    finish ms, the transcript after each chunk)."""
    sync = sync or (lambda: None)
    times, hyps = [], []
    for lo in range(0, frames.shape[0], chunk):
        t0 = time.perf_counter()
        hyps.append(st.feed(frames[lo:lo + chunk]))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    text = st.finish()
    sync()
    return text, times, (time.perf_counter() - t0) * 1e3, hyps


def report(kind: str, text: str, truth: str, times, finish_ms: float,
           chunk: int, dur_s: float) -> dict:
    """One config's JSON line, with the JAX script's keys."""
    import numpy as np

    from lipreading_tpu_torch.metrics import cer

    total = sum(times) / 1e3
    return {
        "config": kind,
        "rtf": round(total / dur_s, 4),
        "margin": round(dur_s / total, 1),
        "chunk_ms_p50": round(float(np.percentile(times, 50)), 1),
        "chunk_ms_p95": round(float(np.percentile(times, 95)), 1),
        "chunk_ms_max": round(max(times), 1),
        "finish_ms": round(finish_ms, 1),
        "chunks": len(times),
        "chunk_frames": chunk,
        "stream_s": round(dur_s, 1),
        "cer": round(cer(text, truth), 4),
    }


def main(argv: list[str]) -> list[dict]:
    from lipreading_tpu_torch.config import parse_overrides

    args = parse_overrides(argv)
    release = str(args.pop("release", "universal4"))
    n_clips = int(args.pop("clips", 3))
    chunk = int(args.pop("chunk", 8))
    window = int(args.pop("window", 64))
    beam = int(args.pop("beam", 4))
    lm_weight = float(args.pop("lm_weight", 0.4))
    assets_variant = str(args.pop("assets_variant", "robust"))
    configs = str(args.pop("configs", "greedy,quality")).split(",")
    device = str(args.pop("device", "cuda"))
    if args:
        raise SystemExit(f"unknown args: {sorted(args)}")

    import numpy as np
    import torch

    from lipreading_tpu_torch.fixtures import make_clip
    from lipreading_tpu_torch.io import load_preprocessors, load_release_model

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to stream on the "
                         "CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model, cfg = load_release_model(
            release if release.startswith("transformer")
            else f"transformer_hybrid_{release}", device=device)
    except FileNotFoundError:
        raise SystemExit(f"release {release!r} missing")
    prep = load_preprocessors(cfg.preprocess.landmarker, assets_variant,
                              tracked="quality" in configs, device=device)
    clips = [make_clip(33001 + i, cfg.data) for i in range(n_clips)]
    frames = np.concatenate([c.frames for c in clips])
    truth = " ".join(c.text for c in clips)
    dur_s = frames.shape[0] / FPS
    print(f"# stream: {frames.shape[0]} frames = {dur_s:.1f} s of video, "
          f"chunk={chunk} ({chunk / FPS * 1e3:.0f} ms), device={device}",
          file=sys.stderr)
    sync = torch.cuda.synchronize if device.startswith("cuda") else None
    out = []
    for kind in configs:
        run_stream(build(kind, model, cfg, prep, window, chunk, beam,
                         lm_weight), frames, chunk, sync)      # warm-up
        text, times, finish_ms, _ = run_stream(
            build(kind, model, cfg, prep, window, chunk, beam, lm_weight),
            frames, chunk, sync)
        out.append(report(kind, text, truth, times, finish_ms, chunk, dur_s))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
