"""Host-ingest ceiling of the decode rings (counterpart of
``scripts/bench_ingest.py``):

    python -m lipreading_tpu_torch.bench_ingest [n=16] [T=64] \\
        [workers=1,2] [device=cuda]

Rates in frames/s, the same clip shape ([T, 160, 160, 3] uint8) for each:

* ``host_decode_fps``: one in-process OpenCV decode of ``n`` mp4 files
  (written from ``make_clips(31337, n)``);
* ``pool_decode_fps@k``: ``data/pipeline.VideoDecodePool`` with k workers
  (decode and the pipe);
* ``null_ipc_fps@k``: the same pool's processes returning a made clip
  without a codec (``_null_frames``): pickle, pipe and unpickle alone, the
  ceiling no worker count can pass;
* ``shm_decode_fps@k`` / ``shm_decode_view_fps@k``:
  ``ShmVideoDecodePool.imap`` (frames through shared-memory slots);
* ``null_shm_fps@k`` / ``null_shm_view_fps@k``: that ring's
  ``imap_jobs`` with the null work function.

The port's shared-memory ring copies every clip out of its slot as it
arrives (which keeps it from deadlocking), so the ``_view`` rates time the
same copy as the others. Where OpenCV is missing the codec keys are
``null`` and the reason is printed; the null rings are measured all the
same. The last lines give the scaling model:
``pool(k) ~= min(k * host decode, null ring)``. Every wait has a timeout
(``data/pipeline.RING_TIMEOUT``). ``device`` only names the card the run
is reported beside: nothing here runs on it.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

NO_CODEC = "no OpenCV (cv2): the codec keys are not measured"


def _null_frames(job):
    """Ring work function: (T, H, W) -> [T, H, W, 3] uint8 of 127, made
    without a codec; the job is a few ints, the result the whole clip."""
    import numpy as np

    t, h, w = job
    return np.full((t, h, w, 3), 127, np.uint8)


def _codec() -> str | None:
    """None where OpenCV imports, else the reason the codec keys are
    null."""
    try:
        from lipreading_tpu_torch.data.video import _cv2

        _cv2()
    except ImportError:
        return NO_CODEC
    return None


def keys(workers) -> list[str]:
    """The JAX script's keys in its order."""
    out = ["host_decode_fps"]
    for k in workers:
        out += [f"pool_decode_fps@{k}", f"null_ipc_fps@{k}",
                f"shm_decode_fps@{k}", f"shm_decode_view_fps@{k}",
                f"null_shm_fps@{k}", f"null_shm_view_fps@{k}"]
    return out


def bench_ingest(n: int = 16, T: int = 64, workers=(1, 2)) -> dict:
    """{"rates": {key: frames/s or None}, "no_codec": the reason or None,
    "H", "W", "T", "n"}."""
    from lipreading_tpu_torch.config import DataConfig
    from lipreading_tpu_torch.data.pipeline import (
        RING_TIMEOUT,
        ShmVideoDecodePool,
        VideoDecodePool,
    )
    from lipreading_tpu_torch.fixtures import make_clips

    cfg = DataConfig()
    H = W = cfg.frame_height
    no_codec = _codec()
    out = dict.fromkeys(keys(workers))
    jobs = [(T, H, W)] * n

    def rate(frames_iter):
        t0 = time.perf_counter()
        n_fr = sum(f.shape[0] for f in frames_iter)
        return n_fr / (time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as d:
        paths = []
        if no_codec is None:
            from lipreading_tpu_torch.data.video import (
                decode_video,
                write_video,
            )

            for i, c in enumerate(make_clips(31337, n, cfg)):
                p = os.path.join(d, f"c{i}.mp4")
                write_video(p, c.frames[:T], fps=25.0)
                paths.append(p)
            out["host_decode_fps"] = rate(decode_video(p)[0] for p in paths)

        for k in workers:
            with VideoDecodePool(workers=k) as pool:
                if no_codec is None:
                    next(iter(pool.imap([paths[0]])))          # warm spawns
                    out[f"pool_decode_fps@{k}"] = rate(pool.imap(paths))
                # the pure pipe: the same pool's processes, null work
                it = pool._pool.imap(_null_frames, jobs[:1])
                it.next(timeout=RING_TIMEOUT)                   # warm
                it = pool._pool.imap(_null_frames, jobs, chunksize=1)
                out[f"null_ipc_fps@{k}"] = rate(
                    it.next(timeout=RING_TIMEOUT) for _ in jobs)
            if no_codec is None:
                with ShmVideoDecodePool(workers=k, slot_frames=T + 8,
                                        frame_hw=(H, W)) as spool:
                    next(iter(spool.imap([paths[0]], max_frames=T)))
                    for mode, cp in (("", True), ("_view", False)):
                        out[f"shm_decode{mode}_fps@{k}"] = rate(
                            spool.imap(paths, max_frames=T, copy=cp))
            with ShmVideoDecodePool(workers=k, slot_frames=T + 8,
                                    frame_hw=(H, W),
                                    work_fn=_null_frames) as spool:
                next(iter(spool.imap_jobs(jobs[:1])))           # warm
                for mode in ("", "_view"):
                    out[f"null_shm{mode}_fps@{k}"] = rate(
                        spool.imap_jobs(jobs))
    return {"rates": out, "no_codec": no_codec, "H": H, "W": W, "T": T,
            "n": n}


def report(res: dict) -> list[str]:
    """The JAX script's lines: the clip, each key's rate, the model."""
    H, W, T, out = res["H"], res["W"], res["T"], res["rates"]
    lines = [f"# clip [T={T},{H},{W},3] u8 = {T * H * W * 3 / 1e6:.2f} MB, "
             f"n={res['n']}"]
    if res["no_codec"]:
        lines.append(f"# {res['no_codec']}")
    for key, v in out.items():
        if v is None:
            lines.append(f"{key:>24}: {'null':>10} (not measured)")
            continue
        extra = ""
        if key.startswith("null_"):
            extra = (f"  ({v * H * W * 3 / 1e6:,.0f} MB/s ring, "
                     f"{1e6 / v:.0f} us/frame)")
        lines.append(f"{key:>24}: {v:10,.1f} frames/s{extra}")
    dec = out["host_decode_fps"]
    ipc = max(v for k, v in out.items() if k.startswith("null_ipc"))
    shm = max((v for k, v in out.items() if k.startswith("null_shm")),
              default=None)
    if dec:
        lines.append(f"# model: pool(k) ~= min(k * {dec:,.0f}, {ipc:,.0f}) "
                     f"frames/s; IPC overhead per decoded frame = "
                     f"{1e3 / ipc * 1e3:.0f} us vs {1e6 / dec:.0f} us decode")
    else:
        lines.append(f"# model: pool(k) ~= min(k * host decode (not "
                     f"measured), {ipc:,.0f}) frames/s; IPC overhead per "
                     f"frame = {1e3 / ipc * 1e3:.0f} us")
    if shm:
        lines.append(f"# shm ring ceiling: {shm:,.0f} frames/s "
                     f"({shm / ipc:.1f}x the pipe) -> shm_pool(k) ~= "
                     f"min(k * {f'{dec:,.0f}' if dec else 'host decode'}, "
                     f"{shm:,.0f})")
    return lines


def main(argv: list[str]) -> dict:
    from lipreading_tpu_torch.config import parse_overrides
    from lipreading_tpu_torch.profiling import device_label, entry_device

    args = parse_overrides(argv)
    n = int(args.pop("n", 16))
    T = int(args.pop("T", 64))
    workers = [int(w) for w in str(args.pop("workers", "1,2")).split(",")]
    device = str(args.pop("device", "cuda"))
    if args:
        raise SystemExit(f"unknown args: {sorted(args)}")
    dev = entry_device(device)
    res = bench_ingest(n, T, workers)
    print(f"# host of device={device_label(dev)}, {os.cpu_count()} cores")
    for line in report(res):
        print(line)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
