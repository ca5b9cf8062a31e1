"""Raw-frame batches, disk-video ingest and the serving loop's input ring
(counterpart of ``VideoBatch``, ``FixtureVideoDataset``,
``VideoBatchIterator``, ``VideoDecodePool``, ``ShmVideoDecodePool``,
``VideoFileIterator`` and ``Prefetcher`` in
``lipreading_tpu/data/pipeline.py``).

* Training: the host renders fixture clips, cuts them into per-word cue
  samples, and pads batches of uint8 frames into time buckets; detection,
  landmarks and ROIs run on the device inside the train step
  (``train/loop.FusedTrainer``). The same seeds give the same batches, in
  the same order, as the JAX package. ``video_batch_to_device`` copies them
  to the device.
* Disk-video ingest: ``VideoFileIterator`` decodes mp4 files in worker
  processes every epoch (``VideoDecodePool``, frames over the pipe, or the
  shared-memory ring) into the same ``VideoBatch``es, for the same train
  step. Decode needs OpenCV (``data/video.py``).
* Serving: ``ShmVideoDecodePool`` decodes (or renders) clips in worker
  processes into shared-memory slots, and ``PinnedPrefetcher`` stages the
  padded batches in page-locked memory and copies them to the card on a
  side stream, so that the next batch's copy overlaps this one's work.

Every wait on a worker is timed (``RING_TIMEOUT``). This module imports
torch only inside the functions that use it: the workers import it and
nothing of torch.
"""

from __future__ import annotations

import collections
import itertools
import multiprocessing
import os
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from lipreading_tpu_torch.config import DataConfig
from lipreading_tpu_torch.text import Vocab


@dataclass
class VideoBatch:
    """Raw-frame batch for fused-preprocessing training."""

    frames: np.ndarray          # [B, T, H, W, 3] uint8
    frame_lengths: np.ndarray   # [B]
    targets: np.ndarray         # [B, L]
    target_lengths: np.ndarray  # [B]
    ctc_labels: np.ndarray      # [B, Lc]
    ctc_lengths: np.ndarray     # [B]
    texts: list[str]


class FixtureVideoDataset:
    """In-memory corpus of rendered fixture clips cut into cue samples: one
    sample per caption cue (word) and one for the whole clip."""

    def __init__(self, n_clips: int, seed: int, cfg: DataConfig,
                 vocab: Vocab | None = None):
        from lipreading_tpu_torch.fixtures import make_clip
        from lipreading_tpu_torch.vtt import align_cues_to_frames, parse_vtt

        self.cfg = cfg
        self.vocab = vocab or Vocab()
        self.samples: list[tuple[np.ndarray, str]] = []
        for c in range(n_clips):
            clip = make_clip(seed * 131_071 + c, cfg)
            cues = parse_vtt(clip.vtt)
            for first, last, text in align_cues_to_frames(
                    cues, clip.fps, clip.num_frames):
                self.samples.append((clip.frames[first:last], text))
            self.samples.append((clip.frames, clip.text))

    def __len__(self):
        return len(self.samples)

    def batch(self, indices: list[int], time_bucket: int) -> VideoBatch:
        B = len(indices)
        cfg = self.cfg
        H, W = cfg.frame_height, cfg.frame_width
        L = cfg.max_chars
        frames = np.zeros((B, time_bucket, H, W, 3), np.uint8)
        fl = np.zeros((B,), np.int32)
        targets = np.zeros((B, L), np.int32)
        tl = np.zeros((B,), np.int32)
        ctc = np.zeros((B, L), np.int32)
        cl = np.zeros((B,), np.int32)
        texts = []
        for k, i in enumerate(indices):
            f, text = self.samples[i]
            t = min(f.shape[0], time_bucket)
            frames[k, :t] = f[:t]
            fl[k] = t
            ids = self.vocab.encode(text)[: L - 2]
            text = self.vocab.decode(ids)
            targets[k], tl[k] = self.vocab.encode_target(text, L)
            ctc[k, : len(ids)] = ids
            cl[k] = len(ids)
            texts.append(text)
        return VideoBatch(frames, fl, targets, tl, ctc, cl, texts)


class VideoBatchIterator:
    """Deterministic, resumable iterator over raw-frame batches: per epoch, a
    seeded permutation of the samples, grouped by time bucket into full
    batches, the batches shuffled. ``shard=(index, count)`` yields part
    ``index`` of each global batch (a data rank's rows, as
    ``BatchIterator``)."""

    def __init__(self, dataset: FixtureVideoDataset, batch_size: int,
                 seed: int = 0, epoch: int = 0, pos: int = 0,
                 shard: tuple[int, int] = (0, 1)):
        index, count = shard
        if batch_size % count or not 0 <= index < count:
            raise ValueError(f"a batch of {batch_size} does not split into "
                             f"part {index} of {count}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.seed = seed
        self.epoch = epoch
        self.pos = pos
        self.buckets = tuple(sorted(dataset.cfg.time_buckets))
        self._plan = self._make_plan(epoch)

    @classmethod
    def from_state(cls, dataset: FixtureVideoDataset, batch_size: int,
                   state: dict, shard: tuple[int, int] = (0, 1)
                   ) -> "VideoBatchIterator":
        """Resume at a saved ``state`` (epoch, position, seed)."""
        return cls(dataset, batch_size, seed=state["seed"],
                   epoch=state["epoch"], pos=state["pos"], shard=shard)

    def _bucket_for(self, t: int) -> int:
        for b in self.buckets:
            if t <= b:
                return b
        return self.buckets[-1]

    def _rows(self, members: list[int]) -> list[int]:
        """This part's rows of a global batch: the ``index``-th of
        ``count`` equal runs, in order."""
        index, count = self.shard
        n = len(members) // count
        return members[index * n:(index + 1) * n]

    def _make_plan(self, epoch):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 0x71DE0]))
        order = rng.permutation(len(self.ds))
        plan = []
        for b in self.buckets:
            members = [
                int(i) for i in order
                if self._bucket_for(self.ds.samples[i][0].shape[0]) == b
            ]
            for lo in range(0, len(members) - self.batch_size + 1,
                            self.batch_size):
                plan.append((b, members[lo:lo + self.batch_size]))
        rng.shuffle(plan)
        return plan

    @property
    def state(self):
        return {"epoch": self.epoch, "pos": self.pos, "seed": self.seed}

    def __iter__(self):
        return self

    def __next__(self) -> VideoBatch:
        if self.pos >= len(self._plan):
            self.epoch += 1
            self.pos = 0
            self._plan = self._make_plan(self.epoch)
            if not self._plan:
                raise RuntimeError("dataset too small for batch size")
        bucket, idx = self._plan[self.pos]
        self.pos += 1
        return self.ds.batch(self._rows(idx), bucket)


def video_batch_to_device(batch: VideoBatch, device) -> dict:
    """VideoBatch -> dict of tensors on ``device`` (frames stay uint8; the
    train step preprocesses them there)."""
    import torch

    def put(x):
        return torch.as_tensor(x).to(device)

    return {
        "frames": put(batch.frames),
        "frame_lengths": put(batch.frame_lengths),
        "targets": put(batch.targets),
        "target_lengths": put(batch.target_lengths),
        "ctc_labels": put(batch.ctc_labels),
        "ctc_lengths": put(batch.ctc_lengths),
    }


# --- the serving loop's input: a shared-memory decode ring and a pinned
# prefetcher

RING_TIMEOUT = 300.0    # s the consumer waits for one result before it raises
POLL = 0.5              # s between the checks of a blocked wait
PREFETCH_DEPTH = 2      # batches staged on the device ahead of their use


def _decode_frames(payload):
    """Ring work function: (video path, max_frames) -> [T, H, W, 3] uint8."""
    from lipreading_tpu_torch.data.video import decode_video

    path, max_frames = payload
    return decode_video(path, max_frames=max_frames)[0]


# the pools' worker under the JAX package's name for it
_decode_one = _decode_frames


class VideoDecodePool:
    """Decode mp4 files in ``workers`` spawned processes; the frames come
    back over the pipe (pickled). ``imap`` yields them in input order with
    at most ``workers + prefetch`` files in flight. A clip that does not
    come within ``timeout`` seconds raises TimeoutError, and a worker's
    error raises in the parent.

    Usage::

        with VideoDecodePool(workers=4) as pool:
            for frames in pool.imap(paths):
                ...
    """

    def __init__(self, workers: int | None = None, prefetch: int = 4,
                 timeout: float = RING_TIMEOUT):
        self.workers = workers or max(1, (os.cpu_count() or 1) - 1)
        self.prefetch = prefetch
        self.timeout = timeout
        ctx = multiprocessing.get_context("spawn")
        self._pool = ctx.Pool(self.workers)

    def imap(self, paths, max_frames: int | None = None):
        """Yield decoded [T, H, W, 3] uint8 stacks in input order."""
        paths = list(paths)

        def drain():
            todo = iter(paths)
            inflight = collections.deque()

            def send(n):
                for p in itertools.islice(todo, n):
                    inflight.append((p, self._pool.apply_async(
                        _decode_one, ((p, max_frames),))))

            send(self.workers + self.prefetch)
            while inflight:
                path, res = inflight.popleft()
                try:
                    frames = res.get(timeout=self.timeout)
                except multiprocessing.TimeoutError:
                    raise TimeoutError(f"no decoded clip in {self.timeout:g}"
                                       f" s for {path!r}") from None
                send(1)
                yield frames

        return drain()

    def close(self):
        self._pool.terminate()
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _render_frames(payload):
    """Ring work function: (seed, max_frames) -> the first frames of
    ``fixtures.make_clip(seed)``, rendered in the worker (no codec)."""
    from lipreading_tpu_torch.fixtures import make_clip

    seed, max_frames = payload
    return make_clip(seed).frames[:max_frames]


def _take(q, stop):
    """The next item of ``q``, or None once ``stop`` is set."""
    while not stop.is_set():
        try:
            return q.get(timeout=POLL)
        except queue.Empty:
            continue
    return None


def _shm_worker(jobs, results, free, stop, shm_names, slot_bytes, work_fn):
    """Ring worker: run ``work_fn(payload)`` for each (seq, payload) job,
    write the frames into a free shared-memory slot and send (seq, slot,
    shape, None), or (seq, -1, None, error) if the work raised. It ends at a
    None job or when ``stop`` is set; every wait polls ``stop``."""
    from multiprocessing import shared_memory

    # spawned workers share the parent's resource tracker: attaching here
    # registers names the parent already owns and unlinks at close
    shms = [shared_memory.SharedMemory(name=n) for n in shm_names]
    try:
        while True:
            job = _take(jobs, stop)
            if job is None:
                return
            seq, payload = job
            try:
                frames = np.ascontiguousarray(work_fn(payload), np.uint8)
                if frames.nbytes > slot_bytes:
                    raise ValueError(
                        f"a clip of {frames.nbytes} B exceeds the ring slot "
                        f"({slot_bytes} B); pass max_frames or grow "
                        "slot_frames")
            except Exception as e:  # sent to the parent, which raises
                results.put((seq, -1, None, f"{type(e).__name__}: {e}"),
                            timeout=RING_TIMEOUT)
                continue
            slot = _take(free, stop)
            if slot is None:
                return
            np.ndarray(frames.shape, np.uint8,
                       buffer=shms[slot].buf)[:] = frames
            results.put((seq, slot, frames.shape, None), timeout=RING_TIMEOUT)
    finally:
        for s in shms:
            s.close()


class ShmVideoDecodePool:
    """Decode ring: ``workers`` spawned processes run ``work_fn`` on the
    jobs (decode a video, or render a fixture clip) and write the frames
    into ``slots`` shared-memory slots; only (seq, slot, shape) rides the
    pipe. ``imap_jobs`` yields the clips in input order.

    The JAX package's ring can deadlock: results that arrive before their
    turn keep their slots while the consumer waits for the one it wants,
    and the worker of that one then waits for a free slot forever. Here the
    consumer copies every result out of its slot as soon as it arrives and
    hands the slot back, so a held result holds no slot, and at most
    ``slots + workers`` jobs are in flight past the one it waits for. Every
    wait has a timeout: a result that does not come within ``timeout``
    seconds, a worker that dies, or a work function that raises, raises in
    the parent with the workers' state.

    Usage::

        with ShmVideoDecodePool(workers=4, slot_frames=96) as pool:
            for frames in pool.imap_jobs([(p, 96) for p in paths]):
                ...
    """

    def __init__(self, workers: int | None = None, slot_frames: int = 256,
                 frame_hw: tuple[int, int] = (160, 160),
                 slots: int | None = None, work_fn=_decode_frames,
                 timeout: float = RING_TIMEOUT):
        import multiprocessing as mp
        from multiprocessing import shared_memory

        self.workers = workers or max(1, (os.cpu_count() or 1) - 1)
        self.slot_bytes = slot_frames * frame_hw[0] * frame_hw[1] * 3
        self.slots = slots if slots is not None else self.workers + 2
        self.timeout = timeout
        ctx = mp.get_context("spawn")
        self._shm = [shared_memory.SharedMemory(create=True,
                                                size=self.slot_bytes)
                     for _ in range(self.slots)]
        self._jobs = ctx.Queue()
        self._results = ctx.Queue()
        self._free = ctx.Queue()
        self._stop = ctx.Event()
        self._stopped = threading.Event()
        for i in range(self.slots):
            self._free.put(i, timeout=timeout)
        names = [s.name for s in self._shm]
        self._procs = [
            ctx.Process(target=_shm_worker,
                        args=(self._jobs, self._results, self._free,
                              self._stop, names, self.slot_bytes, work_fn),
                        daemon=True)
            for _ in range(self.workers)]
        for p in self._procs:
            p.start()
        self._closed = False

    def imap(self, paths, max_frames: int | None = None, copy: bool = True):
        """Yield the decoded [T, H, W, 3] uint8 stacks of ``paths`` in input
        order (the default ``work_fn``). Each clip is copied out of its slot
        as it arrives, which is what keeps the ring from deadlocking, so
        every yielded array is the caller's own whatever ``copy`` says (the
        JAX ring yields views into its slots with ``copy=False``)."""
        return self.imap_jobs([(p, max_frames) for p in paths])

    def imap_jobs(self, payloads):
        """Yield ``work_fn(payload)`` for each payload, in input order."""
        payloads = list(payloads)
        window = self.slots + self.workers

        def drain():
            held: dict[int, np.ndarray] = {}
            sent = 0
            for want in range(len(payloads)):
                while sent < len(payloads) and sent < want + window:
                    self._jobs.put((sent, payloads[sent]),
                                   timeout=self.timeout)
                    sent += 1
                deadline = time.monotonic() + self.timeout
                while want not in held:
                    seq, slot, shape, err = self._result(deadline, want, held)
                    if err is not None:
                        raise RuntimeError(f"ring job {seq} "
                                           f"({payloads[seq]!r}) failed: "
                                           f"{err}")
                    # copy out at once and hand the slot back, whether or
                    # not it is this result's turn
                    held[seq] = np.ndarray(shape, np.uint8,
                                           buffer=self._shm[slot].buf).copy()
                    self._free.put(slot, timeout=self.timeout)
                yield held.pop(want)

        return drain()

    def _result(self, deadline: float, want: int, held: dict):
        while True:
            if self._stopped.is_set():
                raise RuntimeError("the ring was stopped")
            try:
                return self._results.get(timeout=POLL)
            except queue.Empty:
                pass
            dead = [p for p in self._procs if p.exitcode is not None]
            if dead:
                raise RuntimeError(
                    "a ring worker died: " + self.state(want, held))
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no ring result in {self.timeout:g} s: "
                    + self.state(want, held))

    def state(self, want: int | None = None, held=()) -> str:
        """The workers (pid, alive, exit code) and the consumer's position."""
        procs = ", ".join(f"pid {p.pid} alive={p.is_alive()} "
                          f"exitcode={p.exitcode}" for p in self._procs)
        return (f"workers [{procs}]; waiting for job {want}; holding "
                f"{sorted(held)}; {self.slots} slots")

    def stop(self):
        """Make a consumer that waits for a result raise within ``POLL``
        seconds (``close`` stops the workers too)."""
        self._stopped.set()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.stop()
        self._stop.set()
        for q in (self._results, self._free, self._jobs):
            try:                       # drain what the workers wrote
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for p in self._procs:
            p.join(timeout=5 * POLL + 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for q in (self._results, self._free, self._jobs):
            q.cancel_join_thread()
            q.close()
        for s in self._shm:
            s.close()
            s.unlink()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VideoFileIterator:
    """Endless iterator of ``VideoBatch``es decoded from video files on
    disk through ``pool`` (a ``VideoDecodePool`` or a
    ``ShmVideoDecodePool``): the disk counterpart of
    ``VideoBatchIterator``. ``samples`` is a list of (path, text). Each
    epoch takes a seeded permutation of the samples, cut to whole batches,
    and decodes every file anew (nothing is cached), each clip padded to the
    largest time bucket; the same seed gives the JAX package's batches."""

    def __init__(self, samples: list[tuple[str, str]], cfg: DataConfig,
                 batch_size: int, pool, vocab: Vocab | None = None,
                 seed: int = 0):
        self.samples = samples
        self.cfg = cfg
        self.batch_size = batch_size
        self.pool = pool
        self.vocab = vocab or Vocab()
        self.seed = seed
        self.epoch = 0
        self._iter = None

    def _epoch_stream(self, epoch):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 0xF11E]))
        order = rng.permutation(len(self.samples))
        n = (len(order) // self.batch_size) * self.batch_size
        if n == 0:
            raise RuntimeError("corpus smaller than batch size")
        order = order[:n]
        bucket = max(self.cfg.time_buckets)
        decoded = self.pool.imap([self.samples[i][0] for i in order],
                                 max_frames=bucket)
        B, L = self.batch_size, self.cfg.max_chars
        H, W = self.cfg.frame_height, self.cfg.frame_width
        for lo in range(0, n, B):
            frames = np.zeros((B, bucket, H, W, 3), np.uint8)
            fl = np.zeros((B,), np.int32)
            targets = np.zeros((B, L), np.int32)
            tl = np.zeros((B,), np.int32)
            ctc = np.zeros((B, L), np.int32)
            cl = np.zeros((B,), np.int32)
            texts = []
            for k in range(B):
                f = next(decoded)
                text = self.samples[order[lo + k]][1]
                t = min(f.shape[0], bucket)
                frames[k, :t] = f[:t]
                fl[k] = t
                ids = self.vocab.encode(text)[: L - 2]
                text = self.vocab.decode(ids)
                targets[k], tl[k] = self.vocab.encode_target(text, L)
                ctc[k, : len(ids)] = ids
                cl[k] = len(ids)
                texts.append(text)
            yield VideoBatch(frames, fl, targets, tl, ctc, cl, texts)

    def __iter__(self):
        return self

    def __next__(self) -> VideoBatch:
        if self._iter is None:
            self._iter = self._epoch_stream(self.epoch)
        try:
            return next(self._iter)
        except StopIteration:
            self.epoch += 1
            self._iter = self._epoch_stream(self.epoch)
            return next(self._iter)


class PinnedPrefetcher:
    """Stages host batches on ``device`` ahead of their use (the counterpart
    of the JAX package's ``Prefetcher``).

    ``iterator`` yields tuples whose first two items are numpy arrays
    (frames, lengths). On a CUDA device a background thread copies each
    batch into one of ``PREFETCH_DEPTH + 1`` page-locked host buffers and issues
    ``non_blocking`` copies to the card on a side stream, recording an
    event; ``next`` makes the caller's stream wait on that event and yields
    ((frames, lengths) on the device, (copy start, copy end) events, the
    host tuple). A buffer is refilled only after its last copy finished.
    On the CPU (only tests ask for it) the arrays are copied plainly and
    nothing is pinned; the events are None. Every queue wait polls: an
    error in the thread raises at ``next``, and a batch that does not come
    within ``timeout`` seconds raises. After the end or the thread's error
    has been raised, every later ``next`` raises StopIteration."""

    _DONE = object()

    def __init__(self, iterator, device, timeout: float = RING_TIMEOUT):
        import torch

        self.device = torch.device(device)
        self.timeout = timeout
        self.q: queue.Queue = queue.Queue(maxsize=PREFETCH_DEPTH)
        self._stop = threading.Event()
        self._ended = False
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self.stream = torch.cuda.Stream(self.device)
            self._pinned = [None] * (PREFETCH_DEPTH + 1)
            self._done = [None] * (PREFETCH_DEPTH + 1)
        self.thread = threading.Thread(target=self._fill, args=(iterator,),
                                       daemon=True)
        self.thread.start()

    def _stage(self, k: int, frames: np.ndarray, lens: np.ndarray):
        import torch

        if not self._cuda:
            return (torch.from_numpy(np.array(frames)),
                    torch.from_numpy(np.array(lens))), (None, None)
        slot = k % len(self._pinned)
        if self._done[slot] is not None:
            self._done[slot].synchronize()     # its last copy has landed
        buf = self._pinned[slot]
        if buf is None or tuple(buf.shape) != frames.shape:
            buf = torch.empty(frames.shape, dtype=torch.uint8,
                              pin_memory=True)
            self._pinned[slot] = buf
        buf.numpy()[...] = frames
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record(self.stream)
            dev = buf.to(self.device, non_blocking=True)
            dlens = torch.from_numpy(np.array(lens)).to(self.device,
                                                        non_blocking=True)
            end.record(self.stream)
        self._done[slot] = end
        return (dev, dlens), (start, end)

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=POLL)
                return
            except queue.Full:
                continue

    def _fill(self, iterator):
        try:
            for k, item in enumerate(iterator):
                if self._stop.is_set():
                    return
                self._put((*self._stage(k, item[0], item[1]), item))
            self._put(self._DONE)
        except Exception as e:  # raised again at the consumer's next()
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        import torch

        if self._ended:
            raise StopIteration
        deadline = time.monotonic() + self.timeout
        while True:
            try:
                item = self.q.get(timeout=POLL)
                break
            except queue.Empty:
                if not self.thread.is_alive() and self.q.empty():
                    raise RuntimeError("the prefetch thread ended without "
                                       "a batch or an error")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no batch from the prefetch thread in "
                        f"{self.timeout:g} s")
        if item is self._DONE or isinstance(item, Exception):
            self._ended = True      # every later next() raises StopIteration
            if item is self._DONE:
                raise StopIteration
            raise item
        (dev, dlens), events, host = item
        if self._cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(events[1])
            dev.record_stream(cur)
            dlens.record_stream(cur)
        return (dev, dlens), events, host

    def close(self, timeout: float = 10.0) -> None:
        """Stop the thread and wait for it (at most ``timeout`` seconds)."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=timeout)
