"""Tracing and timing helpers (counterpart of ``lipreading_tpu/profiling.py``):

* ``annotate(name)``: a named region (``torch.profiler.record_function``)
  that shows in a ``capture`` trace, nestable;
* ``capture(log_dir)``: a ``torch.profiler`` trace of the CPU and, where
  there is a CUDA device, the card, written into ``log_dir`` as a Chrome
  trace (Perfetto and ``chrome://tracing`` read it);
* ``Timer``: seconds a call after warm-up, the outputs' devices
  synchronised;
* ``device_memory_stats()``: each CUDA device's memory in use, its peak and
  its size.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def annotate(name: str):
    """A named region in the trace (a context manager)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def capture(log_dir: str):
    """Trace the block into ``log_dir/trace-<pid>-<ns>.json``; yields that
    path (written when the block ends). On the card a profile now and then
    records no device event: a caller that needs one checks the trace and
    takes it again."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested lists, tuples,
    dicts)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


class Timer:
    """Steady-state seconds a call of ``fn``."""

    def __init__(self, fn, warmup: int = 2):
        self.fn = fn
        self.warmup = warmup

    @staticmethod
    def _sync(out) -> None:
        for d in _devices(out, set()):
            torch.cuda.synchronize(d)

    def measure(self, *args, reps: int = 10) -> float:
        """Seconds a call over ``reps`` calls after ``warmup`` calls; the
        devices of the last call's outputs are synchronised before each
        clock reading."""
        out = None
        for _ in range(self.warmup):
            out = self.fn(*args)
        self._sync(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = self.fn(*args)
        self._sync(out)
        return (time.perf_counter() - t0) / reps


def device_memory_stats() -> dict:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}} for
    each CUDA device (the caching allocator's allocated bytes and their
    peak, the device's total memory); {} where there is none."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return stats
