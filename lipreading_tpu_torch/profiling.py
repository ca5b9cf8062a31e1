"""Tracing and timing helpers (counterpart of ``lipreading_tpu/profiling.py``):

* ``annotate(name)``: a named region (``torch.profiler.record_function``)
  that shows in a ``capture`` trace, nestable;
* ``capture(log_dir)``: a ``torch.profiler`` trace of the CPU and, where
  there is a CUDA device, the card, written into ``log_dir`` as a Chrome
  trace (Perfetto and ``chrome://tracing`` read it);
* ``Timer``: seconds a call after warm-up, the outputs' devices
  synchronised;
* ``cuda_ms``: device milliseconds a call by CUDA events around
  back-to-back calls after warm-up (card tensors only);
* ``device_kernels``: one call under ``torch.profiler``, its device time
  kernel by kernel (card tensors only);
* ``device_memory_stats()``: each CUDA device's memory in use, its peak and
  its size;
* for the measurement entries (``microbench``, ``roofline_preprocess``,
  ...): ``entry_device`` (the card unless the caller asks for the CPU),
  ``device_label`` (what each printed result names its device by) and
  ``launch_counts`` (the kernel wrappers' launch counters).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
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


def _tensors(out, found: list) -> list:
    """The tensors in ``out`` (nested lists, tuples, dicts)."""
    if isinstance(out, torch.Tensor):
        found.append(out)
    elif isinstance(out, dict):
        for v in out.values():
            _tensors(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _tensors(v, found)
    return found


class Timer:
    """Steady-state seconds a call of ``fn``."""

    def __init__(self, fn, warmup: int = 2):
        self.fn = fn
        self.warmup = warmup

    @staticmethod
    def _sync(out) -> None:
        for d in {t.device for t in _tensors(out, []) if t.is_cuda}:
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


def cuda_ms(fn, *args, reps: int = 10, warmup: int = 2) -> float:
    """Device milliseconds a call of ``fn(*args)``: ``warmup`` calls, then
    a CUDA event before and after ``reps`` calls launched back to back
    (no host synchronisation between them). The tensors among ``args``
    (nested lists, tuples, dicts) must all lie on one CUDA device; a CPU
    tensor, or no tensor at all, raises ValueError: there is no device
    clock to read there (time a CPU call with ``Timer``)."""
    ts = _tensors(args, [])
    devs = {t.device for t in ts}
    if not ts or any(d.type != "cuda" for d in devs) or len(devs) > 1:
        raise ValueError(f"cuda_ms times calls on one CUDA device; its "
                         f"tensors lie on {sorted(map(str, devs)) or 'none'}")
    dev = devs.pop()
    with torch.cuda.device(dev):
        for _ in range(warmup):
            fn(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def device_kernels(fn, *args, attempts: int = 5) -> tuple[float, dict]:
    """One call of ``fn(*args)`` after a warm-up call, under
    ``torch.profiler`` -> (the call's wall ms, {kernel, copy or fill name:
    device ms}). A profile that records no device event (on the H100 one
    now and then comes back empty, and in a long-running process every
    one may) is taken again, up to ``attempts`` in all; where none records
    one the dict is empty, and the caller reports the profile as not
    measured. ValueError without a CUDA device, or where a tensor among
    ``args`` lies on the CPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if (not torch.cuda.is_available()
            or any(not t.is_cuda for t in _tensors(args, []))):
        raise ValueError("device_kernels profiles calls on a CUDA device")
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        split: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                split[e.name] = (split.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3)
        if sum(split.values()) > 0:
            return wall, split
        time.sleep(1.0)
    return wall, {}


def entry_device(device: str) -> torch.device:
    """The device a measurement entry runs on: ``device`` (default "cuda"),
    refused with SystemExit where it names CUDA and no card is present."""
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass device=cpu to run on the CPU")
    return torch.device(device)


def device_label(device) -> str:
    """"cpu" for a CPU run; on the card, its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (the card's name from torch where nvidia-smi cannot be
    read)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index or 0
    name = torch.cuda.get_device_name(index)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{name}, power limit not read"


def launch_counts() -> dict:
    """{kernel: launches so far} of every kernel wrapper, by the names of
    ``chip_smoke.py``'s kernel rows. A wrapper counts only where it
    launches its kernel (a CUDA tensor), never its plain version."""
    from lipreading_tpu_torch.ops import ctc, decode, roi
    from lipreading_tpu_torch.ops import flash_attention as fa

    wrappers = (roi.sample_rois, decode.ctc_greedy_ids, ctc.ctc_lattice_fwd,
                ctc.ctc_lattice_bwd, *fa.WRAPPERS)
    names = ("roi_sampler", "ctc_greedy", "ctc_lattice_fwd",
             "ctc_lattice_bwd", *(w.__name__ for w in fa.WRAPPERS))
    return {n: w.launches for n, w in zip(names, wrappers)}


def launches_since(before: dict) -> dict:
    """The kernels launched since ``before = launch_counts()``, with their
    counts (kernels not launched left out)."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


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
