"""Tracing and timing helpers (counterpart of ``lipreading_tpu/profiling.py``).

The port's tracer, off by default:

* ``span(name, device=False)``: a named region (a context manager),
  nestable. Inside a traced unit it records its name, its parent span, its
  host start and end (``time.perf_counter_ns``) and its self time (its
  duration less the part its children cover); with ``device=True`` on a
  CUDA unit also a pair of timing events on the current stream, resolved
  when the unit ends (after its last synchronise; none is added). While a
  ``torch.profiler`` records, every span also opens a region of its name
  (``_region``), traced unit or not, so it sits in the same trace as the
  device's kernels. With neither, a span is a global check that returns
  one shared null context;
* ``count(name, n=1)``: an integer counter of the traced unit;
* ``unit(name, device)``: one traced unit (a served batch, a training
  step) from entry to return, on ``device``; None leaves it untraced (a
  plain span). At its end its spans fold into per-name totals, read by
  ``trace_totals()``; ``last_unit()`` keeps the last unit's spans;
* ``backward_span(tensor, name)``: a device span from a gradient hook on
  ``tensor`` to ``backward_done()``, after ``loss.backward()`` returns
  (registered only in a traced unit with gradients enabled);
* ``StageClock``: host milliseconds between stage marks, each closed by a
  synchronise recorded as a ``wait.sync`` span (the serving loop's and the
  training step's stage clock);
* ``capture(log_dir)``: a ``torch.profiler`` trace of the CPU and, where
  there is a CUDA device, the card, written into ``log_dir`` as a Chrome
  trace (Perfetto and ``chrome://tracing`` read it); the spans show in it;
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
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# --- the tracer -------------------------------------------------------------

_NULL = contextlib.nullcontext()
# a span's region in a torch.profiler trace: a host operator event.
# ``torch.profiler.record_function``'s user annotation is also drawn on the
# device's timeline, from the first kernel launched inside it to the last,
# as a device event, which would cover the device's idle gaps there.
_region = torch._C._profiler._RecordFunctionFast
_unit = None                 # the traced unit in progress (one at a time)
_last = None                 # the last traced unit, kept for the tests
_units = 0                   # traced units folded since the process started
_spans: dict = {}            # name -> [n, host ns, self ns, device ms,
                             #          spans whose device ms was read]
_counters: dict = {}         # name -> total


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


def _event(device):
    """A timing event recorded on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Unit:
    __slots__ = ("thread", "device", "cuda", "spans", "stack", "counters",
                 "pending")

    def __init__(self, device: torch.device):
        self.thread = threading.get_ident()
        self.device = device
        self.cuda = device.type == "cuda"
        self.spans: list[Span] = []       # in the order they opened
        self.stack: list[Span] = []
        self.counters: dict[str, int] = {}
        self.pending: list[Span] = []     # backward spans opened by hooks


class Span:
    """A traced span: ``name``, ``parent`` (a Span or None), host
    ``start_ns`` / ``end_ns``, ``child_ns`` (covered by its children),
    ``events`` (the device pair or None) and, once its unit ended,
    ``device_ms``."""

    __slots__ = ("unit", "name", "parent", "start_ns", "end_ns", "child_ns",
                 "events", "device_ms", "_rf")

    def __init__(self, unit: _Unit, name: str, device: bool):
        self.unit, self.name = unit, name
        self.parent = None
        self.start_ns = self.end_ns = self.child_ns = 0
        self.events = [] if device and unit.cuda else None
        self.device_ms = None
        self._rf = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6

    def _open(self) -> None:
        if self.events is not None:
            self.events.append(_event(self.unit.device))
        self.start_ns = time.perf_counter_ns()

    def _close(self, parent) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events.append(_event(self.unit.device))
        if parent is not None:
            parent.child_ns += self.end_ns - self.start_ns

    def __enter__(self):
        u = self.unit
        if _profiling():
            self._rf = _region(self.name)
            self._rf.__enter__()
        self.parent = u.stack[-1] if u.stack else None
        u.spans.append(self)
        u.stack.append(self)
        self._open()
        return self

    def __exit__(self, *exc):
        self._close(self.parent)
        self.unit.stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


def _mine(u) -> bool:
    return u is not None and u.thread == threading.get_ident()


def span(name: str, device: bool = False):
    """A named region (a context manager; the module doc)."""
    u = _unit
    if u is None and not _profiling():
        return _NULL
    if _mine(u):
        return Span(u, name, device)
    if _profiling():
        return _region(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the traced unit's counter ``name``."""
    u = _unit
    if _mine(u):
        u.counters[name] = u.counters.get(name, 0) + n


@contextlib.contextmanager
def unit(name: str, device):
    """One unit traced from entry to return on ``device`` (its root span is
    ``name``); ``device`` None, or a unit already in progress, makes it a
    plain span."""
    global _unit
    if device is None or _unit is not None:
        with span(name):
            yield
        return
    u = _Unit(torch.device(device))
    _unit = u
    try:
        with Span(u, name, False):
            yield
    finally:
        _unit = None
        _fold(u)


def backward_span(tensor: torch.Tensor, name: str) -> None:
    """In a traced unit with gradients enabled, open the device span
    ``name`` when ``tensor``'s gradient is computed (a hook, which the
    autograd engine may run on its own thread); ``backward_done`` closes
    it."""
    u = _unit
    if (not _mine(u) or not torch.is_grad_enabled()
            or not tensor.requires_grad):
        return

    def hook(grad):
        if _unit is u:
            s = Span(u, name, True)
            s._open()
            u.pending.append(s)

    tensor.register_hook(hook)


def backward_done() -> None:
    """Close the backward spans that hooks opened, as children of the span
    in progress (call after ``loss.backward()`` returns)."""
    u = _unit
    if not _mine(u) or not u.pending:
        return
    parent = u.stack[-1] if u.stack else None
    for s in u.pending:
        s.parent = parent
        s._close(parent)
        u.spans.append(s)
    u.pending.clear()


def _fold(u: _Unit) -> None:
    """A finished unit: resolve its device events (those the device has
    reached; no synchronise) and add its spans and counters to the
    totals."""
    global _last, _units
    for s in u.spans:
        if s.events and len(s.events) == 2 and s.events[1].query():
            s.device_ms = s.events[0].elapsed_time(s.events[1])
        t = _spans.setdefault(s.name, [0, 0, 0, 0.0, 0])
        t[0] += 1
        t[1] += s.end_ns - s.start_ns
        t[2] += s.end_ns - s.start_ns - s.child_ns
        if s.device_ms is not None:
            t[3] += s.device_ms
            t[4] += 1
        s.events = None
    for k, v in u.counters.items():
        _counters[k] = _counters.get(k, 0) + v
    _units += 1
    _last = u


def trace_totals() -> dict:
    """Totals over the traced units since the process started:
    {"units", "spans": {name: {"n", "host_ms", "self_ms", "device_ms"
    (None where no device event was resolved)}}, "counters": {name:
    total}}."""
    return {"units": _units,
            "spans": {k: {"n": n, "host_ms": h / 1e6, "self_ms": s / 1e6,
                          "device_ms": d if nd else None}
                      for k, (n, h, s, d, nd) in _spans.items()},
            "counters": dict(_counters)}


def last_unit() -> tuple[list[Span], dict] | None:
    """The last traced unit's spans (in the order they opened) and
    counters; None before the first."""
    return None if _last is None else (list(_last.spans),
                                       dict(_last.counters))


class StageClock:
    """Host milliseconds between ``mark(stage)`` calls, summed by stage
    into ``ms`` (a dict of the caller's, or a new one). Each mark closes its
    stage after a synchronise, recorded as a ``wait.sync`` span: of the
    current stream by default, the clock synchronised at its start too
    (serving: the prefetcher's copy on its side stream goes on
    overlapping); with ``whole_device``, of the whole device, from an
    unsynchronised start (a training step: the step before it may still
    run, and its tail falls in the first stage)."""

    def __init__(self, device, ms: dict | None = None,
                 whole_device: bool = False):
        self.device = torch.device(device)
        self.ms = {} if ms is None else ms
        self.whole_device = whole_device
        if not whole_device:
            self._sync()
        self._t = time.perf_counter()

    def _sync(self) -> None:
        if self.device.type != "cuda":
            return
        with span("wait.sync"):
            if self.whole_device:
                torch.cuda.synchronize(self.device)
            else:
                torch.cuda.current_stream(self.device).synchronize()

    def mark(self, stage: str) -> None:
        self._sync()
        t = time.perf_counter()
        self.ms[stage] = self.ms.get(stage, 0.0) + (t - self._t) * 1e3
        self._t = t


# --- captures and timers -----------------------------------------------------


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
    from lipreading_tpu_torch.models import nn
    from lipreading_tpu_torch.ops import ctc, decode, roi
    from lipreading_tpu_torch.ops import flash_attention as fa

    wrappers = (roi.sample_rois, decode.ctc_greedy_ids, ctc.ctc_lattice_fwd,
                ctc.ctc_lattice_bwd, *fa.WRAPPERS, nn.conv3d_dgrad)
    names = ("roi_sampler", "ctc_greedy", "ctc_lattice_fwd",
             "ctc_lattice_bwd", *(w.__name__ for w in fa.WRAPPERS),
             "conv3d_dgrad")
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
