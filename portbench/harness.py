"""The benchmark's machinery, driven by data: ``BENCHMARK.json`` names the
cells, configurations and metrics; each configuration is a file under
``configs/``, each traffic mix a file under ``traffic/`` whose ``driver``
names a module of ``drivers/``, each cell's comparison limits a file
under ``cells/``, and each metric a reader under ``metrics/`` (a module
with ``read(run) -> float | None``: None where it finds nothing to read,
and the metric is then left out of the line).

One run: the driver's set-up (loading, warm-up, the steps or batches the
comparison follows), the window (``--seconds``; with ``--trace 1`` stage
marks in it, then a few units under ``torch.profiler``), the device's peak
memory, the program's state freed, the comparison with the plain
reference, the check that no module of JAX or of the JAX package was
loaded, and one JSON line."""

from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lipreading_tpu")
PROFILE_ATTEMPTS = 5


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic, limits
    and the metrics it reports (``end_to_end`` and ``per_layer``, each a
    list of the BENCHMARK.json entries)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(root / cfgs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "cells" / f"{name}.json")["limits"]

    def mine(m):
        return name in m.get("workloads", [name])

    return SimpleNamespace(
        name=name, chips=w["chips"], conf=conf, traffic=traffic,
        limits={k: v["limit"] for k, v in limits.items()},
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)])


def reader(metric: str):
    """The module ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict):
    """The ``Driver`` of ``drivers/<traffic["driver"]>.py``."""
    return importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").Driver


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (each compared whole)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


# --- the device profile ----------------------------------------------------


def _union(intervals):
    """Merged [start, end] intervals (sorted)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t, reach=4096) -> str:
    """The name of the latest-starting host event that spans ``t`` (the
    innermost, since host events nest), looking back at most ``reach``
    events."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(python between host events)"


def summarise_profile(events, wall_s: float) -> dict:
    """A traced stretch's events ((name, on the device, start ns, end ns))
    -> {"busy_s", "window_s", "kernels": {name: device s}, "breakdown"}:
    busy is the union of the device's intervals; each idle gap between
    them is named by the innermost host event running at its middle."""
    dev = [(n, s, e) for n, d, s, e in events if d]
    host = sorted((s, e, n) for n, d, s, e in events if not d)
    kernels: dict[str, float] = {}
    for name, s, e in dev:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
    merged = _union([[s, e] for _, s, e in dev])
    busy = sum(e - s for s, e in merged) * 1e-9
    starts = [h[0] for h in host]
    gaps: dict[str, float] = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        key = (_innermost(host, starts, (e0 + s1) / 2) if host
               else "(host events not recorded)")
        gaps[key] = gaps.get(key, 0.0) + (s1 - e0) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": wall_s, "kernels": kernels,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in idle]}}


def _profile_once(fn, cuda: bool, host: bool):
    from torch.profiler import ProfilerActivity, profile

    import torch

    acts = (([ProfilerActivity.CPU] if host or not cuda else [])
            + ([ProfilerActivity.CUDA] if cuda else []))
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the raw events: building the profiler's event tree of a serving
    # batch's hundreds of thousands of launches takes minutes
    from torch.autograd import DeviceType

    events = [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
               e.end_ns()) for e in prof.profiler.kineto_results.events()]
    return out, events, wall


def profiled(fn, log, gaps_fn):
    """Run ``fn()`` (which returns a result) under torch.profiler recording
    the device alone (the host's events would slow a host-bound loop and
    inflate the idle share), again up to ``PROFILE_ATTEMPTS`` times while a
    profile records no device event -> (result, summary). RuntimeError
    where none records one. ``gaps_fn`` (a shorter stretch of the same
    work) is then run with the host's events recorded too, to name the
    idle gaps by what the host was doing. Without a CUDA device (the CPU
    tests) the host's events alone are summarised."""
    import torch

    cuda = torch.cuda.is_available()

    def has_device(events):
        return not cuda or any(d for _, d, _, _ in events)

    for attempt in range(PROFILE_ATTEMPTS):
        out, events, wall = _profile_once(fn, cuda, host=False)
        if has_device(events):
            break
        log(f"[portbench] profile {attempt + 1} recorded no device event")
    else:
        raise RuntimeError(f"{PROFILE_ATTEMPTS} profiles recorded no "
                           "device event")
    summary = summarise_profile(events, wall)
    if cuda:
        for _ in range(PROFILE_ATTEMPTS):
            _, events, wall = _profile_once(gaps_fn, cuda, host=True)
            if has_device(events):
                summary["breakdown"]["idle_gaps"] = summarise_profile(
                    events, wall)["breakdown"]["idle_gaps"]
                break
    return out, summary


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi reports them ("cpu"
    off the card)."""
    import subprocess

    import torch

    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{torch.cuda.get_device_name(device)}, power limit not read"


# --- one run ---------------------------------------------------------------


def decide(nums: dict, limits: dict) -> tuple[dict, bool]:
    """The comparison's numbers against the cell's limits -> (each number
    beside its limit, ``correct``: every number a number and within its
    limit)."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    correct = all(not math.isnan(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return checks, correct


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", root: Path = ROOT,
             assets_dir: str | None = None, log=None,
             overrides: dict | None = None) -> dict:
    """One run of a cell -> the result dict (``correct`` decided).
    ``overrides`` ({"conf", "traffic", "limits"}: dicts merged over the
    cell's) lets the CPU tests drive a cell at a tiny size."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = load_cell(name, root)
    for k, v in (overrides or {}).items():
        base = getattr(cell, k)
        setattr(cell, k, {**base, **{n: x for n, x in v.items()
                                     if k != "limits" or n in base}})
    assets_dir = assets_dir or str(root / "assets")
    Driver = driver(cell.traffic)
    drv = Driver(cell, seed, torch.device(device), assets_dir, log)
    log(f"[portbench] {name} seed {seed} on {device_label(drv.device)}")
    drv.setup()
    run = SimpleNamespace(cell=cell, driver=drv, trace=trace)
    run.window = drv.window(seconds, marked=trace)
    log(f"[portbench] window: {run.window['units']} units in "
        f"{run.window['seconds']:.3f} s; each unit's s: "
        + " ".join(f"{u:.3f}" for u in run.window["unit_s"]))
    run.setup_s = run.window["start"] - t_start
    if trace:
        run.prof = drv.profile()
    cuda = drv.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(drv.device) if cuda else 0
    drv.release()
    checks, correct = decide(drv.check(), cell.limits)
    run.device_kind = (torch.cuda.get_device_name(drv.device) if cuda
                       else "cpu")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        elif not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(drv.device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.window["attempted"],
              "failed": run.window["failed"], "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = run.prof["busy_s"]
        dev["window_s"] = run.prof["window_s"]
        result["breakdown"] = run.prof["breakdown"]
    result["checks"] = checks
    return result
