"""The arithmetic that the per-layer metric readers share
(``metrics/<name>.py`` binds one of these, or reads on its own)."""

from __future__ import annotations

from portbench.frozen.flops import bf16_peak


def idle(run):
    """Share of the profiled stretch (steady units without stage marks) in
    which no operation ran on the device, from torch.profiler's trace."""
    p = run.prof
    return 100.0 * (p["window_s"] - p["busy_s"]) / p["window_s"]


def mfu(run):
    """FLOPs the profiled units need (``frozen/flops.py``), over the
    profiled stretch's wall time, against the card's dense bfloat16 peak;
    None off a card with a known peak."""
    p = run.prof
    peak = bf16_peak(run.device_kind)
    if not peak or not p["flops"]:
        return None
    return 100.0 * p["flops"] / p["window_s"] / peak


def span_ms(*stages):
    """A reader of the host milliseconds a unit (a batch or a step) of the
    program's synchronised stage marks ``stages``, summed over the traced
    window's units and divided by them; None where no unit was marked."""

    def read(run):
        w = run.window
        if not w["span_units"] or not any(s in w["spans_ms"] for s in stages):
            return None
        return sum(w["spans_ms"].get(s, 0.0) for s in stages) / w["span_units"]

    return read
