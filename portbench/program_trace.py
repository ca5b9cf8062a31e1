"""The arithmetic that the readers of the program's tracer share
(``lipreading_tpu_torch.profiling.trace_totals()``: spans and counters
summed over the traced units, the window's marked batches or steps, since
the process started). Each reader divides by those units, and returns None
where the program has no tracer or traced no unit, or where a device span
was never timed (off a card)."""

from __future__ import annotations


def totals():
    """The program's trace totals, or None (no tracer, no traced unit)."""
    from lipreading_tpu_torch import profiling

    read = getattr(profiling, "trace_totals", None)
    t = read() if read is not None else None
    return t if t and t["units"] else None


def per_unit(value):
    """A reader of ``value(totals)`` (None passes through) over the traced
    units."""

    def read(run):
        t = totals()
        v = value(t) if t is not None else None
        return None if v is None else v / t["units"]

    return read


def span(name: str, field: str):
    """A reader of span ``name``'s ``field`` (``host_ms``, ``self_ms`` or
    ``device_ms``) a unit."""

    def value(t):
        s = t["spans"].get(name)
        return None if s is None else s[field]

    return per_unit(value)


def counter(name: str):
    """A reader of counter ``name`` a unit (0 where no unit counted it)."""
    return per_unit(lambda t: float(t["counters"].get(name, 0)))


def waits_ms(t, but=()) -> float:
    """Host ms of the ``wait.*`` spans (the host reading or waiting for the
    device), but those named in ``but``."""
    return sum(s["host_ms"] for k, s in t["spans"].items()
               if k.startswith("wait.") and k not in but)


def outside_waits(root: str):
    """A reader of the host ms a unit of the root span ``root`` outside
    every ``wait.*`` span: the host issuing work."""

    def value(t):
        s = t["spans"].get(root)
        return None if s is None else s["host_ms"] - waits_ms(t)

    return per_unit(value)


def mean_self_ms(name: str):
    """A reader of the mean self host ms of one span ``name``."""

    def read(run):
        t = totals()
        s = t["spans"].get(name) if t is not None else None
        return s["self_ms"] / s["n"] if s else None

    return read


def ratio(num: str, den: str):
    """A reader of counter ``num`` over counter ``den`` (None where ``den``
    is 0)."""

    def read(run):
        t = totals()
        c = t["counters"] if t is not None else {}
        return c[num] / c[den] if c.get(den) else None

    return read
