"""Model FLOP utilisation of the profiled stretch (``readers.mfu``)."""

from portbench.readers import mfu as read  # noqa: F401
