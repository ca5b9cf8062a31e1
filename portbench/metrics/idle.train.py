"""Device idle share of the profiled stretch (``readers.idle``)."""

from portbench.readers import idle as read  # noqa: F401
