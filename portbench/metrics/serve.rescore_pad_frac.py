"""Of the rows the cascade's rescore leg searched (counter ``beam.rows``),
the share that repeats a row up to ``rescore_bucket`` (counter
``beam.pad_rows``; ``program_trace.ratio``)."""

from portbench.program_trace import ratio

read = ratio("beam.pad_rows", "beam.rows")
