"""Decoder steps a batch over every joint-beam call (``ops/decode.
early_exit_scan``'s counter ``beam.steps``; ``program_trace.counter``)."""

from portbench.program_trace import counter

read = counter("beam.steps")
