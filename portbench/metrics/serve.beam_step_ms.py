"""Self host ms of one ``beam.step`` span (``ops/decode.early_exit_scan``:
a step's launches; the read of ``finished`` is the span ``wait.beam``,
outside it; ``program_trace.mean_self_ms``)."""

from portbench.program_trace import mean_self_ms

read = mean_self_ms("beam.step")
