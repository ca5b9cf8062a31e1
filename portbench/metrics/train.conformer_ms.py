"""Device ms a step of the program's span ``model.conformer`` (the
Conformer blocks' forward, between two CUDA events; None off a card or
where the program has no such span; ``program_trace.span``)."""

from portbench.program_trace import span

read = span("model.conformer", "device_ms")
