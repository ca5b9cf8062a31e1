"""Device ms a step of the program's span ``model.stem`` (the frontend's
forward, between two CUDA events; None off a card;
``program_trace.span``)."""

from portbench.program_trace import span

read = span("model.stem", "device_ms")
