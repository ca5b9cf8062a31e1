"""Device ms a step of the program's span ``model.stem_backward``: from a
CUDA event recorded when the stem's output gets its gradient to one
recorded when ``loss.backward()`` returns (None off a card;
``program_trace.span``)."""

from portbench.program_trace import span

read = span("model.stem_backward", "device_ms")
