"""Host ms a batch in the program's span ``model.encode``
(``models/lipreader.encode``: the stem and the encoder, launched;
``program_trace.span``)."""

from portbench.program_trace import span

read = span("model.encode", "host_ms")
