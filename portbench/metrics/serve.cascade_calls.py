"""Cascade calls a batch (``infer.transcribe_cascade``'s counter
``cascade.calls``): the batch's one, and one for each clip decoded by shot
(``program_trace.counter``)."""

from portbench.program_trace import counter

read = counter("cascade.calls")
