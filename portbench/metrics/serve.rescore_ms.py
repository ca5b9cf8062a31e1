"""Host ms a batch of the serving stage rescore (``serve.StageClock``;
``readers.span_ms``)."""

from portbench.readers import span_ms

read = span_ms("rescore")
