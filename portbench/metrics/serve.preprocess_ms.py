"""Host ms a batch of the serving stages detect, track, landmarks and roi
(``serve.StageClock``; ``readers.span_ms``)."""

from portbench.readers import span_ms

read = span_ms("detect", "track", "landmarks", "roi")
