"""Host ms a batch of the serving stage segmented, the decodes by shot
(``serve.StageClock``; ``readers.span_ms``)."""

from portbench.readers import span_ms

read = span_ms("segmented")
