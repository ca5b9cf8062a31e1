"""Host ms a step of the training step's ``forward`` stage
(``Trainer.train_step(stage_ms=)``, synchronised at each mark, every step
launched in the traced window whole; ``readers.span_ms``)."""

from portbench.readers import span_ms

read = span_ms("forward")
