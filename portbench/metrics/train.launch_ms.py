"""Host ms a step of ``Trainer.train_step`` (the span ``train.step``)
outside every ``wait.*`` span: the host issuing the step's work
(``program_trace.outside_waits``)."""

from portbench.program_trace import outside_waits

read = outside_waits("train.step")
