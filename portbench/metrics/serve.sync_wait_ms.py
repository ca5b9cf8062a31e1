"""Host ms a batch in the program's ``wait.*`` spans (the host reading a
device value, or copying from host memory, and waiting for the stream),
but the stage clock's synchronises (``wait.sync``)."""

from portbench.program_trace import per_unit, waits_ms

read = per_unit(lambda t: waits_ms(t, but=("wait.sync",)))
