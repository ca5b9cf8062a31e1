"""Device ms a step of the program's span ``conformer.conv``, summed over
the Conformer blocks: each block's convolution module (pointwise, GLU,
depthwise convolution, BatchNorm, swish, pointwise; forward only; None off
a card or where the program has no such span; ``program_trace.span``)."""

from portbench.program_trace import span

read = span("conformer.conv", "device_ms")
