"""Device ms a step of the program's span ``conformer.attn``, summed over
the Conformer blocks: each block's relative-position attention from the
projections to W_o, the positional term and its shift included (forward
only; None off a card or where the program has no such span;
``program_trace.span``)."""

from portbench.program_trace import span

read = span("conformer.attn", "device_ms")
