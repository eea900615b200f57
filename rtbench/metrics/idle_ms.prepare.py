"""Device idle a call, in ms, while the host was under the program's span
``hrt.prepare`` at any depth (:mod:`rtbench.program_spans`); nothing where
the program records no spans."""
from rtbench import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "hrt.prepare")
