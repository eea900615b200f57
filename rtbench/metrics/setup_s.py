"""From the process's start to the first timed call: imports, CUDA
context, kernel library (built or loaded), scene made and read, inputs,
warm-up (host clock, s)."""


def read(ctx):
    return ctx.setup_s
