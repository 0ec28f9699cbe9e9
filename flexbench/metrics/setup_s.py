"""Seconds from the process's start to the first timed study: imports,
the kernels' build or load, the trace and its noise, the transfer to the
device and the warm-up study."""


def read(ctx):
    return ctx.get("setup_s")
