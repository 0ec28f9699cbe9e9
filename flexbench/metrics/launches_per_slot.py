"""Device kernels launched per run and slot in the traced study (copies
and fills not counted)."""
from flexbench.devtrace import is_kernel


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    n = sum(1 for e in tr["device"] if is_kernel(e))
    if n == 0:
        return None
    return n / ctx["slots"]
