"""Percent of the traced study's wall time in which nothing ran on the
device: 100 * (1 - busy / window)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
