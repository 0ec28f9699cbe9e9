"""Milliseconds of device busy time (the union of the device's operation
intervals in the traced study) per run and slot."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] * 1e3 / ctx["slots"]
