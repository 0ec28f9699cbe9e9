"""Node-table sweeps of the wavefront rounds (the program's
``admission.SWEEPS``) per run and slot of the traced study: in this
benchmark's cells, the reclaim passes' sweeps."""


def read(ctx):
    c = ctx.get("counters")
    if not c:
        return None
    return c["sweeps"] / ctx["slots"]
