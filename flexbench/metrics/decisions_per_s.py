"""Admission decisions per second of the window: every run's decisions,
primary queues and reclaim passes alike, as the program's
``admission.DECISIONS`` counts them, over all the window's time."""


def read(ctx):
    w = ctx.get("window")
    if not w or w["seconds"] <= 0 or w["decisions"] <= 0:
        return None
    return w["decisions"] / w["seconds"]
