"""Percent of the sequential queues' least time that the queue kernel's
device time reaches.

The least time of one queue of q tasks over N nodes at R = 2 (the bound
of ``chip_smoke.py``'s ``_queue_bound``): the node table's est, reserved,
requested, n_tasks and src_count read once (284 N bytes) and the last
four written once (276 N), the task rows, sources and flags read and the
placements written (33 q); or 4 R + 6 = 14 float32 operations per (task,
node), whichever takes longer at the chip's peaks.  The queues' lengths
come from the reference's replay of the study, so the work is the same
whatever kernel does it.
"""

KERNELS = ("flex_admit_kernel",)


def bound_s(n: int, q: int, peaks: dict) -> float:
    by_bytes = (560 * n + 33 * q) / peaks["hbm_bytes_per_s"]
    by_ops = 14 * q * n / peaks["fp32_flops_per_s"]
    return max(by_bytes, by_ops)


def read(ctx):
    tr, work = ctx.get("trace"), ctx.get("work")
    if not tr or not work:
        return None
    t_ns = sum(e.dur_ns for e in tr["device"]
               if any(k in e.name for k in KERNELS))
    queues = [q for q in work["queues"] if q > 0]
    if t_ns <= 0 or not queues:
        return None
    least = sum(bound_s(ctx["n_nodes"], q, ctx["peaks"]) for q in queues)
    return 100.0 * least / (t_ns / 1e9)
