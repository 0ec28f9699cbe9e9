"""Percent of the reclaim passes' least time that the top-K sweep
kernels' device time reaches.

Each pass judges every pooled task against every node at least once.
Its least time at R = 2: the node table (est and reserved, 16 N bytes;
n_tasks, 4 N; src_count, 256 N) and the task rows (r, source and flag,
16 q) read once and the placements written (4 q); or 4 R + 5 = 13
float32 operations per (task, node), as the sweep counts them
(``chip_smoke.py``'s ``_batch_bound``), whichever takes longer at the
chip's peaks.  A pass is counted once, however many sweeps its rounds
take.  The pools' lengths come from the reference's replay of the study.
"""

KERNELS = ("flex_batch_topk_kernel", "flex_batch_topk_merge")


def bound_s(n: int, q: int, peaks: dict) -> float:
    by_bytes = (276 * n + 20 * q) / peaks["hbm_bytes_per_s"]
    by_ops = 13 * q * n / peaks["fp32_flops_per_s"]
    return max(by_bytes, by_ops)


def read(ctx):
    tr, work = ctx.get("trace"), ctx.get("work")
    if not tr or not work:
        return None
    t_ns = sum(e.dur_ns for e in tr["device"]
               if any(k in e.name for k in KERNELS))
    pools = [q for q in work["reclaim"] if q > 0]
    if t_ns <= 0 or not pools:
        return None
    least = sum(bound_s(ctx["n_nodes"], q, ctx["peaks"]) for q in pools)
    return 100.0 * least / (t_ns / 1e9)
