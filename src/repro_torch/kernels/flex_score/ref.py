"""Plain PyTorch versions of the Flex filter+score+argmax step.

Mirror ``repro.kernels.flex_score.ref`` (``pick_node_ref`` and its batched
and top-K forms) as the reference runs them, jitted, and the reference's
sequential scan over a queue (``admit_queue_ref``, the ``lax.scan`` of
``repro.api.admission.admit_queue``): XLA contracts
``penalty * est + reserved`` and ``w_load * max_R(load) + w_src *
src_frac`` into fused multiply-adds, so these versions round each once
(:func:`repro_torch.core.numerics.fma`), exactly as the CUDA kernels do
with ``__fmaf_rn``.  The CPU tests hold them bit-equal to the reference's
interpret-mode Pallas kernels, and ``chip_smoke.py`` holds the CUDA
kernels bit-equal to them on the card.

Each also takes a leading run axis (B independent runs, each with its
own node table and tasks, as ``core.simulator.simulate_runs`` holds
them): est (B, N, R) instead of (N, R), and every other per-run argument
with B in front.  The run-axis forms loop over the runs, each run exactly
the unbatched version; nothing on the card's main path calls them.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import fma

# Masking convention shared with repro_torch.api.admission.NEG_INF: a
# finite sentinel keeps max/argmax NaN-free; "any node fits" is decided by
# ``best > NEG_INF / 2``.
NEG_INF = -1e30


def over_runs(fn, runs: int, *args):
    """``fn`` on each run's slice of ``args``, its outputs stacked along a
    new leading run axis.  A tensor argument of at least one dimension
    leads with the run axis; Python numbers and 0-d tensors are shared by
    every run."""
    def part(x, b):
        if isinstance(x, torch.Tensor) and x.dim() > 0:
            return x[b]
        return x

    outs = [fn(*(part(x, b) for x in args)) for b in range(runs)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def pick_node_ref(est, reserved, src_frac, r_task, penalty, w_load, w_src,
                  cap=1.0):
    """est/reserved (N, R); src_frac (N,); r_task (R,) or scalar.

    ``penalty``/``cap``/``w_load``/``w_src`` are Python floats or 0-d f32
    tensors.  Nothing here waits for the device.
    Returns (idx () i32 or -1, best_score () f32, any_feasible () bool).
    With a run axis (est (B, N, R), src_frac (B, N), r_task (B, R), the
    scalars (B,) or shared) each output leads with B.
    """
    if est.dim() == 3:
        return over_runs(pick_node_ref, est.shape[0], est, reserved,
                         src_frac, r_task, penalty, w_load, w_src, cap)
    load = fma(penalty, est, reserved)
    feasible = (load + r_task <= cap).all(dim=-1)
    inner = fma(w_load, load.max(dim=-1).values, w_src * src_frac)
    score = torch.where(feasible, -inner, NEG_INF)
    any_feasible = feasible.any()
    best = torch.argmax(score).to(torch.int32)
    idx = torch.where(any_feasible, best, -1).to(torch.int32)
    return idx, score.max(), any_feasible


def commit_one(reserved, requested, n_tasks, src_count, idx, ok, request,
               src) -> None:
    """The reference's commit of one decision, in place: node
    ``c = max(idx, 0)`` adds ``ok * request`` to reserved and requested and
    ``ok`` to n_tasks and src_count[c, src], so a decision that places
    nothing adds zeros to node 0.  ``idx`` () i32, ``ok`` () bool,
    ``request`` (R,), ``src`` () i32; or, one decision in each of B runs,
    the tables (B, N, ...) (contiguous), idx/ok/src (B,) and request
    (B, R): run b commits to row ``b * N + c`` of the flattened tables."""
    if n_tasks.dim() == 2:
        runs, n = n_tasks.shape
        i = torch.clamp(idx, min=0) + n * torch.arange(
            runs, dtype=idx.dtype, device=idx.device)
        reserved, requested, n_tasks = (
            x.view((runs * n,) + tuple(x.shape[2:]))
            for x in (reserved, requested, n_tasks))
        add_f = ok.to(torch.float32)[:, None] * request
    else:
        i = torch.clamp(idx, min=0).reshape(1)
        add_f = (ok.to(torch.float32) * request).reshape(1, -1)
    add_i = ok.to(torch.int32).reshape(i.shape)
    reserved.index_add_(0, i, add_f)
    requested.index_add_(0, i, add_f)
    n_tasks.index_add_(0, i, add_i)
    src_count.view(-1).index_add_(
        0, i * src_count.shape[-1] + src.reshape(i.shape), add_i)


def src_share(n_tasks, src_count, src) -> torch.Tensor:
    """(N,) f32 Flex same-source share of source ``src`` () i32 on each
    node: ``src_count[:, src] / max(n_tasks, 1)``, an IEEE division."""
    same = src_count.index_select(1, src.reshape(1)).squeeze(1)
    return same.float() / torch.clamp(n_tasks, min=1).float()


def admit_queue_ref(est, reserved, requested, n_tasks, src_count, task_mat,
                    srcs, valid):
    """Plain version of the queue kernel: a queue admitted in order, one
    :func:`pick_node_ref` and one :func:`commit_one` per task.

    est (N, R); reserved, requested (N, R), n_tasks (N,) i32 and src_count
    (N, 64) i32, updated IN PLACE; task_mat (Q, R + 4) rows ``[r...,
    penalty, cap, w_load, w_src]``; srcs (Q,) i32; valid (Q,) bool.  Task
    q's src_frac is the Flex same-source share ``src_count[:, src] /
    max(n_tasks, 1)`` of the state the tasks before it left.  Nothing here
    waits for the device.  Returns placements (Q,) i32, a node or -1.
    With a run axis (every argument leading with B) each run admits its
    own queue into its own tables; placements (B, Q).
    """
    if est.dim() == 3:
        return over_runs(admit_queue_ref, est.shape[0], est, reserved,
                         requested, n_tasks, src_count, task_mat, srcs,
                         valid)
    r = est.shape[1]
    out = []
    for k in range(task_mat.shape[0]):
        row, src = task_mat[k], srcs[k]
        src_frac = src_share(n_tasks, src_count, src)
        idx, _, feasible = pick_node_ref(est, reserved, src_frac, row[:r],
                                         row[r], row[r + 2], row[r + 3],
                                         cap=row[r + 1])
        ok = feasible & valid[k]
        idx = torch.where(ok, idx, -1).to(torch.int32)
        commit_one(reserved, requested, n_tasks, src_count, idx, ok, row[:r],
                   src)
        out.append(idx)
    if not out:
        return torch.empty(0, dtype=torch.int32, device=est.device)
    return torch.stack(out)


def _batch_scores(est, reserved, src_frac, r_task, penalty, w_load, w_src,
                  cap):
    """(Q, N) scores of Q tasks against the node table, NEG_INF where a
    node does not fit; per (task, node) the arithmetic of
    :func:`pick_node_ref`."""
    load = fma(penalty[:, None, None], est[None], reserved[None])  # (Q,N,R)
    feasible = (load + r_task[:, None, :] <= cap[:, None, None]).all(dim=-1)
    inner = fma(w_load[:, None], load.max(dim=-1).values,
                w_src[:, None] * src_frac)
    return torch.where(feasible, -inner, NEG_INF)


def pick_node_batch_ref(est, reserved, src_frac, r_task, penalty, w_load,
                        w_src, cap):
    """Batched version: each of Q tasks against the node table.

    est/reserved (N, R); src_frac (Q, N); r_task (Q, R); penalty, w_load,
    w_src and cap (Q,) f32.  Row q equals :func:`pick_node_ref` of task q
    bit for bit.  With a run axis every argument leads with B and so does
    every output.

    Returns (idx (Q,) i32 or -1, best_score (Q,) f32, any_feasible (Q,)).
    """
    if est.dim() == 3:
        return over_runs(pick_node_batch_ref, est.shape[0], est, reserved,
                         src_frac, r_task, penalty, w_load, w_src, cap)
    score = _batch_scores(est, reserved, src_frac, r_task, penalty, w_load,
                          w_src, cap)
    best = score.max(dim=1).values
    any_feasible = best > NEG_INF / 2
    idx = torch.where(any_feasible, torch.argmax(score, dim=1), -1)
    return idx.to(torch.int32), best, any_feasible


def pick_node_batch_topk_ref(est, reserved, src_frac, r_task, penalty,
                             w_load, w_src, cap, k):
    """Top-``k`` version: each task's k best nodes.

    Shapes as in :func:`pick_node_batch_ref`.  Slots are ordered by
    (score desc, node index asc), the order of ``jax.lax.top_k``: a stable
    descending sort keeps equal scores in index order (``torch.topk``
    promises no order among ties).  Slots past a task's feasible nodes,
    and past N when k > N, are (-1, NEG_INF).  Column 0 is
    :func:`pick_node_batch_ref`'s decision.  With a run axis every
    argument but ``k`` leads with B and so does every output.

    Returns (idx (Q, k) i32, score (Q, k) f32, any_feasible (Q,)).
    """
    if est.dim() == 3:
        return over_runs(
            lambda *a: pick_node_batch_topk_ref(*a, k), est.shape[0], est,
            reserved, src_frac, r_task, penalty, w_load, w_src, cap)
    score = _batch_scores(est, reserved, src_frac, r_task, penalty, w_load,
                          w_src, cap)
    q, n = score.shape
    best, idx = torch.sort(score, dim=1, descending=True, stable=True)
    best, idx = best[:, :k], idx[:, :k].to(torch.int32)
    if k > n:
        best = torch.cat([best, best.new_full((q, k - n), NEG_INF)], dim=1)
        idx = torch.cat([idx, idx.new_full((q, k - n), -1)], dim=1)
    idx = torch.where(best > NEG_INF / 2, idx, -1).to(torch.int32)
    return idx, best, best[:, 0] > NEG_INF / 2


# An empty partial's node: what the CUDA kernels write there (INT_MAX).
_NO_NODE = 2 ** 31 - 1


def _ranked(score, node, k):
    """The k best (score, node) pairs of each row, ordered by (score desc,
    node asc); columns of equal score must come in node order, as chunks
    and their partials do."""
    score, order = torch.sort(score, dim=1, descending=True, stable=True)
    return score[:, :k], torch.gather(node, 1, order)[:, :k]


def _chunk_best(score, chunk, k):
    """Each chunk's k best pairs, (Q, ceil(N / chunk) * k) with node ids of
    the whole row; an empty slot is (NEG_INF, _NO_NODE)."""
    q, n = score.shape
    nodes = torch.arange(n, dtype=torch.int64, device=score.device)
    parts_s, parts_i = [], []
    for lo in range(0, n, chunk):
        s = score[:, lo:lo + chunk]
        s, i = _ranked(s, nodes[lo:lo + chunk].expand(q, -1), k)
        if s.shape[1] < k:
            s = torch.cat([s, s.new_full((q, k - s.shape[1]), NEG_INF)], 1)
            i = torch.cat([i, i.new_full((q, k - i.shape[1]), 0)], 1)
        parts_s.append(s)
        parts_i.append(torch.where(s > NEG_INF / 2, i, _NO_NODE))
    return torch.cat(parts_s, 1), torch.cat(parts_i, 1)


def pick_node_batch_split(est, reserved, src_frac, r_task, penalty, w_load,
                          w_src, cap, chunk):
    """The CUDA argmax's algebra when its node range is split: each chunk
    of ``chunk`` nodes reduces to its best (score, node), empty as
    (NEG_INF, INT_MAX), and the partials merge by (score desc, node asc).
    Equals :func:`pick_node_batch_ref` bit for bit.

    Returns (idx (Q,) i32 or -1, best_score (Q,) f32, any_feasible (Q,)).
    """
    score = _batch_scores(est, reserved, src_frac, r_task, penalty, w_load,
                          w_src, cap)
    best, idx = _ranked(*_chunk_best(score, chunk, 1), 1)
    best, idx = best[:, 0], idx[:, 0]
    any_feasible = best > NEG_INF / 2
    return (torch.where(any_feasible, idx, -1).to(torch.int32), best,
            any_feasible)


def pick_node_batch_topk_split(est, reserved, src_frac, r_task, penalty,
                               w_load, w_src, cap, k, chunk, pass_slots=32):
    """The CUDA top-K's algebra: ``ceil(k / pass_slots)`` passes, each
    taking the pairs strictly after the last one the previous pass wrote
    (none once that slot is empty), then each chunk's ``pass_slots`` best
    of them (fewer in the last pass), merged by (score desc, node asc).
    Equals :func:`pick_node_batch_topk_ref` bit for bit.

    Returns (idx (Q, k) i32, score (Q, k) f32, any_feasible (Q,)).
    """
    score = _batch_scores(est, reserved, src_frac, r_task, penalty, w_load,
                          w_src, cap)
    q, n = score.shape
    nodes = torch.arange(n, device=score.device)
    best = score.new_full((q, k), NEG_INF)
    idx = torch.full((q, k), -1, dtype=torch.int64, device=score.device)
    for col0 in range(0, k, pass_slots):
        kpass = min(pass_slots, k - col0)
        ok = score > NEG_INF / 2
        if col0:
            a_s, a_i = best[:, col0 - 1:col0], idx[:, col0 - 1:col0]
            ok &= (a_s > NEG_INF / 2) & (
                (score < a_s) | ((score == a_s) & (nodes > a_i)))
        parts = _chunk_best(torch.where(ok, score, NEG_INF), chunk, kpass)
        s, i = _ranked(*parts, kpass)
        if s.shape[1] < kpass:   # fewer partials than slots: k > N
            pad = kpass - s.shape[1]
            s = torch.cat([s, s.new_full((q, pad), NEG_INF)], 1)
            i = torch.cat([i, i.new_full((q, pad), _NO_NODE)], 1)
        best[:, col0:col0 + kpass] = s
        idx[:, col0:col0 + kpass] = torch.where(s > NEG_INF / 2, i, -1)
    return idx.to(torch.int32), best, best[:, 0] > NEG_INF / 2
