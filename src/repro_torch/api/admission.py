"""The admission-control core (paper Alg. 3 ``ScheduleOne``).

Port of ``repro.api.admission``.  Two execution shapes, decision for
decision identical:

  * sequential: one decision is a filter + score + argmax over the node
    table (``pick_node``) followed by O(1) masked scatters
    (``admit_one``).  A policy with the ``queue_kernel_rows`` hook and
    ``use_kernel`` has its whole queue admitted in order by one call of
    the queue kernel (``kernels.flex_score.flex_admit_queue``); any other
    by a Python loop over ``admit_one``.  Nothing inside a decision waits
    for the device: the chosen index stays a tensor, and a decision whose
    task is invalid or fits nowhere commits zeros;
  * wavefront (``admit_queue_wavefront``): the whole queue is scored per
    node-table sweep by the batched kernels, and conflict-resolution
    rounds commit the longest provably safe prefix of pending tasks.  The
    reference's ``lax.while_loop``s are Python loops here whose condition
    is read on the host once per round.

Both copy the node state once and then update the copy in place.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.numerics import fma
from repro_torch.core.types import FlexParams, NodeState
from repro_torch.kernels.flex_score.ref import commit_one

# Score of an infeasible node; equal to the kernel's sentinel
# (repro_torch.kernels.flex_score.ref.NEG_INF).
NEG_INF = -1e30

# Effective load pinned onto drained or unavailable nodes: far above any
# capacity or oversubscription factor, so every capacity filter rejects it.
DRAIN_LOAD = 1e6

# Decisions made by admit_queue, one per queue entry it was given, and the
# non-empty queues it was given; and the commit rounds, node-table sweeps
# and deduplicated sweeps of wavefront admission.
DECISIONS = 0
QUEUES = 0
ROUNDS = 0
SWEEPS = 0
DEDUP_SWEEPS = 0


def reset_decisions() -> None:
    global DECISIONS, QUEUES, ROUNDS, SWEEPS, DEDUP_SWEEPS
    DECISIONS = QUEUES = ROUNDS = SWEEPS = DEDUP_SWEEPS = 0


# ---------------------------------------------------------------------------
# Load models and filter + score primitives
# ---------------------------------------------------------------------------

def committed_load(requested, reserved):
    """RLB load: resources promised to running + just-admitted tasks."""
    return requested + reserved


def usage_load(est_usage, reserved, penalty):
    """ULB load (eq. 9): penalized estimate + this-round reservations,
    rounded once as the reference's compiled ``penalty * est + reserved``."""
    return fma(penalty, est_usage, reserved)


def fault_load_offset(node_up, capacity, drain_load=DRAIN_LOAD):
    """(N,) load offset expressing node faults to every admission policy:
    ``drain_load`` on a down node (every capacity filter rejects it),
    the lost fraction ``1 - capacity`` on a flapped one, and exactly 0.0
    on a healthy one, so the identity schedule changes nothing."""
    return torch.where(node_up, 1.0 - capacity,
                       drain_load).to(capacity.dtype)


def mask_unavailable(node: NodeState, offset) -> NodeState:
    """Fold a per-node fault offset into the reservations, which both load
    models and every kernel read.  The offset is constant within a slot,
    the admission invariance the wavefront's conflict checks assume."""
    return node._replace(reserved=node.reserved + offset[:, None])


def fits(load, request, capacity):
    """Capacity filter: ``load + request <= capacity`` on every resource."""
    return (load + request <= capacity).all(dim=-1)


def dominant(load, capacity=None):
    """Dominant-resource share of a multi-resource load: max over R."""
    if capacity is not None:
        load = load / capacity
    return load.max(dim=-1).values


def least_loaded_score(load, capacity=None):
    """Prefer the node whose dominant resource is least committed."""
    return -dominant(load, capacity)


def mask_infeasible(scores, feasible):
    """Infeasible nodes can never win the argmax."""
    return torch.where(feasible, scores, NEG_INF)


# ---------------------------------------------------------------------------
# Kernel/policy contract
# ---------------------------------------------------------------------------

class KernelInputs(NamedTuple):
    """What a policy hands the fused filter+score kernel.

    The kernel evaluates feasibility ``all_R(penalty * est_usage +
    reserved + r <= cap)`` and score ``-(w_load * max_R(load) + w_src *
    src_frac)``.  A policy opts in with a ``kernel_inputs(ctx, task)``
    hook; policies without it take the ``feasible``/``score`` path.
    """

    est_usage: torch.Tensor  # (N, R) f32 unscaled load estimate
    reserved: torch.Tensor   # (N, R) f32 this-round reservations
    src_frac: torch.Tensor   # (N,) f32 same-source fraction per node
    penalty: torch.Tensor    # () f32 estimation penalty P
    cap: torch.Tensor        # () f32 per-resource capacity bound
    w_load: torch.Tensor     # () f32 load-term weight
    w_src: torch.Tensor      # () f32 same-source weight


class TaskView(NamedTuple):
    """The slice of one task a placement policy may look at."""

    request: torch.Tensor   # (R,) f32
    src: torch.Tensor       # () i32 source bucket
    priority: torch.Tensor  # () i32 CLASS_*


class PolicyContext(NamedTuple):
    """Cluster state a policy sees when placing one task."""

    node: NodeState
    penalty: torch.Tensor   # () f32
    params: FlexParams


def pick_node(policy, ctx: PolicyContext, task: TaskView, *,
              use_kernel: bool = False):
    """One fused filter+score+argmax decision (Alg. 3 lines 3-9).

    With ``use_kernel`` and a policy that has the ``kernel_inputs`` hook,
    the reduction is ``kernels.flex_score.flex_pick_node`` (the CUDA
    kernel on the card, its plain version on the CPU).  Otherwise the
    policy's ``feasible``/``score`` hooks run.

    Returns (idx () i32 or -1, any_feasible () bool).
    """
    kernel_inputs = getattr(policy, "kernel_inputs", None)
    if use_kernel and kernel_inputs is not None:
        from repro_torch.kernels.flex_score.ops import flex_pick_node

        ki = kernel_inputs(ctx, task)
        idx, _, any_feasible = flex_pick_node(
            ki.est_usage, ki.reserved, ki.src_frac, task.request, ki.penalty,
            w_load=ki.w_load, w_src=ki.w_src, cap=ki.cap)
        return idx, any_feasible
    feasible = policy.feasible(ctx, task)
    scores = mask_infeasible(policy.score(ctx, task), feasible)
    any_feasible = feasible.any()
    best = torch.argmax(scores).to(torch.int32)
    return torch.where(any_feasible, best, -1).to(torch.int32), any_feasible


def admit_one(policy, ctx: PolicyContext, task: TaskView,
              valid: torch.Tensor, *, use_kernel: bool = False):
    """ScheduleOne: filter, score, place on the argmax; -1 when nothing fits.

    Commits into ``ctx.node``'s tensors IN PLACE (masked scatters: a
    decision that places nothing adds zeros to row 0).  Returns
    (ctx.node, idx () i32).
    """
    node = ctx.node
    cand, any_feasible = pick_node(policy, ctx, task, use_kernel=use_kernel)
    ok = any_feasible & valid
    idx = torch.where(ok, cand, -1).to(torch.int32)

    commit_one(node.reserved, node.requested, node.n_tasks, node.src_count,
               idx, ok, task.request, task.src)
    return node, idx


def admit_queue(policy, node: NodeState, requests, srcs, priorities,
                valid, penalty, params: FlexParams, *,
                use_kernel: bool = False, batch_mode: bool = False,
                topk: int = 8, dedup_buckets: int = 64,
                tie_margin: float = 1e-5):
    """Admit a queue of tasks in queue order.

    requests (Q, R); srcs/priorities/valid (Q,).  Two execution shapes,
    decision for decision identical:

      * sequential (default): one decision per entry.  With
        ``use_kernel``, a policy with the ``queue_kernel_rows`` hook (the
        Flex template with the same-source share) has the whole queue
        admitted by one call of ``flex_admit_queue``: the queue kernel on
        the card, its plain version on the CPU.  Other policies with the
        ``kernel_inputs`` hook make each decision with one call of the
        fused pick; policies with neither keep their plain hooks;
      * ``batch_mode=True``: wavefront rounds over the batched kernels
        (:func:`admit_queue_wavefront`) for kernel-hooked policies, which
        ``topk``, ``dedup_buckets`` and ``tie_margin`` tune.  Policies
        without the hook fall back to the sequential scan.

    Returns (NodeState, placements (Q,) i32, node index or -1).
    """
    global DECISIONS, QUEUES
    q = requests.shape[0]
    QUEUES += int(q > 0)
    if batch_mode and getattr(policy, "kernel_inputs", None) is not None:
        out = admit_queue_wavefront(policy, node, requests, srcs, priorities,
                                    valid, penalty, params, topk=topk,
                                    dedup_buckets=dedup_buckets,
                                    tie_margin=tie_margin)
        DECISIONS += q
        return out
    # Contiguous copies: the queue kernel updates them in place.
    node = NodeState(*(x.clone(memory_format=torch.contiguous_format)
                       for x in node))
    queue_rows = getattr(policy, "queue_kernel_rows", None)
    if use_kernel and queue_rows is not None:
        from repro_torch.kernels.flex_score.ops import flex_admit_queue

        ctx = PolicyContext(node=node, penalty=penalty, params=params)
        rows = queue_rows(ctx, TaskView(requests, srcs, priorities))
        placements = flex_admit_queue(
            node.est_usage, node.reserved, node.requested, node.n_tasks,
            node.src_count, rows, srcs.to(torch.int32).contiguous(),
            valid.to(torch.bool).contiguous())
        DECISIONS += q
        return node, placements
    out = []
    for k in range(q):
        ctx = PolicyContext(node=node, penalty=penalty, params=params)
        task = TaskView(requests[k], srcs[k], priorities[k])
        node, idx = admit_one(policy, ctx, task, valid[k],
                              use_kernel=use_kernel)
        out.append(idx)
    DECISIONS += q
    if not out:
        return node, torch.empty(0, dtype=torch.int32, device=requests.device)
    return node, torch.stack(out)


def make_queue_admitter(policy, params: FlexParams, *,
                        batch_mode: bool = False, use_kernel: bool = False,
                        topk: int = 8, dedup_buckets: int = 64,
                        tie_margin: float = 1e-5):
    """One reusable admission entry point for a fixed policy and knobs.

    ``params`` is bound after the policy's ``prepare_params``, as the
    simulator does.  Admitters of one (policy, knobs) share one cached
    closure, as the reference's share one jitted program.

    Returns ``admit(node, requests, srcs, priorities, valid, penalty) ->
    (NodeState, placements (Q,))``.
    """
    from repro_torch.api.protocols import policy_prepare_params

    prepared = policy_prepare_params(policy, params)
    fn = _shared_queue_admitter(policy, batch_mode, use_kernel, topk,
                                dedup_buckets, tie_margin)

    def admit(node, requests, srcs, priorities, valid, penalty):
        return fn(node, requests, srcs, priorities, valid, penalty, prepared)

    return admit


@functools.lru_cache(maxsize=64)
def _shared_queue_admitter(policy, batch_mode, use_kernel, topk,
                           dedup_buckets, tie_margin):
    """One ``admit_queue`` closure per (policy, knobs); policies are frozen
    dataclasses, so they hash."""

    def admit(node, requests, srcs, priorities, valid, penalty, params):
        return admit_queue(policy, node, requests, srcs, priorities, valid,
                           penalty, params, use_kernel=use_kernel,
                           batch_mode=batch_mode, topk=topk,
                           dedup_buckets=dedup_buckets,
                           tie_margin=tie_margin)

    return admit


# ---------------------------------------------------------------------------
# Wavefront batched admission
# ---------------------------------------------------------------------------

# Node-side leaves describe cluster state and stay unbatched; a hook that
# derives them from the task makes vmap raise.
_BATCHED_OUT_DIMS = KernelInputs(est_usage=None, reserved=None, src_frac=0,
                                 penalty=0, cap=0, w_load=0, w_src=0)


def _batched_kernel_inputs(policy, ctx: PolicyContext, tasks: TaskView):
    """A policy's ``kernel_inputs`` hook mapped over a whole task queue.

    ``est_usage``/``reserved`` must be task-independent (a hook that
    derives them from the task raises here and cannot take the wavefront
    path).  Per-task leaves come back batched: ``src_frac`` becomes
    (Q, N); the four scalars become (Q,).
    """
    hook = policy.kernel_inputs
    return torch.func.vmap(lambda t: hook(ctx, t),
                           out_dims=_BATCHED_OUT_DIMS)(tasks)


def _first_true(mask):
    """Column of each row's first True, 0 where there is none (the
    reference's ``jnp.argmax`` of a bool row)."""
    k = mask.shape[1]
    first = torch.where(mask, torch.arange(k, device=mask.device),
                        k).min(dim=1).values
    return torch.where(first < k, first, 0)


def _template_scores(penalty, cap, w_load, w_src, requests, est_m, res_m,
                     src_qm):
    """(Q, M) kernel-template scores of Q tasks on M node states.

    penalty/cap/w_load/w_src (Q,), requests (Q, R), est_m/res_m (M, R),
    src_qm (Q, M); NEG_INF where the task does not fit.  The arithmetic of
    the kernels, rounded where the reference's compiled checks round.
    """
    load = fma(penalty[:, None, None], est_m[None], res_m[None])  # (Q, M, R)
    feas = (load + requests[:, None, :] <= cap[:, None, None]).all(dim=-1)
    s = -fma(w_load[:, None], load.max(dim=-1).values, w_src[:, None] * src_qm)
    return torch.where(feas, s, NEG_INF)


def _first_unsafe(ns: NodeState, ki: KernelInputs, requests, srcs, cc,
                  ref_sc, pending, lead, blocked, tie_margin):
    """Queue position of the first task of this round that may not commit.

    A ``pending`` task is unsafe when it is ``blocked`` (undecided, or its
    node was picked by an earlier task) or when it is beaten: some earlier
    ``lead`` task i's node c_i, AFTER i's commit, could reach its candidate
    score ``ref_sc`` within ``tie_margin``.  Each prefix node receives
    exactly one commit, so column i is node c_i's true post-commit state.

    The beat plane is evaluated only among the pending tasks before the
    first blocked one (two host reads): past it, no task changes where
    the prefix ends, and a task that is not pending is never unsafe.
    """
    q_len = cc.shape[0]
    pos = torch.arange(q_len, dtype=torch.int32, device=cc.device)
    u0 = int(torch.where(blocked, pos, q_len).min()) if q_len else 0
    rows = torch.nonzero(pending[:u0]).squeeze(1)
    if rows.shape[0] <= 1:
        return u0
    cc, ref_sc, lead = cc[rows], ref_sc[rows], lead[rows]
    req, src = requests[rows], srcs[rows]
    same_src = src[:, None] == src[None, :]                     # [q, i]
    cnt = ns.src_count[cc[None, :].long(), src[:, None].long()]
    src_qi = ((cnt + same_src.to(torch.int32)).to(torch.float32)
              / torch.clamp(ns.n_tasks[cc] + 1, min=1)
              .to(torch.float32)[None, :])
    s_qi = _template_scores(ki.penalty[rows], ki.cap[rows], ki.w_load[rows],
                            ki.w_src[rows], req, ki.est_usage[cc],
                            ns.reserved[cc] + req, src_qi)
    margin = tie_margin * (1.0 + torch.abs(ref_sc))
    beats = s_qi >= (ref_sc - margin)[:, None]
    earlier_lead = lead[None, :] & torch.ones_like(beats).tril(diagonal=-1)
    beat = torch.any(beats & earlier_lead, dim=1)
    return torch.where(beat, rows, u0).min()


def _commit(ns: NodeState, commit, cc, requests, srcs) -> None:
    """Apply a round's commit prefix to the node aggregates, in place.

    The committed nodes are pairwise distinct (the prefix stops at the
    first duplicate pick) and every other row adds zeros, so the float
    sums are exact in any order of the scatter."""
    okf = commit.to(torch.float32)[:, None] * requests
    oki = commit.to(torch.int32)
    ns.reserved.index_add_(0, cc, okf)
    ns.requested.index_add_(0, cc, okf)
    ns.n_tasks.index_add_(0, cc, oki)
    ns.src_count.view(-1).index_add_(0, cc * ns.src_count.shape[1] + srcs,
                                     oki)


def _first_claims(n_nodes, cc, claim, pos):
    """(N,) first queue position claiming each node (Q where none)."""
    q_len = pos.shape[0]
    return torch.full((n_nodes,), q_len, dtype=torch.int32,
                      device=cc.device).scatter_reduce(
        0, cc.long(), torch.where(claim, pos, q_len), "amin")


def admit_queue_wavefront(policy, node: NodeState, requests, srcs,
                          priorities, valid, penalty, params: FlexParams, *,
                          tie_margin: float = 1e-5, topk: int = 8,
                          dedup_buckets: int = 64,
                          with_rounds: bool = False):
    """Admit the queue in conflict-resolution rounds over the batched kernels.

    Port of ``repro.api.admission.admit_queue_wavefront``; decisions are
    those of the sequential scan, decision for decision (the parity
    argument is the reference's, in its docstring and docs/kernels.md).

    One batched top-``topk`` sweep (``flex_pick_node_batch_topk``) caches
    every task's ``topk`` best (score, node) candidates; rounds then
    commit the longest provably safe prefix of pending tasks, a commit
    marks its node dirty, and a task whose candidate went dirty slides to
    its next clean cached entry or takes a dirty node whose refreshed
    score clearly wins.  A task whose sweep finds no feasible node
    finalizes -1 at once.  A fresh sweep (the next epoch) runs when the
    head pending task cannot be decided from the cache.  With ``topk=0``
    every round re-sweeps with the argmax kernel (``flex_pick_node_batch``)
    instead: one sweep per round.

    With ``dedup_buckets`` > 0 (and below Q), a sweep scores one
    representative per distinct (request, penalty, cap, w_load, w_src,
    src) row when the queue holds at most ``dedup_buckets`` of them, and
    the candidate lists scatter back to the full queue; otherwise it runs
    at full width.

    Both conflict checks recompute candidate scores with the kernel
    template's arithmetic and flag anything within ``tie_margin``
    (relative) of the candidate score: over-flagging only defers a task to
    a later round or sweep.  They assume the hook maps onto node state
    canonically (``est_usage`` unaffected by admissions, ``reserved``
    tracking ``node.reserved``, ``src_frac`` equal to ``src_count[:, src]
    / max(n_tasks, 1)`` whenever ``w_src != 0``, the four scalars
    admission-invariant), as every built-in kernel policy does.

    The reference's ``lax.while_loop``s are Python loops here, which read
    the loop condition on the host once per round (and the extent of the
    beat check once more).  The dirty refresh covers only the filled
    entries of the dirty list and the beat check only the tasks before the
    first blocked one; the entries the reference also evaluates there
    cannot change a commit.  The dedup key comparison and the beat plane
    take O(Q^2) memory.

    Returns (NodeState, placements (Q,) i32), plus (rounds, sweeps) as
    ints when ``with_rounds``: commit rounds and node-table sweeps.
    """
    from repro_torch.kernels.flex_score.ops import (flex_pick_node_batch,
                                                    flex_pick_node_batch_topk)

    global ROUNDS, SWEEPS, DEDUP_SWEEPS
    requests = requests.to(torch.float32)
    q_len, _ = requests.shape
    n_nodes = node.n_tasks.shape[0]
    dev = requests.device
    pos = torch.arange(q_len, dtype=torch.int32, device=dev)
    tasks = TaskView(request=requests, src=srcs, priority=priorities)
    ns = NodeState(*(x.clone() for x in node))
    placement = torch.full((q_len,), -1, dtype=torch.int32, device=dev)
    pending = valid.to(torch.bool)
    rounds = sweeps = 0

    def kernel_inputs():
        ctx = PolicyContext(node=ns, penalty=penalty, params=params)
        return _batched_kernel_inputs(policy, ctx, tasks)

    if topk == 0:
        # One full batched argmax sweep per round.
        while bool(pending.any()):
            ki = kernel_inputs()
            cand, best, feas = flex_pick_node_batch(
                ki.est_usage, ki.reserved, ki.src_frac, requests, ki.penalty,
                w_load=ki.w_load, w_src=ki.w_src, cap=ki.cap)
            sweeps += 1
            # Tasks with no feasible node finalize -1 now; the rest are
            # this round's wavefront.
            pending_f = pending & feas
            cc = torch.clamp(cand, 0, n_nodes - 1)
            # dup: an earlier pending task already picked this node.
            first_at = _first_claims(n_nodes, cc, pending_f, pos)
            dup = pending_f & (first_at[cc] < pos)
            first_unsafe = _first_unsafe(
                ns, ki, requests, srcs, cc, best, pending_f,
                pending_f & ~dup, pending_f & dup, tie_margin)
            commit = pending_f & (pos < first_unsafe)
            _commit(ns, commit, cc, requests, srcs)
            placement = torch.where(commit, cand, placement)
            pending = pending_f & ~commit
            rounds += 1
        ROUNDS += rounds
        SWEEPS += sweeps
        if with_rounds:
            return ns, placement, rounds, sweeps
        return ns, placement

    # Candidate-caching path: sweep once per epoch, fall back through the
    # cached top-K lists between sweeps.
    k = int(topk)
    n_buckets = int(dedup_buckets)
    use_dedup = 0 < n_buckets < q_len
    srcs_f = srcs.to(torch.int32).to(torch.float32)

    def sweep():
        """Candidate lists (idx (Q, K), score (Q, K)) of the whole queue
        under the current node state, and the batched kernel inputs."""
        nonlocal sweeps
        global DEDUP_SWEEPS
        sweeps += 1
        ki = kernel_inputs()
        rows = None
        if use_dedup:
            # A task's score row is a function of this key under the
            # canonical hook mapping, so equal keys share one kernel row.
            key = torch.cat([requests, ki.penalty[:, None], ki.cap[:, None],
                             ki.w_load[:, None], ki.w_src[:, None],
                             srcs_f[:, None]], dim=1)          # (Q, R + 5)
            eq = (key[:, None, :] == key[None, :, :]).all(dim=-1)
            first_occ = torch.where(eq, pos[None, :], q_len).min(dim=1).values
            is_canon = first_occ == pos
            rank = torch.cumsum(is_canon.to(torch.int32), 0) - 1
            if int(is_canon.sum()) <= n_buckets:
                # Bucket b -> its representative task; pad slots keep
                # task 0, scored and scattered to no one.
                slot = torch.where(is_canon & (rank < n_buckets), rank,
                                   n_buckets)
                rows = torch.zeros(n_buckets + 1, dtype=torch.int64,
                                   device=dev).scatter_(
                    0, slot.long(), pos.long())[:n_buckets]
                back = torch.clamp(rank[first_occ], 0, n_buckets - 1).long()
                DEDUP_SWEEPS += 1
        if rows is None:
            ci, cs, _ = flex_pick_node_batch_topk(
                ki.est_usage, ki.reserved, ki.src_frac, requests, ki.penalty,
                w_load=ki.w_load, w_src=ki.w_src, cap=ki.cap, k=k)
            return ci, cs, ki
        ci, cs, _ = flex_pick_node_batch_topk(
            ki.est_usage, ki.reserved, ki.src_frac[rows], requests[rows],
            ki.penalty[rows], w_load=ki.w_load[rows], w_src=ki.w_src[rows],
            cap=ki.cap[rows], k=k)
        return ci[back], cs[back], ki

    k_pos = torch.arange(k, device=dev)
    neg_inf = torch.full((q_len,), NEG_INF, dtype=torch.float32, device=dev)
    any_pending = bool(pending.any())
    while any_pending:
        cand_idx, cand_sc, ki = sweep()
        # Tasks with no feasible node at sweep time finalize -1 now:
        # commits only ever add load, and the capacity filter is
        # antitone in load.
        pending = pending & (cand_idx[:, 0] >= 0)
        cip = torch.clamp(cand_idx, 0, n_nodes - 1)
        tail_real = cand_idx[:, k - 1] >= 0
        dnodes = torch.full((q_len + 1,), n_nodes, dtype=torch.int32,
                            device=dev)
        dcnt = 0
        any_pending = bool(pending.any())
        stall = False
        while any_pending and not stall:
            # Clean candidate: the first cached entry whose node nobody
            # committed to since the sweep; its cached score is exact.
            dirty = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
            dn = dnodes[:dcnt]
            dirty[dn.long()] = True
            usable = (cand_idx >= 0) & ~dirty[cip]            # (Q, K)
            has = usable.any(dim=1)
            p = _first_true(usable)[:, None]
            cand1 = cand_idx.gather(1, p)[:, 0]
            sc1 = cand_sc.gather(1, p)[:, 0]

            # Dirty refresh: every dirtied node's current score per task.
            if dcnt:
                src_qd = (ns.src_count[dn[None, :].long(),
                                       srcs[:, None].long()]
                          .to(torch.float32)
                          / torch.clamp(ns.n_tasks[dn], min=1)
                          .to(torch.float32)[None, :])
                s_qd = _template_scores(ki.penalty, ki.cap, ki.w_load,
                                        ki.w_src, requests,
                                        ki.est_usage[dn], ns.reserved[dn],
                                        src_qd)
                # Best and second-best DISTINCT dirty node per task.
                s_dbest = s_qd.max(dim=1).values
                c_dbest = dn[torch.argmax(s_qd, dim=1)]
                s_dsecond = torch.where(dn[None, :] != c_dbest[:, None],
                                        s_qd, NEG_INF).max(dim=1).values
            else:
                s_dbest = s_dsecond = neg_inf
                c_dbest = torch.full((q_len,), n_nodes - 1,
                                     dtype=torch.int32, device=dev)
            m_db = tie_margin * (1.0 + torch.abs(s_dbest))
            # A dirty node wins when its refreshed score clears the best
            # clean alternative (the first usable entry, or for an
            # exhausted list the sweep's K-th score) and the runner-up
            # dirty node by the margin.
            clean_bound = torch.where(
                has, sc1, torch.where(tail_real, cand_sc[:, k - 1], NEG_INF))
            dirty_ok = ((s_dbest > NEG_INF / 2)
                        & (s_dbest - m_db > clean_bound)
                        & (s_dbest - m_db > s_dsecond))

            # In-round dup displacement: a task whose first choice is
            # claimed by an earlier pending task (one that cannot take the
            # dirty route) slides to its next unclaimed cached entry.
            cc1 = torch.clamp(cand1, 0, n_nodes - 1)
            first_at1 = _first_claims(n_nodes, cc1, pending & has & ~dirty_ok,
                                      pos)
            taken = usable & (first_at1[cip] < pos[:, None])
            usable2 = usable & ~taken
            has2 = usable2.any(dim=1)
            p2 = _first_true(usable2)[:, None]
            cand = cand_idx.gather(1, p2)[:, 0]
            sc2 = cand_sc.gather(1, p2)[:, 0]

            # Clean wins when no dirty node comes within the margin of the
            # cached score; dirty wins when dirty_ok; anything between is
            # ambiguous and blocks the task.
            m_sc = tie_margin * (1.0 + torch.abs(sc2))
            clean_ok = has2 & (s_dbest < sc2 - m_sc)
            use_dirty = ~clean_ok & dirty_ok
            cand = torch.where(use_dirty, c_dbest, cand)
            sc = torch.where(use_dirty, s_dbest, sc2)
            decided = clean_ok | use_dirty
            cc = torch.clamp(cand, 0, n_nodes - 1)

            live = pending & decided
            first_at = _first_claims(n_nodes, cc, live, pos)
            dup = live & (first_at[cc] < pos)
            first_unsafe = _first_unsafe(
                ns, ki, requests, srcs, cc, sc, pending, live & ~dup,
                pending & (~decided | dup), tie_margin)
            commit = pending & (pos < first_unsafe)
            oki = commit.to(torch.int32)

            _commit(ns, commit, cc, requests, srcs)
            placement = torch.where(commit, cand, placement)
            # Freshly dirtied nodes join the compact list.
            tpos = torch.where(commit, dcnt + torch.cumsum(oki, 0) - 1, q_len)
            dnodes.scatter_(0, tpos.long(), cc)
            pending = pending & ~commit
            rounds += 1
            n_commit, n_pending = torch.stack(
                [oki.sum(), pending.sum(dtype=torch.int32)]).tolist()
            dcnt += n_commit
            any_pending = n_pending > 0
            stall = any_pending and n_commit == 0
    ROUNDS += rounds
    SWEEPS += sweeps
    if with_rounds:
        return ns, placement, rounds, sweeps
    return ns, placement
