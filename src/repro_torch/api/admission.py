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

Both also run B independent runs at once (``core.simulator.simulate_runs``
runs a study's seeds and sweep points as one simulation): the node state,
the queue, the penalty and the params then lead with a run axis, and one
kernel launch serves every run's queue (sequential), every run's decision
(``admit_one``) or every run's sweep (wavefront).  The policy's hooks see
one run, as they always do: they are mapped over the run axis
(``torch.func.vmap``; called on run 0's slices when B = 1).  A call
without a run axis is the B = 1 call.
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


def _map_tensors(fn, tree):
    """``fn`` of every tensor in a tree of tuples and NamedTuples."""
    if isinstance(tree, tuple):
        items = [_map_tensors(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _first_tensor(tree):
    if isinstance(tree, tuple):
        for x in tree:
            found = _first_tensor(x)
            if found is not None:
                return found
        return None
    return tree if isinstance(tree, torch.Tensor) else None


def per_run(fn, *args):
    """``fn`` of one run's arguments, mapped over the leading run axis of
    every tensor in ``args`` (tuples and NamedTuples of tensors): with one
    run, ``fn`` of run 0's slices, its outputs given the axis back (views,
    no launch); with more, ``torch.func.vmap(fn)``, the same arithmetic
    element for element."""
    if _first_tensor(args).shape[0] == 1:
        return _with_runs(fn(*_run0(args)))[0]
    return torch.func.vmap(fn)(*args)


def _with_runs(*trees):
    """Each tree of tensors with a leading run axis of one (views)."""
    return tuple(_map_tensors(lambda x: x.unsqueeze(0), t) for t in trees)


def _run0(tree):
    """Run 0 of a tree of run-axis tensors (views)."""
    return _map_tensors(lambda x: x[0], tree)


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
    """Fold a per-node fault offset (N,) into the reservations, which both
    load models and every kernel read ((B, N) into B runs' (B, N, R)).
    The offset is constant within a slot, the admission invariance the
    wavefront's conflict checks assume."""
    return node._replace(reserved=node.reserved + offset[..., None])


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


def _runs_of(ctx: PolicyContext) -> bool:
    """Whether ``ctx`` holds B runs (a leading run axis)."""
    return ctx.node.n_tasks.dim() == 2


def pick_node(policy, ctx: PolicyContext, task: TaskView, *,
              use_kernel: bool = False):
    """One fused filter+score+argmax decision (Alg. 3 lines 3-9).

    With ``use_kernel`` and a policy that has the ``kernel_inputs`` hook,
    the reduction is ``kernels.flex_score.flex_pick_node`` (the CUDA
    kernel on the card, its plain version on the CPU).  Otherwise the
    policy's ``feasible``/``score`` hooks run.  With a run axis (every
    leaf of ``ctx`` and ``task`` leading with B) one step decides in every
    run: one kernel launch, or each hook mapped over the runs.

    Returns (idx () i32 or -1, any_feasible () bool), (B,) with a run
    axis.
    """
    # one run's hooks as they are written; B runs' mapped over the runs
    call = per_run if _runs_of(ctx) else (lambda fn, *args: fn(*args))
    kernel_inputs = getattr(policy, "kernel_inputs", None)
    if use_kernel and kernel_inputs is not None:
        from repro_torch.kernels.flex_score.ops import flex_pick_node

        ki = call(kernel_inputs, ctx, task)
        idx, _, any_feasible = flex_pick_node(
            ki.est_usage, ki.reserved, ki.src_frac, task.request, ki.penalty,
            w_load=ki.w_load, w_src=ki.w_src, cap=ki.cap)
        return idx, any_feasible
    feasible = call(policy.feasible, ctx, task)
    scores = mask_infeasible(call(policy.score, ctx, task), feasible)
    any_feasible = feasible.any(dim=-1)
    best = torch.argmax(scores, dim=-1).to(torch.int32)
    return torch.where(any_feasible, best, -1).to(torch.int32), any_feasible


def admit_one(policy, ctx: PolicyContext, task: TaskView,
              valid: torch.Tensor, *, use_kernel: bool = False):
    """ScheduleOne: filter, score, place on the argmax; -1 when nothing fits.

    Commits into ``ctx.node``'s tensors IN PLACE (masked scatters: a
    decision that places nothing adds zeros to row 0).  With a run axis
    each run decides and commits in its own tables (``ctx.node``
    contiguous).  Returns (ctx.node, idx () i32, or (B,)).
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
                tie_margin: float = 1e-5, lens=None):
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

    With a run axis (node leaves (B, N, ...), the queue (B, Q, ...),
    penalty and the params' leaves (B,)) each run admits its own queue
    into its own node state, and one launch or one decision step serves
    all B: a run's queue is its first ``lens[b]`` entries (a host list;
    all Q by default), and the entries after them are invalid padding.
    ``DECISIONS`` and ``QUEUES`` count each run's queue as a call of its
    own would.

    Returns (NodeState, placements (Q,) i32, node index or -1), both with
    the run axis when given one.
    """
    global DECISIONS, QUEUES
    runs_axis = node.n_tasks.dim() == 2
    q = requests.shape[-2]
    if lens is None:
        lens = [q] * (requests.shape[0] if runs_axis else 1)
    QUEUES += sum(1 for x in lens if x > 0)
    DECISIONS += sum(lens)
    args = (node, requests, srcs, priorities, valid, penalty, params)
    if batch_mode and getattr(policy, "kernel_inputs", None) is not None:
        return admit_queue_wavefront(
            policy, *args, topk=topk, dedup_buckets=dedup_buckets,
            tie_margin=tie_margin, lens=lens if runs_axis else lens[0])
    if runs_axis and requests.shape[0] == 1:
        # One run: the scan on run 0's views, as a call without a run axis.
        return _with_runs(*_admit_in_order(policy, *_run0(args), use_kernel))
    return _admit_in_order(policy, *args, use_kernel)


def _admit_in_order(policy, node: NodeState, requests, srcs, priorities,
                    valid, penalty, params: FlexParams, use_kernel: bool):
    """The sequential scan of :func:`admit_queue`, of one run or, with a
    run axis, of B runs in one launch or one decision step."""
    runs_axis = node.n_tasks.dim() == 2
    # Contiguous copies: the queue kernel and the commits update them in
    # place.
    node = NodeState(*(x.clone(memory_format=torch.contiguous_format)
                       for x in node))
    queue_rows = getattr(policy, "queue_kernel_rows", None)
    if use_kernel and queue_rows is not None:
        from repro_torch.kernels.flex_score.ops import flex_admit_queue

        ctx = PolicyContext(node=node, penalty=penalty, params=params)
        tasks = TaskView(requests, srcs, priorities)
        rows = (per_run(queue_rows, ctx, tasks) if runs_axis
                else queue_rows(ctx, tasks))
        return node, flex_admit_queue(
            *node, rows.contiguous(), srcs.to(torch.int32).contiguous(),
            valid.to(torch.bool).contiguous())
    out = []
    for k in range(requests.shape[-2]):
        ctx = PolicyContext(node=node, penalty=penalty, params=params)
        task = TaskView(requests.select(-2, k), srcs.select(-1, k),
                        priorities.select(-1, k))
        node, idx = admit_one(policy, ctx, task, valid.select(-1, k),
                              use_kernel=use_kernel)
        out.append(idx)
    if not out:
        return node, torch.empty(requests.shape[:-2] + (0,),
                                 dtype=torch.int32, device=requests.device)
    return node, torch.stack(out, dim=-1)


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

def _batched_kernel_inputs(policy, ctx: PolicyContext, tasks: TaskView):
    """A policy's ``kernel_inputs`` hook mapped over a whole task queue (of
    each run, with a run axis).

    ``est_usage``/``reserved`` must be task-independent: the map over the
    queue gives them back as stride-0 expansions, which are taken once (a
    hook that derives them from the task raises here and cannot take the
    wavefront path).  Per-task leaves come back batched: ``src_frac``
    becomes (Q, N); the four scalars become (Q,); ``est_usage`` and
    ``reserved`` keep the node state's (N, R).  Each leads with B with a
    run axis.
    """
    hook = policy.kernel_inputs

    def one_run(c, t):
        return torch.func.vmap(lambda t1: hook(c, t1))(t)

    ki = (per_run(one_run, ctx, tasks) if _runs_of(ctx)
          else one_run(ctx, tasks))
    for name in ("est_usage", "reserved"):
        x = getattr(ki, name)
        if x.shape[-3] > 1 and x.stride(-3) != 0:
            raise ValueError(
                f"{getattr(policy, 'name', policy)!r}: kernel_inputs' {name} "
                f"depends on the task, where the wavefront takes it as a "
                f"node-side leaf (out_dim None over the queue)")
    return ki._replace(est_usage=ki.est_usage[..., 0, :, :],
                       reserved=ki.reserved[..., 0, :, :])


def _first_true(mask):
    """Index along the last axis of each row's first True, 0 where there
    is none (the reference's ``jnp.argmax`` of a bool row)."""
    k = mask.shape[-1]
    first = torch.where(mask, torch.arange(k, device=mask.device),
                        k).min(dim=-1).values
    return torch.where(first < k, first, 0)


def _template_scores(penalty, cap, w_load, w_src, requests, est_m, res_m,
                     src_qm):
    """(..., Q, M) kernel-template scores of Q tasks on M node states.

    penalty/cap/w_load/w_src (..., Q), requests (..., Q, R), est_m/res_m
    (..., M, R), src_qm (..., Q, M); NEG_INF where the task does not fit.
    The arithmetic of the kernels, rounded where the reference's compiled
    checks round.
    """
    load = fma(penalty[..., :, None, None], est_m[..., None, :, :],
               res_m[..., None, :, :])                       # (..., Q, M, R)
    feas = (load + requests[..., :, None, :]
            <= cap[..., :, None, None]).all(dim=-1)
    s = -fma(w_load[..., :, None], load.max(dim=-1).values,
             w_src[..., :, None] * src_qm)
    return torch.where(feas, s, NEG_INF)


def _flat(idx, n: int):
    """Per-run indices ``idx`` (B, ...) into tables of ``n`` rows a run, as
    rows of the runs' tables laid end to end (``b * n + idx``)."""
    runs = idx.shape[0]
    return idx + n * torch.arange(runs, dtype=idx.dtype,
                                  device=idx.device).view(
        (runs,) + (1,) * (idx.dim() - 1))


def _take(x, idx):
    """``x[b, idx[b, ...]]`` for every run b: rows of x (B, M, ...) at the
    (B, ...) indices ``idx``."""
    return x.reshape((-1,) + tuple(x.shape[2:]))[_flat(idx, x.shape[1])]


def _src_share_at(ns: NodeState, nodes, srcs):
    """The counts ``src_count[node, src]`` (..., Q, M) of task q's source
    on node ``nodes[..., m]``, and the nodes' task counts (..., M): the
    Flex same-source share's numerator and denominator."""
    if srcs.dim() == 1:
        return (ns.src_count[nodes[None, :].long(), srcs[:, None].long()],
                ns.n_tasks[nodes])
    n, n_src = ns.src_count.shape[1:]
    flat = _flat(nodes, n)
    cnt = ns.src_count.view(-1)[flat[:, None, :] * n_src + srcs[:, :, None]]
    return cnt, ns.n_tasks.view(-1)[flat]


def _first_unsafe(ns: NodeState, ki: KernelInputs, requests, srcs, cc,
                  ref_sc, pending, lead, blocked, tie_margin):
    """Queue position of the first task of this round that may not commit:
    an int or () tensor, or (B, 1) with a run axis.

    A ``pending`` task is unsafe when it is ``blocked`` (undecided, or its
    node was picked by an earlier task) or when it is beaten: some earlier
    ``lead`` task i's node c_i, AFTER i's commit, could reach its candidate
    score ``ref_sc`` within ``tie_margin``.  Each prefix node receives
    exactly one commit, so column i is node c_i's true post-commit state.

    The beat plane is evaluated only among the pending tasks before the
    first blocked one: past it, no task changes where the prefix ends, and
    a task that is not pending is never unsafe.  Where that first blocked
    task is and which pending tasks come before it are two host reads; with
    a run axis, how many come before it in each run is one read for all
    runs, and the plane is as wide as the largest run's count.
    """
    q_len = cc.shape[-1]
    runs_axis = cc.dim() == 2
    if q_len == 0:
        return cc.new_zeros(cc.shape[:-1] + (1,)) if runs_axis else 0
    pos = torch.arange(q_len, dtype=torch.int32, device=cc.device)
    ragged = False
    if runs_axis:
        take = _take
        u0 = torch.where(blocked, pos, q_len).min(dim=1, keepdim=True).values
        before = pending & (pos < u0)
        counts = before.sum(dim=1, dtype=torch.int32).tolist()
        m = max(counts)
        if m <= 1:
            return u0
        rows = torch.argsort((~before).to(torch.int32), dim=1,
                             stable=True)[:, :m]
        # a run with fewer pending tasks: its rows past them are not its own
        ragged = min(counts) < m
    else:
        take = lambda x, idx: x[idx]
        u0 = int(torch.where(blocked, pos, q_len).min())
        rows = torch.nonzero(pending[:u0]).squeeze(1)
        if rows.shape[0] <= 1:
            return u0
    cc, ref_sc, lead = (take(x, rows) for x in (cc, ref_sc, lead))
    req, src = take(requests, rows), take(srcs, rows)
    same_src = src[..., :, None] == src[..., None, :]           # [b, q, i]
    cnt, n_t = _src_share_at(ns, cc, src)
    src_qi = ((cnt + same_src.to(torch.int32)).to(torch.float32)
              / torch.clamp(n_t + 1, min=1).to(torch.float32)[..., None, :])
    s_qi = _template_scores(
        *(take(x, rows) for x in (ki.penalty, ki.cap, ki.w_load, ki.w_src)),
        req, take(ki.est_usage, cc), take(ns.reserved, cc) + req, src_qi)
    margin = tie_margin * (1.0 + torch.abs(ref_sc))
    beats = s_qi >= (ref_sc - margin)[..., :, None]
    if ragged:
        real = torch.arange(m, device=cc.device) < before.sum(dim=1)[:, None]
        lead, beats = lead & real, beats & real[:, :, None]
    earlier_lead = lead[..., None, :] & torch.ones_like(beats).tril(
        diagonal=-1)
    beat = torch.any(beats & earlier_lead, dim=-1)
    if runs_axis:
        return torch.where(beat, rows, u0).min(dim=1, keepdim=True).values
    return torch.where(beat, rows, u0).min()


def _commit(ns: NodeState, commit, cc, requests, srcs) -> None:
    """Apply a round's commit prefix to the node aggregates, in place.

    The committed nodes are pairwise distinct within a run (the prefix
    stops at the first duplicate pick), the runs' tables are disjoint
    (a run axis lays them end to end), and every other row adds zeros, so
    the float sums are exact in any order of the scatter."""
    okf = commit.to(torch.float32)[..., None] * requests
    oki = commit.to(torch.int32)
    if cc.dim() == 2:
        r = okf.shape[-1]
        cc = _flat(cc, ns.n_tasks.shape[1]).reshape(-1)
        okf, oki, srcs = okf.reshape(-1, r), oki.reshape(-1), srcs.reshape(-1)
        ns = NodeState(*(x.view((-1,) + tuple(x.shape[2:])) for x in ns))
    ns.reserved.index_add_(0, cc, okf)
    ns.requested.index_add_(0, cc, okf)
    ns.n_tasks.index_add_(0, cc, oki)
    ns.src_count.view(-1).index_add_(0, cc * ns.src_count.shape[1] + srcs,
                                     oki)


def _first_claims(n_nodes, cc, claim, pos):
    """(..., N) first queue position claiming each node (Q where none)."""
    q_len = pos.shape[0]
    return torch.full(cc.shape[:-1] + (n_nodes,), q_len, dtype=torch.int32,
                      device=cc.device).scatter_reduce(
        -1, cc.long(), torch.where(claim, pos, q_len), "amin")


def admit_queue_wavefront(policy, node: NodeState, requests, srcs,
                          priorities, valid, penalty, params: FlexParams, *,
                          tie_margin: float = 1e-5, topk: int = 8,
                          dedup_buckets: int = 64,
                          with_rounds: bool = False, lens=None):
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
    beat check twice more).  The dirty refresh covers only the filled
    entries of the dirty list and the beat check only the tasks before the
    first blocked one; the entries the reference also evaluates there
    cannot change a commit.  The dedup key comparison and the beat plane
    take O(Q^2) memory.

    With a run axis (node leaves (B, N, ...), the queue (B, Q, ...),
    penalty and the params' leaves (B,); run b's queue its first
    ``lens[b]`` entries, a host list, then invalid padding) every run
    takes its rounds in the same loop, as the reference's ``while_loop``
    does under ``vmap``: a round runs while any run has a round to run,
    and a run that has none (finished, or waiting for its next sweep)
    changes nothing in it, because it would repeat its last round, which
    committed nothing.  Every sweep scores all runs in one launch; the
    host reads are one read across runs (the beat check's extent one).
    Rounds and sweeps count per run, the counts a call of its own would
    give.  The dedup is decided per run, on that run's own queue; a sweep
    is deduplicated when every run that sweeps can take it.  One run
    (B = 1) takes its rounds on run 0's views, as a call without the axis.

    Returns (NodeState, placements (Q,) i32), plus (rounds, sweeps) as
    ints when ``with_rounds`` (lists of B with a run axis): commit rounds
    and node-table sweeps.
    """
    args = (node, requests, srcs, priorities, valid, penalty, params)
    kw = dict(tie_margin=tie_margin, topk=topk, dedup_buckets=dedup_buckets,
              with_rounds=with_rounds)
    if node.n_tasks.dim() == 2 and node.n_tasks.shape[0] == 1:
        out = admit_queue_wavefront(policy, *_run0(args), **kw,
                                    lens=None if lens is None else lens[0])
        if with_rounds:
            return (*_with_runs(*out[:2]), [out[2]], [out[3]])
        return _with_runs(*out)
    from repro_torch.kernels.flex_score.ops import (flex_pick_node_batch,
                                                    flex_pick_node_batch_topk)

    global ROUNDS, SWEEPS, DEDUP_SWEEPS
    runs_axis = node.n_tasks.dim() == 2
    requests = requests.to(torch.float32)
    q_len = requests.shape[-2]
    runs = requests.shape[0] if runs_axis else 1
    if lens is None:
        lens = [q_len] * runs
    elif not runs_axis:
        lens = [int(lens)]
    n_nodes = node.n_tasks.shape[-1]
    dev = requests.device
    pos = torch.arange(q_len, dtype=torch.int32, device=dev)
    tasks = TaskView(request=requests, src=srcs, priority=priorities)
    ns = NodeState(*(x.clone(memory_format=torch.contiguous_format)
                     for x in node))
    placement = torch.full(requests.shape[:-1], -1, dtype=torch.int32,
                           device=dev)
    pending = valid.to(torch.bool)
    rounds, sweeps = [0] * runs, [0] * runs
    if runs_axis:
        take, flat = _take, _flat
        host = lambda x: x.tolist()
    else:
        take, flat = (lambda x, idx: x[idx]), (lambda idx, n: idx)
        host = lambda x: [x.tolist()]

    def kernel_inputs():
        ctx = PolicyContext(node=ns, penalty=penalty, params=params)
        return _batched_kernel_inputs(policy, ctx, tasks)

    def finish():
        global ROUNDS, SWEEPS
        ROUNDS += sum(rounds)
        SWEEPS += sum(sweeps)
        out = ns, placement
        if with_rounds:
            out += (rounds, sweeps) if runs_axis else (rounds[0], sweeps[0])
        return out

    def count(counter, live):
        for b, on in enumerate(live):
            counter[b] += int(on)

    if topk == 0:
        # One full batched argmax sweep per round.
        live = host(pending.any(dim=-1))
        while any(live):
            ki = kernel_inputs()
            cand, best, feas = flex_pick_node_batch(
                ki.est_usage, ki.reserved, ki.src_frac, requests, ki.penalty,
                w_load=ki.w_load, w_src=ki.w_src, cap=ki.cap)
            count(sweeps, live)
            # Tasks with no feasible node finalize -1 now; the rest are
            # this round's wavefront.
            pending_f = pending & feas
            cc = torch.clamp(cand, 0, n_nodes - 1)
            # dup: an earlier pending task already picked this node.
            first_at = _first_claims(n_nodes, cc, pending_f, pos)
            dup = pending_f & (take(first_at, cc) < pos)
            first_unsafe = _first_unsafe(
                ns, ki, requests, srcs, cc, best, pending_f,
                pending_f & ~dup, pending_f & dup, tie_margin)
            commit = pending_f & (pos < first_unsafe)
            _commit(ns, commit, cc, requests, srcs)
            placement = torch.where(commit, cand, placement)
            pending = pending_f & ~commit
            count(rounds, live)
            live = host(pending.any(dim=-1))
        return finish()

    # Candidate-caching path: sweep once per epoch, fall back through the
    # cached top-K lists between sweeps.
    k = int(topk)
    n_buckets = int(dedup_buckets)
    may_dedup = [0 < n_buckets < x for x in lens]
    srcs_f = srcs.to(torch.int32).to(torch.float32)

    def sweep(live):
        """Candidate lists (idx (..., Q, K), score (..., Q, K)) of every
        run's queue under the current node state, and the batched kernel
        inputs."""
        global DEDUP_SWEEPS
        count(sweeps, live)
        ki = kernel_inputs()
        rows = None
        if any(may_dedup[b] for b in range(runs) if live[b]):
            # A task's score row is a function of this key under the
            # canonical hook mapping, so equal keys share one kernel row.
            key = torch.cat([requests, ki.penalty[..., None],
                             ki.cap[..., None], ki.w_load[..., None],
                             ki.w_src[..., None], srcs_f[..., None]],
                            dim=-1)                            # (..., Q, R + 5)
            eq = (key[..., :, None, :] == key[..., None, :, :]).all(dim=-1)
            first_occ = torch.where(eq, pos, q_len).min(dim=-1).values
            is_canon = first_occ == pos
            if min(lens) < q_len:   # a run's padding is no row of its own
                is_canon &= pos < (torch.tensor(lens, device=dev)[:, None]
                                   if runs_axis else lens[0])
            rank = torch.cumsum(is_canon.to(torch.int32), -1) - 1
            n_canon = host(is_canon.sum(dim=-1))
            if all(may_dedup[b] and n_canon[b] <= n_buckets
                   for b in range(runs) if live[b]):
                # Bucket j -> its representative task; pad slots keep
                # task 0, scored and scattered to no one.
                slot = torch.where(is_canon & (rank < n_buckets), rank,
                                   n_buckets)
                rows = torch.zeros(placement.shape[:-1] + (n_buckets + 1,),
                                   dtype=torch.int64, device=dev).scatter_(
                    -1, slot.long(), pos.long().expand(slot.shape))[
                    ..., :n_buckets]
                back = torch.clamp(rank.gather(-1, first_occ.long()), 0,
                                   n_buckets - 1).long()
                DEDUP_SWEEPS += sum(1 for b in range(runs) if live[b])
        if rows is None:
            ci, cs, _ = flex_pick_node_batch_topk(
                ki.est_usage, ki.reserved, ki.src_frac, requests, ki.penalty,
                w_load=ki.w_load, w_src=ki.w_src, cap=ki.cap, k=k)
            return ci, cs, ki
        ci, cs, _ = flex_pick_node_batch_topk(
            ki.est_usage, ki.reserved, take(ki.src_frac, rows),
            take(requests, rows), ki.penalty.gather(-1, rows),
            w_load=ki.w_load.gather(-1, rows),
            w_src=ki.w_src.gather(-1, rows), cap=ki.cap.gather(-1, rows),
            k=k)
        return take(ci, back), take(cs, back), ki

    neg_inf = torch.full(placement.shape, NEG_INF, dtype=torch.float32,
                         device=dev)
    live = host(pending.any(dim=-1))
    while any(live):
        cand_idx, cand_sc, ki = sweep(live)
        # Tasks with no feasible node at sweep time finalize -1 now:
        # commits only ever add load, and the capacity filter is
        # antitone in load.
        pending = pending & (cand_idx[..., 0] >= 0)
        cip = torch.clamp(cand_idx, 0, n_nodes - 1)
        tail_real = cand_idx[..., k - 1] >= 0
        # Each run's dirty list: the nodes committed to since its sweep,
        # in order, then n_nodes; slot q_len takes the other writes.
        dnodes = torch.full(placement.shape[:-1] + (q_len + 1,), n_nodes,
                            dtype=torch.int32, device=dev)
        dcnt = [0] * runs         # each run's dirty count, on the host
        if runs_axis:             # and on the device, for the list's writes
            dcnt_t = torch.zeros((runs, 1), dtype=torch.int32, device=dev)
        live = host(pending.any(dim=-1))
        waiting = live     # the runs with pending tasks
        while any(live):
            # Clean candidate: the first cached entry whose node nobody
            # committed to since the sweep; its cached score is exact.
            max_dirty = max(dcnt)
            # a run with fewer dirty nodes than another: n_nodes pads its row
            ragged = min(dcnt) < max_dirty
            dn = dnodes[..., :max_dirty]
            dirty = torch.zeros(runs * (n_nodes + 1), dtype=torch.bool,
                                device=dev)
            dirty[flat(dn, n_nodes + 1)] = True
            usable = (cand_idx >= 0) & ~dirty[flat(cip, n_nodes + 1)]
            has = usable.any(dim=-1)
            p = _first_true(usable)[..., None]
            cand1 = cand_idx.gather(-1, p)[..., 0]
            sc1 = cand_sc.gather(-1, p)[..., 0]

            # Dirty refresh: every dirtied node's current score per task.
            if max_dirty:
                dnc = torch.clamp(dn, max=n_nodes - 1) if ragged else dn
                cnt, n_t = _src_share_at(ns, dnc, srcs)
                src_qd = (cnt.to(torch.float32)
                          / torch.clamp(n_t, min=1)
                          .to(torch.float32)[..., None, :])
                s_qd = _template_scores(ki.penalty, ki.cap, ki.w_load,
                                        ki.w_src, requests,
                                        take(ki.est_usage, dnc),
                                        take(ns.reserved, dnc), src_qd)
                if ragged:
                    s_qd = torch.where((dn < n_nodes)[:, None, :], s_qd,
                                       NEG_INF)
                # Best and second-best DISTINCT dirty node per task.
                s_dbest = s_qd.max(dim=-1).values
                c_dbest = take(dn, torch.argmax(s_qd, dim=-1))
                s_dsecond = torch.where(
                    dn[..., None, :] != c_dbest[..., None], s_qd,
                    NEG_INF).max(dim=-1).values
                if ragged and min(dcnt) == 0:
                    # a run with no dirty node yet: as max_dirty == 0
                    any_dirty = (dn[:, :1] < n_nodes)
                    s_dbest = torch.where(any_dirty, s_dbest, NEG_INF)
                    s_dsecond = torch.where(any_dirty, s_dsecond, NEG_INF)
                    c_dbest = torch.where(any_dirty, c_dbest, n_nodes - 1)
            else:
                s_dbest = s_dsecond = neg_inf
                c_dbest = torch.full(placement.shape, n_nodes - 1,
                                     dtype=torch.int32, device=dev)
            m_db = tie_margin * (1.0 + torch.abs(s_dbest))
            # A dirty node wins when its refreshed score clears the best
            # clean alternative (the first usable entry, or for an
            # exhausted list the sweep's K-th score) and the runner-up
            # dirty node by the margin.
            clean_bound = torch.where(
                has, sc1, torch.where(tail_real, cand_sc[..., k - 1],
                                      NEG_INF))
            dirty_ok = ((s_dbest > NEG_INF / 2)
                        & (s_dbest - m_db > clean_bound)
                        & (s_dbest - m_db > s_dsecond))

            # In-round dup displacement: a task whose first choice is
            # claimed by an earlier pending task (one that cannot take the
            # dirty route) slides to its next unclaimed cached entry.
            cc1 = torch.clamp(cand1, 0, n_nodes - 1)
            first_at1 = _first_claims(n_nodes, cc1, pending & has & ~dirty_ok,
                                      pos)
            taken = usable & (take(first_at1, cip) < pos[:, None])
            usable2 = usable & ~taken
            has2 = usable2.any(dim=-1)
            p2 = _first_true(usable2)[..., None]
            cand = cand_idx.gather(-1, p2)[..., 0]
            sc2 = cand_sc.gather(-1, p2)[..., 0]

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

            live_q = pending & decided
            first_at = _first_claims(n_nodes, cc, live_q, pos)
            dup = live_q & (take(first_at, cc) < pos)
            first_unsafe = _first_unsafe(
                ns, ki, requests, srcs, cc, sc, pending, live_q & ~dup,
                pending & (~decided | dup), tie_margin)
            commit = pending & (pos < first_unsafe)
            oki = commit.to(torch.int32)

            _commit(ns, commit, cc, requests, srcs)
            placement = torch.where(commit, cand, placement)
            # Freshly dirtied nodes join the compact list.
            n_commit_t = oki.sum(dim=-1, dtype=torch.int32)
            base = dcnt_t if runs_axis else dcnt[0]
            tpos = torch.where(commit, base + torch.cumsum(oki, -1) - 1,
                               q_len)
            dnodes.scatter_(-1, tpos, cc)
            if runs_axis:
                dcnt_t = dcnt_t + n_commit_t[:, None]
            pending = pending & ~commit
            count(rounds, live)
            n_commit, n_pending = torch.stack(
                [n_commit_t, pending.sum(dim=-1, dtype=torch.int32)]).tolist()
            if not runs_axis:
                n_commit, n_pending = [n_commit], [n_pending]
            dcnt = [d + c for d, c in zip(dcnt, n_commit)]
            # A run stalls (waits for its next sweep) when a round commits
            # nothing; a stalled run's state is that of its last round, so
            # the rounds it sits through repeat it and commit nothing.
            live = [on and c > 0 and p > 0
                    for on, c, p in zip(live, n_commit, n_pending)]
            waiting = [p > 0 for p in n_pending]
        live = waiting
    return finish()
