"""The admission-control core (paper Alg. 3 ``ScheduleOne``), sequential form.

Port of ``repro.api.admission`` up to ``admit_queue``.  One decision is a
filter + score + argmax over the node table (``pick_node``) followed by
O(1) masked scatters (``admit_one``); a queue is admitted in order by a
Python loop.  Nothing inside a decision waits for the device: the chosen
index stays a tensor, and a decision whose task is invalid or fits
nowhere commits zeros.  ``admit_queue`` copies the node state once and
then updates the copy in place, decision by decision.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.numerics import fma
from repro_torch.core.types import NUM_SRC_BUCKETS, FlexParams, NodeState

# Score of an infeasible node; equal to the kernel's sentinel
# (repro_torch.kernels.flex_score.ref.NEG_INF).
NEG_INF = -1e30

# Effective load pinned onto drained or unavailable nodes: far above any
# capacity or oversubscription factor, so every capacity filter rejects it.
DRAIN_LOAD = 1e6

# Decisions made by admit_queue, one per queue entry it was given.
DECISIONS = 0


def reset_decisions() -> None:
    global DECISIONS
    DECISIONS = 0


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

    i = torch.clamp(idx, min=0).reshape(1)
    add_f = (ok.to(torch.float32) * task.request).reshape(1, -1)
    add_i = ok.to(torch.int32).reshape(1)
    node.reserved.index_add_(0, i, add_f)
    node.requested.index_add_(0, i, add_f)
    node.n_tasks.index_add_(0, i, add_i)
    node.src_count.view(-1).index_add_(
        0, i * NUM_SRC_BUCKETS + task.src.reshape(1), add_i)
    return node, idx


def admit_queue(policy, node: NodeState, requests, srcs, priorities,
                valid, penalty, params: FlexParams, *,
                use_kernel: bool = False, batch_mode: bool = False):
    """Admit a queue of tasks in queue order, one decision per entry.

    requests (Q, R); srcs/priorities/valid (Q,).  ``batch_mode`` (wavefront
    admission over the batched kernel) comes with a later slice: it raises
    for a kernel-hooked policy and, as in the reference, is ignored for
    the others.

    Returns (NodeState, placements (Q,) i32, node index or -1).
    """
    if batch_mode and getattr(policy, "kernel_inputs", None) is not None:
        raise NotImplementedError(
            "admit_queue(batch_mode=True): wavefront admission comes with "
            "the wavefront slice of the port")
    global DECISIONS
    node = NodeState(*(x.clone() for x in node))
    q = requests.shape[0]
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
