"""Placement entry points (paper §4, Algorithms 1-3), the legacy layer.

Port of ``repro.core.schedulers``.  The admission loop lives in
``repro_torch.api.admission`` and the policies in
``repro_torch.api.policies``; ``node_scores``, ``place_task`` and
``schedule_queue`` keep the seed's signatures, take a ``SchedulerKind``, a
registry name or a policy object, and delegate to the shared core.

The phase-1 single-resource schedulers (``fifo_scheduler`` and
``lrf_scheduler``, Theorems 4.1-4.2) stay here as reference semantics.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import FlexParams, NodeState


def _ctx_task(node, r_task, src_bucket, penalty, params):
    from repro_torch.api.admission import PolicyContext, TaskView
    ctx = PolicyContext(node=node, penalty=penalty, params=params)
    task = TaskView(request=r_task, src=src_bucket,
                    priority=torch.zeros((), dtype=torch.int32,
                                         device=r_task.device))
    return ctx, task


def node_scores(node: NodeState, r_task: torch.Tensor,
                src_bucket: torch.Tensor, penalty: torch.Tensor,
                params: FlexParams, kind) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter + score all nodes for one task.

    r_task (R,); src_bucket () i32; penalty () f32.  Returns (scores (N,),
    feasible (N,) bool); infeasible nodes score NEG_INF.
    """
    from repro_torch.api.admission import mask_infeasible
    from repro_torch.api.registry import resolve_policy

    policy = resolve_policy(kind)
    ctx, task = _ctx_task(node, r_task, src_bucket, penalty, params)
    feasible = policy.feasible(ctx, task)
    return mask_infeasible(policy.score(ctx, task), feasible), feasible


def place_task(node: NodeState, r_task: torch.Tensor,
               src_bucket: torch.Tensor, valid: torch.Tensor,
               penalty: torch.Tensor, params: FlexParams, kind,
               use_kernel: bool = False) -> Tuple[NodeState, torch.Tensor]:
    """ScheduleOne (Alg. 3): (state, node idx or -1).

    ``valid`` () bool: False makes the call a no-op.  The returned state
    is a copy; ``node`` is not modified.
    """
    from repro_torch.api.admission import admit_one
    from repro_torch.api.registry import resolve_policy

    policy = resolve_policy(kind)
    node = NodeState(*(x.clone() for x in node))
    ctx, task = _ctx_task(node, r_task, src_bucket, penalty, params)
    return admit_one(policy, ctx, task, valid, use_kernel=use_kernel)


def schedule_queue(node: NodeState, requests: torch.Tensor,
                   src_buckets: torch.Tensor, valid: torch.Tensor,
                   penalty: torch.Tensor, params: FlexParams, kind,
                   priorities: torch.Tensor | None = None,
                   use_kernel: bool = False, batch_mode: bool = False,
                   topk: int = 8, dedup_buckets: int = 64,
                   tie_margin: float = 1e-5
                   ) -> Tuple[NodeState, torch.Tensor]:
    """Place a queue of tasks in the order given: (state, placements (Q,)).

    A policy's ``queue_order`` is the caller's concern.  ``priorities``
    defaults to all-batch.  ``use_kernel`` selects the fused kernel for
    kernel-capable policies; ``batch_mode`` admits in wavefront rounds
    over the batched kernels (same decisions, fewer node-table sweeps),
    tuned by ``topk``, ``dedup_buckets`` and ``tie_margin``.
    """
    from repro_torch.api.admission import admit_queue
    from repro_torch.api.registry import resolve_policy

    policy = resolve_policy(kind)
    if priorities is None:
        priorities = torch.zeros_like(src_buckets)
    return admit_queue(policy, node, requests, src_buckets, priorities,
                       valid, penalty, params, use_kernel=use_kernel,
                       batch_mode=batch_mode, topk=topk,
                       dedup_buckets=dedup_buckets, tie_margin=tie_margin)


# ---------------------------------------------------------------------------
# Phase-1 algorithms with precise load estimation (paper §4.1):
# single-resource, standalone.
# ---------------------------------------------------------------------------

def fifo_scheduler(loads: torch.Tensor, requests: torch.Tensor,
                   capacity: float = float("inf")
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1: visit tasks FIFO, put each on the least-loaded node.

    loads (N,) initial node loads; requests (J,) task sizes; capacity the
    per-node capacity C.  Returns (final loads (N,), assignment (J,) i32
    node index or -1).
    """
    loads = loads.clone()
    out = []
    for r in requests:
        i = torch.argmin(loads)
        added = loads[i] + r
        fits = added <= capacity
        loads[i] = torch.where(fits, added, loads[i])
        out.append(torch.where(fits, i, -1).to(torch.int32))
    if not out:
        return loads, torch.empty(0, dtype=torch.int32, device=loads.device)
    return loads, torch.stack(out)


def lrf_scheduler(loads: torch.Tensor, requests: torch.Tensor,
                  capacity: float = float("inf")
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2: largest request first, then FIFO placement.

    Returns (final loads, assignment in the ORIGINAL task order).
    """
    order = torch.argsort(-requests, stable=True)
    loads, assign_sorted = fifo_scheduler(loads, requests[order], capacity)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return loads, assign_sorted[inv]
