"""Discrete-time cluster simulator (paper §5 evaluation substrate).

Port of ``repro.core.simulator`` for the sequential admission path: a
Python loop over 5-minute slots, each running

  1. node aggregates of the active set (task finishes)
  2. each task's demand process, AR(1) around its mean, clipped at peak
  3. the WFS allocator -> realized usage per node, task and cluster QoS
  4. the penalty controller
  5. the estimator refresh; reservations cleared
  6. the policy's queue order (FIFO when absent), then retries and this
     slot's arrivals admitted one decision at a time

and the per-slot metrics.  Faults, migration, the guard, reclamation and
retry backoff/jitter come with later slices (``NotImplementedError``).

The queue of a slot is compacted to its ready entries before admission:
the one host sync per slot.  It leaves every decision unchanged, because
an invalid entry commits nothing.  Randomness comes from a noise source
(:mod:`repro_torch.core.noise`); decisions equal the reference's under
``ReplayNoise``.  Rounding follows the reference as XLA compiles it
(:mod:`repro_torch.core.numerics`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import allocation, qos
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.numerics import fma, sqrt
from repro_torch.core.types import (
    NUM_RESOURCES,
    NUM_SRC_BUCKETS,
    FlexParams,
    NodeState,
    SimConfig,
    SimResult,
    SlotMetrics,
    TaskSet,
)

I32 = torch.int32


def build_arrival_table(arrival: np.ndarray, n_slots: int,
                        width: int) -> np.ndarray:
    """(S, width) table of task indices arriving at each slot; -1 padded.

    Host-side preprocessing (numpy), as in the reference.
    """
    arrival = np.asarray(arrival)
    table = np.full((n_slots, width), -1, dtype=np.int32)
    order = np.argsort(arrival, kind="stable")
    slots = arrival[order]
    start = 0
    for s in range(n_slots):
        end = start
        while end < len(slots) and slots[end] == s:
            end += 1
        take = min(end - start, width)
        table[s, :take] = order[start:start + take]
        start = end
    return table


def _node_aggregates(ts: TaskSet, placement, admit_slot, slot, n_nodes):
    """Per-node request/count/source aggregates of the active set."""
    placed = placement >= 0
    active = placed & (admit_slot < slot) & (slot <= admit_slot + ts.duration)
    seg = torch.clamp(torch.where(active, placement, 0), 0, n_nodes - 1)
    maskf = active.to(torch.float32)
    act_i = active.to(I32)

    requested = allocation.segment_sum(ts.request * maskf[:, None], seg,
                                       n_nodes)
    n_tasks = allocation.segment_sum(act_i, seg, n_nodes)
    joint = seg * NUM_SRC_BUCKETS + ts.src
    src_count = allocation.segment_sum(
        act_i, joint, n_nodes * NUM_SRC_BUCKETS).reshape(n_nodes,
                                                         NUM_SRC_BUCKETS)
    return active, seg, requested, n_tasks, src_count


def _check_supported(cfg: SimConfig) -> None:
    later = [
        (cfg.faults is not None, "SimConfig.faults", "faults"),
        (cfg.migration is not None, "SimConfig.migration", "migration"),
        (cfg.guard is not None, "SimConfig.guard", "guard"),
        (cfg.reclamation, "SimConfig.reclamation",
         "estimators and reclamation"),
        (cfg.retry_backoff > 0, "SimConfig.retry_backoff", "faults"),
        (cfg.retry_jitter > 0, "SimConfig.retry_jitter", "faults"),
        (cfg.admission_mode == "wavefront",
         "SimConfig(admission_mode='wavefront')", "wavefront admission"),
    ]
    for on, what, slice_name in later:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet: it comes with the "
                f"{slice_name} slice of the port")
    if cfg.admission_mode != "sequential":
        raise ValueError(
            f"unknown SimConfig.admission_mode {cfg.admission_mode!r}; "
            f"expected 'sequential' or 'wavefront'")


def _stack(items):
    """Stack a list of (nested) NamedTuples of tensors leaf by leaf."""
    first = items[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(leaf)) for leaf in zip(*items)))
    return torch.stack(items)


def simulate_core(ts: TaskSet, arrival_table: torch.Tensor, cfg: SimConfig,
                  policy, params: FlexParams, noise, est,
                  ctrl_impl) -> SimResult:
    """Run ``cfg.n_slots`` slots on the device of ``ts``.

    arrival_table (S, A) i32 from :func:`build_arrival_table`; ``noise``
    a noise source; ``est`` a stateful estimator; ``ctrl_impl`` a penalty
    controller.
    """
    from repro_torch.api import admission
    from repro_torch.api.protocols import policy_queue_order

    _check_supported(cfg)
    dev = ts.arrival.device
    n_nodes, n_slots = cfg.n_nodes, cfg.n_slots
    T = ts.num_tasks
    Qr = cfg.retry_capacity
    queue_order = policy_queue_order(policy)
    record = cfg.record_node_usage

    ctrl = ctrl_impl.init(params)
    est_state = est.init_state(n_nodes, device=dev)
    placement = torch.full((T,), -1, dtype=I32, device=dev)
    admit_slot = torch.full((T,), -1, dtype=I32, device=dev)
    attempts = torch.zeros(T, dtype=I32, device=dev)
    qos_ok = torch.zeros(T, dtype=I32, device=dev)
    active_cnt = torch.zeros(T, dtype=I32, device=dev)
    ar_noise = torch.zeros(T, dtype=torch.float32, device=dev)
    retry = torch.full((Qr,), -1, dtype=I32, device=dev)
    n_rejected = torch.zeros((), dtype=I32, device=dev)
    zero_i = torch.zeros((), dtype=I32, device=dev)
    empty_nr = torch.zeros((0, NUM_RESOURCES), dtype=torch.float32,
                           device=dev)
    empty_i = torch.zeros((0,), dtype=I32, device=dev)
    empty_f = torch.zeros((0,), dtype=torch.float32, device=dev)
    retry_pos = torch.arange(Qr, dtype=I32, device=dev)
    innov = sqrt(torch.clamp(fma(-ts.ar_rho, ts.ar_rho, 1.0), min=0.0))

    metrics = []
    for slot in range(n_slots):
        # --- 1. node aggregates for the active set ------------------------
        active, seg, requested, n_tasks, src_count = _node_aggregates(
            ts, placement, admit_slot, slot, n_nodes)

        # --- 2. demand process: AR(1) around the task mean -----------------
        white = noise.demand(slot, T)
        ar_noise = fma(ts.ar_rho, ar_noise, innov * white)
        demand = torch.minimum(
            torch.clamp(fma(ts.std_usage, ar_noise[:, None], ts.mean_usage),
                        min=0.0), ts.peak_usage) * cfg.demand_scale
        demand = torch.clamp(demand, max=1.0)

        # --- 3. allocation + QoS --------------------------------------------
        alloc, node_usage = allocation.wfs_allocate(
            demand, ts.request, placement, active, n_nodes,
            iters=cfg.wfs_iters)
        q_task = qos.task_qos(alloc, demand, ts.request)
        q_cluster = qos.cluster_qos(q_task, active)
        qos_ok = qos_ok + (q_task & active).to(I32)
        active_cnt = active_cnt + active.to(I32)

        # --- 4. penalty controller ------------------------------------------
        ctrl = ctrl_impl.update(ctrl, q_cluster, params)

        # --- 5. estimator refresh -------------------------------------------
        est_state = est.refresh(
            est_state, node_usage,
            lambda shape, slot=slot: noise.estimate(slot, shape))
        node = NodeState(est_usage=est_state.est,
                         reserved=torch.zeros_like(node_usage),
                         requested=requested, n_tasks=n_tasks,
                         src_count=src_count)

        # --- 6. scheduling: retries first, then new arrivals ----------------
        queue_ids = torch.cat([retry, arrival_table[slot]])
        if queue_order is not None:
            pre_valid = queue_ids >= 0
            pre_qi = torch.clamp(queue_ids, min=0)
            order = queue_order(ts.request[pre_qi], ts.priority[pre_qi],
                                pre_valid)
            queue_ids = queue_ids[order]
        valid = queue_ids >= 0
        qi = torch.clamp(queue_ids, min=0)
        ready = valid
        pos = torch.nonzero(ready).squeeze(1)     # the slot's host sync
        ci = qi[pos]
        node, placed_c = admission.admit_queue(
            policy, node, ts.request[ci], ts.src[ci], ts.priority[ci],
            torch.ones_like(ci, dtype=torch.bool), ctrl.penalty, params,
            use_kernel=cfg.use_kernel)
        placed_idx = torch.full_like(queue_ids, -1).index_copy_(
            0, pos, placed_c)

        ok = ready & (placed_idx >= 0)
        placement = placement.scatter_reduce(
            0, qi.long(), torch.where(ok, placed_idx, -1), "amax")
        admit_slot = admit_slot.scatter_reduce(
            0, qi.long(), torch.where(ok, slot, -1).to(I32), "amax")

        # retry bookkeeping
        failed = ready & (placed_idx < 0)
        attempts = attempts.index_add(0, qi, failed.to(I32))
        eligible = failed & (attempts[qi] <= cfg.max_retries)
        retry_order = torch.argsort((~eligible).to(I32), stable=True)
        sorted_ids = queue_ids[retry_order]
        n_eligible = eligible.sum(dtype=I32)
        retry = torch.where(retry_pos < n_eligible, sorted_ids[:Qr], -1)
        exhausted = failed & (attempts[qi] > cfg.max_retries)
        n_dropped = (exhausted.sum(dtype=I32)
                     + torch.clamp(n_eligible - Qr, min=0))
        n_rejected = n_rejected + n_dropped

        # --- metrics ----------------------------------------------------------
        req_total = (node.requested + node.reserved).sum(dim=0)
        metrics.append(SlotMetrics(
            usage=node_usage.sum(dim=0) / n_nodes,
            requested=req_total / n_nodes,
            qos=q_cluster,
            penalty=ctrl.penalty,
            usage_std=torch.std(node_usage, dim=0, correction=0),
            usage_mean=node_usage.mean(dim=0),
            n_running=active.sum(dtype=I32),
            n_rejected=n_rejected,
            node_usage=node_usage if record else empty_nr,
            est_usage=est_state.est.sum(dim=0) / n_nodes,
            node_est=est_state.est if record else empty_nr,
            node_requested=requested if record else empty_nr,
            n_reclaimed=zero_i,
            n_fault_evicted=zero_i,
            n_degrade_evicted=zero_i,
            degraded=zero_i,
            n_migrated=zero_i,
            n_migration_failed=zero_i,
            guard_tripped=empty_i,
            n_guard_deferred=empty_i,
            guard_err_q=empty_f,
        ))

    return SimResult(metrics=_stack(metrics), placement=placement,
                     admit_slot=admit_slot, qos_ok_slots=qos_ok,
                     active_slots=active_cnt)


def _resolve(policy, params, estimator, estimator_kind, est_noise_std,
             controller, cfg: SimConfig | None = None, *, device="cuda"):
    """Normalize the open-API knobs (policy, params, estimator, controller).

    Estimator precedence: an explicit ``estimator`` argument, then a
    non-empty ``SimConfig.estimator``, then ``estimator_kind``.
    """
    from repro_torch.api.policies import (AimdPenaltyController,
                                          resolve_estimator)
    from repro_torch.api.protocols import (policy_default_params,
                                           policy_prepare_params)
    from repro_torch.api.registry import resolve_policy

    policy = resolve_policy(policy)
    if params is None:
        params = policy_default_params(policy, device=device)
    params = FlexParams(*(p.to(device) for p in params))
    params = policy_prepare_params(policy, params)
    if estimator is None:
        estimator = (cfg.estimator if cfg is not None and cfg.estimator
                     else estimator_kind)
    est = resolve_estimator(estimator, est_noise_std)
    ctrl_impl = (controller if controller is not None
                 else AimdPenaltyController())
    return policy, params, est, ctrl_impl


def simulate(ts: TaskSet, arrival_table: torch.Tensor, cfg: SimConfig,
             policy, params: FlexParams | None, noise,
             estimator_kind: str = "current", est_noise_std: float = 0.0,
             estimator=None, controller=None, *, device="cuda") -> SimResult:
    """Simulation with policy/estimator/controller normalization.

    ``policy`` is a registry name, a ``SchedulerKind`` or a policy object;
    ``noise`` a noise source.  Runs on ``device``.
    """
    policy, params, est, ctrl_impl = _resolve(
        policy, params, estimator, estimator_kind, est_noise_std, controller,
        cfg, device=device)
    return simulate_core(ts.to(device), arrival_table.to(device), cfg,
                         policy, params, noise, est, ctrl_impl)


def run(ts: TaskSet, cfg: SimConfig, policy,
        params: FlexParams | None = None, seed: int = 0, *, device="cuda",
        noise=None, **kw) -> SimResult:
    """Convenience entry point: host-side arrival table + simulate.

    ``noise`` defaults to ``GeneratorNoise(seed, device)``.
    """
    table = build_arrival_table(ts.arrival.cpu().numpy(), cfg.n_slots,
                                cfg.arrivals_per_slot)
    if noise is None:
        noise = GeneratorNoise(seed, device)
    return simulate(ts, torch.from_numpy(table), cfg, policy, params, noise,
                    device=device, **kw)
