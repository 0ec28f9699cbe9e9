"""Discrete-time cluster simulator (paper §5 evaluation substrate).

Port of ``repro.core.simulator``: a Python loop over 5-minute slots, each
running

  0. with faults (``SimConfig(faults=...)`` or a ``fault_schedule``):
     tasks resident on crashed nodes are evicted into the retry queue with
     exponential backoff; under the degradation controller's windowed QoS
     pressure up to ``degrade_evict`` residents are shed (into the reclaim
     pool when reclamation is on, else the retry queue); with migration,
     residents of draining nodes join a bounded migration pool whose
     overflow is evicted into the retry queue
  1. node aggregates of the active set (task finishes)
  2. each task's demand process, AR(1) around its mean, clipped at peak;
     fault surges multiply resident tasks' demand
  3. the WFS allocator (per-node capacity honours flaps) -> realized usage
     per node, task and cluster QoS; an evicted task counts as a violator
     in its eviction slot
  4. the penalty controller
  4.5 with ``SimConfig(guard=...)``: the estimator-drift watchdog and its
     breaker, which scale the reclaim and migrate passes' penalty
  5. the estimator refresh; reservations cleared; crashed, flapped and
     draining nodes fold their lost capacity into ``reserved``
     (``admission.mask_unavailable``); an open breaker blends admission's
     estimate toward the residents' requests
  5.5 with ``SimConfig(migration=...)``: the migration pass re-places the
     head of the migration pool (``bandwidth`` tasks) through
     ``admission.admit_queue`` with the ``migrate`` policy, in wavefront
     rounds; a moved task keeps its progress and runs ``migrate_cost``
     slots longer
  6. the policy's queue order (FIFO when absent), then retries and this
     slot's arrivals admitted in order: one decision at a time
     (``admission_mode="sequential"``) or in wavefront rounds over the
     batched kernels (``"wavefront"``); a task inside its backoff window
     (``retry_backoff``, ``retry_jitter``), or any retry while no node
     admits, stays queued without using an attempt
  7. with ``SimConfig(reclamation=True)``: tasks dropped for good (out of
     retries, or past the retry queue; with faults also evictions that
     found no room, and degrade-shed victims) join a bounded pool, which
     the ``reclaim`` policy re-admits against predicted headroom through
     the same ``admission.admit_queue`` front end, in wavefront rounds; the
     guard's breaker suspends or trickles it

and the per-slot metrics.  Each feature is gated in Python, as in the
reference: ``faults=None``, ``migration=None``, ``guard=None`` and
``retry_backoff = retry_jitter = 0`` run the fault-free loop, launch for
launch and host sync for host sync.

One loop runs B runs at once (:func:`simulate_runs`), as the reference's
``vmap`` over seeds and ``FlexParams`` sweep points does: every piece of
state leads with a run axis, each run's segment sums are segments of
their own (``b * N + node``) in one ``index_add_``, each run draws from
its own noise source, and one host sync a slot, one kernel launch a
queue, decision or sweep, serve all B.  A single run is B = 1
(:func:`simulate_core`), so there is one slot loop, not two.

The queue of a slot is compacted to its ready entries before admission:
the one host sync per slot of the sequential mode (each run's count of
ready entries, read once for all runs).  Each run's queue is then padded
to the largest count with invalid entries.  Neither changes a decision,
because an invalid entry commits nothing and is never pending in a
wavefront.  The compaction does change the wavefront's queue width Q,
where the reference pads the queue, and with it whether the score-bucket
dedup applies (``0 < dedup_buckets < Q``) and how many distinct rows it
finds; those choose how a sweep is computed, not what it returns.  The
migration and reclaim pools are compacted the same way (one host sync
each per slot).  The metrics that sum over nodes add them in the
reference's order (``numerics.xla_sum``), element-wise across the runs,
so that a run's figures do not depend on the runs beside it.

Randomness comes from a noise source (:mod:`repro_torch.core.noise`):
the demand noise, the retry-jitter table and a sampled fault schedule.
Decisions equal the reference's under ``ReplayNoise`` with the
reference's jitter table and an explicit ``fault_schedule`` (its sampled
one, through ``convert.fault_schedule_from_numpy``).  Rounding follows
the reference as XLA compiles it (:mod:`repro_torch.core.numerics`).
The ``requested`` metric is the one place where the port does not: under
a crash the reference adds ``DRAIN_LOAD`` into its float32 sum and takes
it out after, which cancels catastrophically; the port takes each node's
offset off before the sum.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import allocation, qos
from repro_torch.core.noise import GeneratorNoise, RunNoise, stack_runs
from repro_torch.core.numerics import fma, sqrt, xla_sum
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


def _node_aggregates(ts: TaskSet, placement, admit_slot, slot, n_nodes,
                     duration=None):
    """Per-node request/count/source aggregates of each run's active set
    (placement and admit_slot (B, T)); ``duration`` overrides
    ``ts.duration`` (migrated tasks run longer).  Run b's node n is the
    segment ``b * N + n`` of one sum; a task that is not active adds zeros
    to its run's node 0."""
    placed = placement >= 0
    dur = ts.duration if duration is None else duration
    active = placed & (admit_slot < slot) & (slot <= admit_slot + dur)
    seg = torch.clamp(torch.where(active, placement, 0), 0, n_nodes - 1)
    runs = active.shape[0]
    flat = _run_rows(seg, n_nodes).reshape(-1)
    maskf = active.to(torch.float32)
    act_i = active.to(I32).reshape(-1)

    requested = allocation.segment_sum(
        (ts.request * maskf[..., None]).reshape(-1, NUM_RESOURCES), flat,
        runs * n_nodes).view(runs, n_nodes, NUM_RESOURCES)
    n_tasks = allocation.segment_sum(act_i, flat, runs * n_nodes).view(
        runs, n_nodes)
    joint = flat * NUM_SRC_BUCKETS + ts.src.expand(runs, -1).reshape(-1)
    src_count = allocation.segment_sum(
        act_i, joint, runs * n_nodes * NUM_SRC_BUCKETS).view(
        runs, n_nodes, NUM_SRC_BUCKETS)
    return active, seg, requested, n_tasks, src_count


def _run_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) per-run indices into tables of ``n`` rows a run, as rows of
    the runs' tables laid end to end (``b * n + idx``)."""
    runs = idx.shape[0]
    if runs == 1:
        return idx
    return idx + n * torch.arange(runs, dtype=idx.dtype,
                                  device=idx.device).view(
        (runs,) + (1,) * (idx.dim() - 1))


def _stack(items, dim: int = 0):
    """Stack a list of (nested) NamedTuples of tensors leaf by leaf."""
    first = items[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(leaf), dim) for leaf in zip(*items)))
    return torch.stack(items, dim=dim)


def _index(tree, fn):
    """``fn`` of every tensor of a (nested) NamedTuple."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_index(leaf, fn) for leaf in tree))
    return fn(tree)


def _valid_first(ids: torch.Tensor) -> torch.Tensor:
    """``ids`` with its valid (>= 0) entries first along the last axis,
    each part in order."""
    return ids.gather(-1, torch.argsort((ids < 0).to(I32), dim=-1,
                                        stable=True))


def _compact_ids(mask: torch.Tensor, width: int) -> torch.Tensor:
    """Ids of the set tasks, lowest first, (..., width) padded with -1."""
    k = min(width, mask.shape[-1])
    order = torch.argsort((~mask).to(I32), dim=-1, stable=True)[..., :k]
    ids = torch.where(mask.gather(-1, order), order.to(I32), -1)
    if k < width:
        ids = torch.cat([ids, ids.new_full(ids.shape[:-1] + (width - k,),
                                           -1)], dim=-1)
    return ids


def _flags(ids: torch.Tensor, on: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) bool: True at the ids whose ``on`` is set (a scatter-max,
    so padding entries, clamped to 0, write nothing)."""
    return torch.zeros(ids.shape[:-1] + (n,), dtype=I32,
                       device=ids.device).scatter_reduce(
        -1, torch.clamp(ids, min=0).long(), on.to(I32), "amax").to(
        torch.bool)


def _requested_total(node: NodeState, f_off=None) -> torch.Tensor:
    """(..., R) each node's requests of running tasks plus this slot's
    reservations.  A fault offset ``f_off`` (...,) comes off each node's
    row: a down node's reserved row is ``DRAIN_LOAD`` exactly and leaves
    exactly its requests.  (The reference takes ``sum(f_off)`` off the
    float32 total instead, which cancels catastrophically.)"""
    if f_off is None:
        return node.requested + node.reserved
    return node.requested + (node.reserved - f_off[..., None])


class _Estimators:
    """The B runs' estimator states.  An estimator with ``run_axis``
    refreshes them together (its state leads with the run axis); any
    other refreshes run by run.  Run b's draws come from its own noise
    source either way."""

    def __init__(self, est, n_nodes: int, noise: RunNoise, device):
        self.impl, self.noise = est, noise
        self.together = bool(getattr(est, "run_axis", False))
        if self.together:
            self.state = est.init_state(n_nodes, device=device,
                                        runs=len(noise))
        else:
            self.state = [est.init_state(n_nodes, device=device)
                          for _ in range(len(noise))]
        self.est = self._value()

    def _value(self) -> torch.Tensor:
        if self.together:
            return self.state.est
        return stack_runs([s.est for s in self.state])

    def refresh(self, usage: torch.Tensor, slot: int) -> torch.Tensor:
        """Refresh on (B, N, R) usage; returns the (B, N, R) estimate."""
        if self.together:
            self.state = self.impl.refresh(
                self.state, usage,
                lambda shape: self.noise.estimate(slot, shape))
        else:
            self.state = [
                self.impl.refresh(s, usage[b], lambda shape, src=src:
                                  src.estimate(slot, shape))
                for b, (s, src) in enumerate(zip(self.state,
                                                 self.noise.sources))]
        self.est = self._value()
        return self.est


def _schedule_runs(sched, runs: int):
    """An explicit fault schedule for every run: tables (S, N) are shared
    (a run-axis view), (B, S, N) are each run's."""
    if sched.node_up.dim() == 3:
        return sched
    return type(sched)(*(None if x is None else x.expand((runs,) + x.shape)
                         for x in sched))


def simulate_core(ts: TaskSet, arrival_table: torch.Tensor, cfg: SimConfig,
                  policy, params: FlexParams, noise, est,
                  ctrl_impl, fault_schedule=None) -> SimResult:
    """Run ``cfg.n_slots`` slots on the device of ``ts``: one run, which is
    :func:`simulate_runs` at B = 1.

    arrival_table (S, A) i32 from :func:`build_arrival_table`; ``noise``
    a noise source; ``est`` a stateful estimator; ``ctrl_impl`` a penalty
    controller; ``fault_schedule`` an explicit
    :class:`repro_torch.faults.FaultSchedule` (else ``cfg.faults`` has the
    noise source sample one).
    """
    res = simulate_runs(ts, arrival_table, cfg, policy,
                        FlexParams(*(p.reshape(1) for p in params)),
                        RunNoise([noise]), est, ctrl_impl, fault_schedule)
    return _index(res, lambda x: x[0])


def simulate_runs(ts: TaskSet, arrival_table: torch.Tensor, cfg: SimConfig,
                  policy, params: FlexParams, noise: RunNoise, est,
                  ctrl_impl, fault_schedule=None) -> SimResult:
    """Run ``cfg.n_slots`` slots of B runs at once on the device of ``ts``.

    The runs share the trace, the arrival table, the cluster, the policy,
    the estimator and the controller; ``params``' leaves are (B,), one
    sweep point a run, and ``noise`` holds each run's noise source
    (:class:`repro_torch.core.noise.RunNoise`).  ``fault_schedule`` is
    shared ((S, N) tables) or each run's ((B, S, N)); without one,
    ``cfg.faults`` has each run's source sample its own.  Every leaf of
    the result leads with B, and run b's equals the result of
    :func:`simulate_core` on run b's params and source, leaf for leaf and
    bit for bit.
    """
    from repro_torch.api import admission
    from repro_torch.api.policies import ReclaimPolicy
    from repro_torch.api.protocols import policy_queue_order
    from repro_torch.faults import degrade as _degrade
    from repro_torch.faults import injection as _inject

    if cfg.admission_mode not in ("sequential", "wavefront"):
        raise ValueError(
            f"unknown SimConfig.admission_mode {cfg.admission_mode!r}; "
            f"expected 'sequential' or 'wavefront'")
    if not isinstance(noise, RunNoise):
        noise = RunNoise(noise)
    runs = len(noise)
    per_run = admission.per_run
    dev = ts.arrival.device
    n_nodes, n_slots = cfg.n_nodes, cfg.n_slots
    T = ts.num_tasks
    Qr = cfg.retry_capacity
    queue_order = policy_queue_order(policy)
    record = cfg.record_node_usage
    batch_mode = cfg.admission_mode == "wavefront"
    knobs = dict(use_kernel=cfg.use_kernel, topk=cfg.wavefront_topk,
                 dedup_buckets=cfg.dedup_buckets,
                 tie_margin=cfg.wavefront_tie_margin)

    # Each feature is gated in Python, as in the reference.
    fcfg = cfg.faults
    faults_on = fcfg is not None or fault_schedule is not None
    jitter_on = cfg.retry_jitter > 0
    backoff_on = faults_on or cfg.retry_backoff > 0 or jitter_on
    degrade_on = bool(faults_on and fcfg is not None and fcfg.degrade)
    shed_to_pool = degrade_on and cfg.reclamation
    mcfg = cfg.migration
    migration_on = mcfg is not None
    gcfg = cfg.guard
    guard_on = gcfg is not None
    if migration_on and not faults_on:
        raise ValueError(
            "SimConfig.migration requires fault injection (SimConfig.faults "
            "or an explicit fault_schedule): the migration pass is driven by "
            "the schedule's drain/crash tables")
    if jitter_on:
        jit_tab = noise.jitter(T, cfg.retry_jitter).to(dev)      # (B, T)
    if faults_on:
        if fault_schedule is None:
            fault_schedule = noise.faults(fcfg, n_slots, n_nodes)
        fault_schedule = _schedule_runs(fault_schedule, runs).to(dev)
        if migration_on and fault_schedule.draining is None:
            fault_schedule = fault_schedule._replace(
                draining=torch.zeros((runs, n_slots, n_nodes),
                                     dtype=torch.bool, device=dev))
    if degrade_on:
        thr = (torch.full((runs,), float(np.float32(fcfg.degrade_threshold)),
                          dtype=torch.float32, device=dev)
               if fcfg.degrade_threshold > 0 else params.qos_target)
    if migration_on:
        from repro_torch.api.policies import MigratePolicy

        migrate_policy = MigratePolicy(margin_scale=mcfg.margin_scale)
        mig_B = max(min(int(mcfg.bandwidth), int(mcfg.pool_size)), 0)
    if guard_on:
        from repro_torch.guard import watchdog as _wd

    ctrl = ctrl_impl.init(params)
    ests = _Estimators(est, n_nodes, noise, dev)
    full = lambda width, value, dtype=I32: torch.full(
        (runs, width), value, dtype=dtype, device=dev)
    placement = full(T, -1)
    admit_slot = full(T, -1)
    attempts = full(T, 0)
    qos_ok = full(T, 0)
    active_cnt = full(T, 0)
    ar_noise = full(T, 0.0, torch.float32)
    retry = full(Qr, -1)
    zero_i = torch.zeros(runs, dtype=I32, device=dev)
    n_rejected = zero_i
    empty_nr = torch.zeros((runs, 0, NUM_RESOURCES), dtype=torch.float32,
                           device=dev)
    empty_i = full(0, 0)
    empty_f = full(0, 0.0, torch.float32)
    retry_pos = torch.arange(Qr, dtype=I32, device=dev)
    n_reclaimed = zero_i
    if cfg.reclamation:
        reclaim_policy = ReclaimPolicy(margin_scale=cfg.reclaim_margin)
        pool = full(cfg.reclaim_pool, -1)
    if backoff_on:
        next_try = full(T, 0)
    if faults_on:
        n_fault_ev = zero_i
    if degrade_on:
        qos_win = full(fcfg.qos_window, 1.0, torch.float32)
        n_degrade_ev = zero_i
        reclaimed = full(T, False, torch.bool)
    if migration_on:
        mig_pool = full(mcfg.pool_size, -1)
        extra_slots = full(T, 0)
        n_migrated = n_mig_failed = zero_i
    if guard_on:
        g_win = stack_runs([_wd.init_window(gcfg.window, NUM_RESOURCES,
                                            device=dev)] * runs)
        g_state = g_timer = n_guard_def = zero_i
    innov = sqrt(torch.clamp(fma(-ts.ar_rho, ts.ar_rho, 1.0), min=0.0))

    def queue_of(ids):
        """The tasks ``ids`` (B, Q), clamped, as admit_queue's queue."""
        return ts.request[ids], ts.src[ids], ts.priority[ids]

    metrics = []
    for slot in range(n_slots):
        if faults_on:
            slot_up = fault_schedule.node_up[:, slot]          # (B, N)
            slot_cap = fault_schedule.capacity[:, slot]
            slot_mult = fault_schedule.demand_mult[:, slot]
        # migrated tasks run migrate_cost extra slots
        dur = ts.duration + extra_slots if migration_on else ts.duration
        placement_in, admit_in = placement, admit_slot

        # --- 0. fault, degradation and migration-overflow evictions -------
        # Before the aggregates, so freed capacity is admissible this slot.
        if faults_on:
            resident = (placement_in >= 0) & (slot <= admit_in + dur)
            host = torch.clamp(placement_in, 0, n_nodes - 1).long()
            on_down = resident & ~slot_up.gather(1, host)
            n_fault_ev = n_fault_ev + on_down.sum(dim=1, dtype=I32)
            evict_mask = on_down
            degrade_mask = torch.zeros_like(on_down)
            if degrade_on:
                pressure = per_run(_degrade.under_pressure, qos_win, thr)
                rank = _degrade.victim_rank(
                    ts.priority, reclaimed if cfg.reclamation
                    else torch.zeros_like(reclaimed),
                    fcfg.degrade_spare_production)
                degrade_mask = _degrade.select_victims(
                    resident & ~on_down & pressure[:, None], rank, admit_in,
                    n_slots, fcfg.degrade_evict)
                evict_mask = on_down | degrade_mask
                n_degrade_ev = n_degrade_ev + degrade_mask.sum(dim=1,
                                                               dtype=I32)
            forced_retry = on_down
            if migration_on:
                # Drain sources: announced warning windows and, with an
                # overload threshold, nodes whose last estimate is hot;
                # never a down node (its residents were just evicted).
                drain_src = fault_schedule.draining[:, slot]
                if mcfg.overload_threshold > 0:
                    drain_src = drain_src | (
                        ests.est.max(dim=-1).values
                        > float(np.float32(mcfg.overload_threshold)))
                drain_src = drain_src & slot_up
                want = resident & ~evict_mask & drain_src.gather(1, host)
                # Carried entries leave silently when their node recovered
                # or they finished or were evicted; new ones merge in,
                # valid-first; the overflow is evicted into the retry queue.
                pool_keep = (mig_pool >= 0) & want.gather(
                    1, torch.clamp(mig_pool, min=0).long())
                in_pool = _flags(mig_pool, pool_keep, T)
                merged_m = _valid_first(torch.cat([
                    torch.where(pool_keep, mig_pool, -1),
                    _compact_ids(want & ~in_pool, mcfg.pool_size)], dim=1))
                mig_pool = merged_m[:, :mcfg.pool_size]
                mig_over = merged_m[:, mcfg.pool_size:]
                over_mask = _flags(mig_over, mig_over >= 0, T)
                n_mig_failed = n_mig_failed + (mig_over >= 0).sum(dim=1,
                                                                  dtype=I32)
                evict_mask = evict_mask | over_mask
                forced_retry = forced_retry | over_mask
            placement_in = torch.where(evict_mask, -1, placement_in)
            admit_in = torch.where(evict_mask, -1, admit_in)
            # Evictions through the retry queue use an attempt and arm the
            # backoff; pool-shed victims wait on the reclaim pass instead.
            retry_evict = forced_retry if shed_to_pool else evict_mask
            attempts = attempts + retry_evict.to(I32)
            ev_delay = _inject.backoff_delay(attempts, cfg.retry_backoff,
                                             cfg.retry_backoff_cap)
            if jitter_on:
                ev_delay = ev_delay + jit_tab
            next_try = torch.where(retry_evict, slot + 1 + ev_delay,
                                   next_try)
            evict_requeue = retry_evict & (attempts <= cfg.max_retries)
            evict_exhausted = retry_evict & (attempts > cfg.max_retries)

        # --- 1. node aggregates for the active set ------------------------
        active, seg, requested, n_tasks, src_count = _node_aggregates(
            ts, placement_in, admit_in, slot, n_nodes,
            dur if migration_on else None)

        # --- 2. demand process: AR(1) around the task mean -----------------
        white = noise.demand(slot, T)                            # (B, T)
        ar_noise = fma(ts.ar_rho, ar_noise, innov * white)
        demand = torch.minimum(
            torch.clamp(fma(ts.std_usage, ar_noise[..., None],
                            ts.mean_usage), min=0.0),
            ts.peak_usage) * cfg.demand_scale
        if faults_on:
            # a surge multiplies the demand of the tasks resident there
            demand = demand * torch.where(
                active, slot_mult.gather(1, seg.long()), 1.0)[..., None]
        demand = torch.clamp(demand, max=1.0)

        # --- 3. allocation + QoS --------------------------------------------
        wfs_cap = torch.where(slot_up, slot_cap, 0.0) if faults_on else 1.0
        alloc, node_usage = allocation.wfs_allocate(
            demand, ts.request, placement_in, active, n_nodes,
            capacity=wfs_cap, iters=cfg.wfs_iters)
        q_task = qos.task_qos(alloc, demand, ts.request)
        if faults_on:
            # an eviction is a broken SLO: victims count as violators
            q_cluster = qos.cluster_qos(q_task & ~evict_mask,
                                        active | evict_mask)
        else:
            q_cluster = qos.cluster_qos(q_task, active)
        qos_ok = qos_ok + (q_task & active).to(I32)
        active_cnt = active_cnt + active.to(I32)

        # --- 4. penalty controller ------------------------------------------
        ctrl = ctrl_impl.update(ctrl, q_cluster, params)

        # --- 4.5 estimator-drift watchdog + breaker -------------------------
        # Last slot's estimate judged this slot's admissions: its error
        # against this slot's usage is the drift; the state it gives
        # governs this slot's passes.
        pass_penalty = ctrl.penalty
        if guard_on:
            g_win = per_run(lambda w, e, u: _wd.push_errors(
                w, _wd.drift_sample(e, u)), g_win, ests.est, node_usage)
            g_err_q = per_run(lambda w: _wd.trip_statistic(
                w, gcfg.err_quantile), g_win)
            g_state, g_timer, _ = _wd.breaker_step(g_state, g_timer,
                                                   g_err_q, gcfg)
            pass_penalty = ctrl.penalty * _wd.penalty_scale(g_err_q, gcfg)

        # --- 5. estimator refresh -------------------------------------------
        est_now = ests.refresh(node_usage, slot)
        est_adm = est_now
        if guard_on:
            # while OPEN, admission judges nodes by the estimate blended
            # toward the residents' requests (the metrics keep the raw one)
            est_adm = per_run(lambda e, r, o: _wd.blend_estimate(e, r, o,
                                                                 gcfg),
                              est_now, requested, g_state == _wd.OPEN)
        node = NodeState(est_usage=est_adm,
                         reserved=torch.zeros_like(node_usage),
                         requested=requested, n_tasks=n_tasks,
                         src_count=src_count)
        if faults_on:
            # Down, flapped and (with migration) draining nodes: the
            # offset excludes the sources as migration targets too.
            avail = slot_up & ~drain_src if migration_on else slot_up
            f_off = admission.fault_load_offset(avail, slot_cap)
            node = admission.mask_unavailable(node, f_off)

        # --- 5.5 live migration off draining nodes --------------------------
        # Before primary admission; a moved task re-places next slot (it
        # still runs on its source this slot) with its admit slot kept.
        if migration_on and mig_B > 0:
            n_mig = (mig_pool[:, :mig_B] >= 0).sum(dim=1).tolist()  # sync
            aqi = mig_pool[:, :max(n_mig)]
            node, m_idx = admission.admit_queue(
                migrate_policy, node, *queue_of(torch.clamp(aqi, min=0)),
                aqi >= 0, pass_penalty, params, lens=n_mig,
                **dict(knobs, batch_mode=True))
            m_ok = m_idx >= 0
            moved = _flags(aqi, m_ok, T)
            target = torch.zeros((runs, T), dtype=I32,
                                 device=dev).scatter_reduce(
                1, torch.clamp(aqi, min=0).long(),
                torch.where(m_ok, m_idx, 0), "amax")
            placement_in = torch.where(moved, target, placement_in)
            extra_slots = extra_slots + torch.where(
                moved, int(mcfg.migrate_cost), 0).to(I32)
            n_migrated = n_migrated + m_ok.sum(dim=1, dtype=I32)
            # successes leave the pool; failures try again next slot
            mig_pool = _valid_first(torch.cat([
                torch.where(m_ok, -1, aqi), mig_pool[:, aqi.shape[1]:]],
                dim=1))

        # --- 6. scheduling: retries first, then new arrivals ----------------
        arrivals = arrival_table[slot]
        queue_ids = torch.cat([retry, arrivals.expand(runs, -1)], dim=1)
        if queue_order is not None:
            pre_valid = queue_ids >= 0
            pre_qi = torch.clamp(queue_ids, min=0)
            order = per_run(queue_order, ts.request[pre_qi],
                            ts.priority[pre_qi], pre_valid)
            queue_ids = queue_ids.gather(1, order)
        valid = queue_ids >= 0
        qi = torch.clamp(queue_ids, min=0)
        if backoff_on:
            # inside the backoff window a task stays queued, no attempt
            ready = valid & (slot >= next_try.gather(1, qi.long()))
            if faults_on:
                # while no node admits, a retry is deferred the same way
                ready = ready & avail.any(dim=1)[:, None]
        else:
            ready = valid
        n_ready = ready.sum(dim=1, dtype=I32)
        lens = n_ready.tolist()                   # the slot's host sync
        q_max = max(lens)
        pos = torch.argsort((~ready).to(I32), dim=1, stable=True)[:, :q_max]
        ci = qi.gather(1, pos)
        node, placed_c = admission.admit_queue(
            policy, node, *queue_of(ci),
            torch.arange(q_max, device=dev) < n_ready[:, None], ctrl.penalty,
            params, lens=lens, **dict(knobs, batch_mode=batch_mode))
        placed_idx = torch.full_like(queue_ids, -1).scatter(1, pos, placed_c)

        ok = ready & (placed_idx >= 0)
        placement = placement_in.scatter_reduce(
            1, qi.long(), torch.where(ok, placed_idx, -1), "amax")
        admit_slot = admit_in.scatter_reduce(
            1, qi.long(), torch.where(ok, slot, -1).to(I32), "amax")

        # retry bookkeeping
        failed = ready & (placed_idx < 0)
        attempts = attempts.scatter_add(1, qi.long(), failed.to(I32))
        att_q = attempts.gather(1, qi.long())
        if backoff_on:
            delay = _inject.backoff_delay(att_q, cfg.retry_backoff,
                                          cfg.retry_backoff_cap)
            if jitter_on:
                delay = delay + jit_tab.gather(1, qi.long())
            # a scatter-max: padding entries (task 0) write a no-op 0, and
            # a task's next_try only grows
            next_try = next_try.scatter_reduce(
                1, qi.long(), torch.where(failed, slot + 1 + delay, 0),
                "amax")
        eligible = failed & (att_q <= cfg.max_retries)
        if backoff_on:
            eligible = eligible | (valid & ~ready)   # deferred stay queued
        retry_order = torch.argsort((~eligible).to(I32), dim=1, stable=True)
        sorted_ids = queue_ids.gather(1, retry_order)
        n_eligible = eligible.sum(dim=1, dtype=I32)
        retry = torch.where(retry_pos < n_eligible[:, None],
                            sorted_ids[:, :Qr], -1)
        exhausted = failed & (att_q > cfg.max_retries)
        n_dropped = (exhausted.sum(dim=1, dtype=I32)
                     + torch.clamp(n_eligible - Qr, min=0))

        if faults_on:
            # Evicted tasks were resident, so not in this queue: they join
            # the rebuilt retry queue behind it; the overflow drops (or
            # pools).
            ev_ids = _compact_ids(evict_requeue, Qr)
            ev_lost = (evict_requeue.sum(dim=1, dtype=I32)
                       - (ev_ids >= 0).sum(dim=1, dtype=I32))
            merged_r = _valid_first(torch.cat([retry, ev_ids], dim=1))
            merge_over = merged_r[:, Qr:]
            retry = merged_r[:, :Qr]
            n_dropped = (n_dropped + ev_lost
                         + evict_exhausted.sum(dim=1, dtype=I32)
                         + (merge_over >= 0).sum(dim=1, dtype=I32))

        # --- 7. headroom reclamation ------------------------------------------
        if cfg.reclamation:
            # Tasks dropped for good join the pool, valid-first in queue
            # order; only the pool's overflow counts as rejected.
            rank = torch.argsort(retry_order, dim=1)  # queue pos -> sorted
            pooled = exhausted | (eligible & (rank >= Qr))
            parts = [pool, torch.where(pooled, queue_ids, -1)]
            if faults_on:
                # fault evictions feed the pool too: the retry queue's
                # overflow, exhausted evictions and degrade-shed victims
                pool_evict = evict_exhausted
                if shed_to_pool:
                    pool_evict = pool_evict | degrade_mask
                parts += [merge_over, _compact_ids(pool_evict, Qr)]
            merged = _valid_first(torch.cat(parts, dim=1))
            pool = merged[:, :cfg.reclaim_pool]
            n_pool = (pool >= 0).sum(dim=1, dtype=I32)
            n_rejected = n_rejected + ((merged >= 0).sum(dim=1, dtype=I32)
                                       - n_pool)
            if faults_on:
                n_rejected = n_rejected + ev_lost
            # Admit the pool's valid prefix (the pass's host sync), judged
            # by P * L-hat + reserved against the penalty-derived cap, in
            # wavefront rounds; the breaker suspends it while OPEN and
            # trickles its head while HALF_OPEN.
            n_admit = n_pool
            if guard_on:
                n_admit = torch.minimum(n_pool, _wd.reclaim_width(
                    g_state, cfg.reclaim_pool, gcfg))
                n_guard_def = n_guard_def + (n_pool - n_admit)
            r_lens = n_admit.tolist()
            pi = pool[:, :max(r_lens)]
            node, r_idx = admission.admit_queue(
                reclaim_policy, node, *queue_of(torch.clamp(pi, min=0)),
                torch.arange(pi.shape[1], device=dev) < n_admit[:, None],
                pass_penalty, params, lens=r_lens,
                **dict(knobs, batch_mode=True))
            r_ok = r_idx >= 0
            p_rows = torch.clamp(pi, min=0).long()
            placement = placement.scatter_reduce(
                1, p_rows, torch.where(r_ok, r_idx, -1), "amax")
            admit_slot = admit_slot.scatter_reduce(
                1, p_rows, torch.where(r_ok, slot, -1).to(I32), "amax")
            n_reclaimed = n_reclaimed + r_ok.sum(dim=1, dtype=I32)
            pool = _valid_first(torch.cat([torch.where(r_ok, -1, pi),
                                           pool[:, pi.shape[1]:]], dim=1))
            if degrade_on:
                # reclaimed tasks are the degradation's first victims
                reclaimed = reclaimed | _flags(pi, r_ok, T)
        else:
            n_rejected = n_rejected + n_dropped

        # --- metrics ----------------------------------------------------------
        # Sums over nodes in the reference's order (XLA's tree of float32
        # adds), each add element-wise across the runs, so that a run's
        # figures do not depend on the runs beside it.
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        held = _requested_total(NodeState(*map(flat, node)),
                                flat(f_off) if faults_on else None)
        sums = xla_sum(torch.cat([node_usage, held.view_as(node_usage),
                                  est_now], dim=-1).transpose(0, 1)) / n_nodes
        usage, requested_m, est_m = sums.split(node_usage.shape[-1], dim=-1)
        spread = torch.square(node_usage - usage[:, None]).transpose(0, 1)
        metrics.append(SlotMetrics(
            usage=usage,
            requested=requested_m,
            qos=q_cluster,
            penalty=ctrl.penalty,
            usage_std=sqrt(xla_sum(spread) / n_nodes),
            usage_mean=usage,
            n_running=active.sum(dim=1, dtype=I32),
            n_rejected=n_rejected,
            node_usage=node_usage if record else empty_nr,
            est_usage=est_m,
            node_est=est_now if record else empty_nr,
            node_requested=requested if record else empty_nr,
            n_reclaimed=n_reclaimed,
            n_fault_evicted=n_fault_ev if faults_on else zero_i,
            n_degrade_evicted=n_degrade_ev if degrade_on else zero_i,
            degraded=pressure.to(I32) if degrade_on else zero_i,
            n_migrated=n_migrated if migration_on else zero_i,
            n_migration_failed=n_mig_failed if migration_on else zero_i,
            guard_tripped=g_state if guard_on else empty_i,
            n_guard_deferred=n_guard_def if guard_on else empty_i,
            guard_err_q=g_err_q if guard_on else empty_f,
        ))
        if degrade_on:
            qos_win = per_run(_degrade.push_window, qos_win, q_cluster)

    return SimResult(metrics=_stack(metrics, dim=1), placement=placement,
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
             estimator=None, controller=None, fault_schedule=None, *,
             device="cuda") -> SimResult:
    """Simulation with policy/estimator/controller normalization.

    ``policy`` is a registry name, a ``SchedulerKind`` or a policy object;
    ``noise`` a noise source; ``fault_schedule`` an explicit
    :class:`repro_torch.faults.FaultSchedule`, which overrides the one
    ``SimConfig(faults=...)`` would sample.  Runs on ``device``.
    """
    policy, params, est, ctrl_impl = _resolve(
        policy, params, estimator, estimator_kind, est_noise_std, controller,
        cfg, device=device)
    return simulate_core(ts.to(device), arrival_table.to(device), cfg,
                         policy, params, noise, est, ctrl_impl,
                         fault_schedule)


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
