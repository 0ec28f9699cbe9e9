"""Continuous-batching serving engine whose admission control is Flex.

Port of ``repro.serving.engine``.  The paper's scenario for LLM inference:

  node      -> inference replica (a model instance with a KV-token budget)
  request r -> prompt_len + max_tokens the client DECLARES (over-estimated)
  usage L   -> prompt_len + tokens generated so far (the real KV footprint)
  QoS q_j   -> request finishes without eviction
  penalty P -> Alg. 3 feedback on the cluster QoS signal

Admission runs through the port's shared core (``repro_torch.api``
admission + the policy registry).  ``EngineConfig.policy`` accepts the
enum (``AdmissionPolicy.RESERVE``/``FLEX``), its string values, any
registered policy name, or a policy object: RESERVE is ``least-fit``
(declared footprints must fit), FLEX is ``flex-f`` (``P * estimated
usage + reserved + r`` must fit).

Replicas map onto the simulator's :class:`NodeState` with two resources
normalized to capacity 1.0: axis 0 holds active slots /
``max_active_per_replica``, axis 1 KV tokens / ``kv_budget_tokens``.

Three admission execution modes, decision for decision identical:
``"eager"`` (one feasible/score/argmax per request through the policy's
hooks), ``"sequential"`` (``admit_queue``, one decision per queue entry)
and ``"wavefront"`` (``admit_queue(batch_mode=True)``: the batched top-K
``flex_score`` kernel on the card, its plain version on the CPU; the
default).  The node table is built on the host each round and lives on
the engine's ``device`` (default ``"cuda"``) for admission.

Straggler mitigation: a replica's load estimate is inflated by
``straggler_weight * max(ema / mean - 1, 0)`` capacity units, and a
replica ``drain_slowdown`` times slower than the mean is drained.  When a
replica's real usage overflows its budget, the newest admissions are
evicted and re-queued FIFO-stable ahead of fresh arrivals.

With ``EngineConfig(faults=...)`` replicas crash (their residents are
evicted and re-queued) and straggler storms slow their decode; with
``degrade=True`` a windowed QoS below the threshold defers sub-production
admissions (brownout).  With ``migration=...`` (which requires
``faults``) crashes are announced ``warn_slots`` steps ahead and the
drain pass moves residents to healthy replicas through the ``migrate``
policy, progress kept at a ``migrate_cost`` stall; an overflowing
replica tries migrate-then-shed before it evicts.  With ``guard=...``
the drift watchdog's breaker defers sub-production admissions while
OPEN (judged against estimates blended toward the declared footprints)
and lets a FIFO-head trickle through while HALF_OPEN.  The fault draws
are numpy's, as the reference's, so they are bit-identical.  The engine
runs the guard eagerly, as the reference's engine does: its trip
statistic, confidence and penalty scale round as eager JAX does
(``guard.watchdog``'s ``*_eager``), not as the simulator's jitted scan.

The estimator's noise comes from the port's noise source (the reference
folds its key with the step); the default ``current`` estimator draws
none.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api import admission
from repro_torch.api.policies import MigratePolicy
from repro_torch.api.protocols import (policy_prepare_params,
                                       policy_queue_order)
from repro_torch.api.registry import get_policy
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.penalty import update_penalty
from repro_torch.core.types import (CLASS_PRODUCTION, CPU, MEM,
                                    NUM_SRC_BUCKETS, ControllerState,
                                    FlexParams, NodeState)
from repro_torch.estimators import resolve_estimator
from repro_torch.guard import watchdog

# Engine resource axes on the shared (N, R) NodeState (see module doc).
SLOT_AXIS = CPU   # active-request slots, normalized by max_active_per_replica
KV_AXIS = MEM     # KV tokens, normalized by kv_budget_tokens

_DRAIN_LOAD = admission.DRAIN_LOAD

ADMISSION_MODES = ("eager", "sequential", "wavefront")

class AdmissionPolicy(enum.Enum):
    RESERVE = "reserve"   # request-based (baseline) -> registry "least-fit"
    FLEX = "flex"         # usage-based + penalty feedback -> "flex-f"


_ENUM_TO_REGISTRY = {
    AdmissionPolicy.RESERVE: "least-fit",
    AdmissionPolicy.FLEX: "flex-f",
}


def resolve_engine_policy(policy):
    """enum | str | policy object -> policy object, via the registry.

    Unknown names raise ``KeyError`` naming the registered policies.
    """
    if isinstance(policy, AdmissionPolicy):
        return get_policy(_ENUM_TO_REGISTRY[policy])
    if isinstance(policy, str):
        try:
            policy = AdmissionPolicy(policy)
        except ValueError:
            return get_policy(policy)    # KeyError on unknown names
        return get_policy(_ENUM_TO_REGISTRY[policy])
    return policy


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_tokens: int            # declared budget (the "request")
    true_tokens: int           # actual generation length (hidden "demand")
    src: int = 0               # client/tenant hash bucket (same-source rule)
    priority: int = 0          # CLASS_* (flex-priority headroom)
    generated: int = 0
    replica: int = -1
    evictions: int = 0
    done: bool = False
    stall: int = 0             # transfer-latency steps left after a live
                               # migration (no tokens generated while > 0)
    migrations: int = 0        # completed live migrations (progress kept)

    @property
    def declared_footprint(self) -> int:
        return self.prompt_len + self.max_tokens

    @property
    def current_footprint(self) -> int:
        return self.prompt_len + self.generated


@dataclasses.dataclass
class EngineConfig:
    n_replicas: int = 4
    kv_budget_tokens: int = 8192       # per-replica KV capacity
    policy: "AdmissionPolicy | str | object" = AdmissionPolicy.FLEX
    estimator: "str | object" = "current"  # repro_torch.estimators name
    max_active_per_replica: int = 64
    straggler_weight: float = 0.5      # load inflation per unit slowdown
    drain_slowdown: float = 3.0        # drain replicas this much slower
    qos_target: float = 0.99
    admission_mode: str = "wavefront"  # "eager" | "sequential" | "wavefront"
    admit_batch: int = 256             # requests per admission call; a
                                       # longer queue admits in chunks that
                                       # carry the reservation state
    wavefront_topk: int = 8            # cached candidates per task per sweep
    dedup_buckets: int = 64            # score-bucket dedup width; 0 = off
    wavefront_tie_margin: float = 1e-5  # conflict-check conservatism
    faults: "object | None" = None     # repro_torch.faults.FaultConfig:
                                       # crashes, storms and brownout
                                       # (``degrade=True``); None = the
                                       # fault-free engine
    migration: "object | None" = None  # repro_torch.migration
                                       # .MigrationConfig; requires faults
    guard: "object | None" = None      # repro_torch.guard.GuardConfig


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    admitted: int = 0
    finished: int = 0
    evicted_events: int = 0
    qos_series: List[float] = dataclasses.field(default_factory=list)
    penalty_series: List[float] = dataclasses.field(default_factory=list)
    util_series: List[float] = dataclasses.field(default_factory=list)
    tokens_generated: int = 0
    decisions: int = 0         # admission decisions evaluated (incl. blocked)
    admit_latency_s: List[float] = dataclasses.field(default_factory=list)
                               # wall seconds per admission pass
    fault_evictions: int = 0   # requests evicted by replica crashes
    brownout_steps: int = 0    # steps the brownout controller was engaged
    brownout_deferred: int = 0  # admission decisions deferred by brownout
    migrations: int = 0        # live migrations completed (progress kept)
    migration_failed: int = 0  # migration candidates that fell back to the
                               # evict-and-restart path
    guard_trips: int = 0       # breaker transitions into OPEN
    guard_open_steps: int = 0  # steps spent with the breaker OPEN
    guard_deferred: int = 0    # admission decisions deferred by the breaker


class ServeEngine:
    def __init__(self, cfg: EngineConfig,
                 decode_fn: Optional[Callable[[int, List[Request]], float]]
                 = None,
                 flex_params: Optional[FlexParams] = None,
                 seed: int = 0, *, device="cuda", noise=None):
        if cfg.admission_mode not in ADMISSION_MODES:
            raise ValueError(
                f"unknown admission_mode {cfg.admission_mode!r}; "
                f"one of {ADMISSION_MODES}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.policy = resolve_engine_policy(cfg.policy)
        self.decode_fn = decode_fn or self._stub_decode
        base = flex_params or FlexParams.default(
            qos_target=cfg.qos_target,
            theta=getattr(self.policy, "default_theta", 1.0),
            device=self.device)
        self.params = policy_prepare_params(self.policy, base)
        self.ctrl = ControllerState.init(self.params)
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, List[Request]] = {
            i: [] for i in range(cfg.n_replicas)}
        self.step_time_ema = np.ones(cfg.n_replicas)
        self.stats = EngineStats()
        self._ever_violated: set = set()
        # Fault injection: per-step draws from a dedicated numpy stream
        # (the reference's), so faults=None consumes no randomness.
        self._down_until = np.full(cfg.n_replicas, -1, np.int64)
        self._storm_slowdown = np.ones(cfg.n_replicas)
        self._storm_until = np.full(cfg.n_replicas, -1, np.int64)
        if cfg.faults is not None:
            self._fault_rng = np.random.default_rng((seed + 1) * 0x5EED)
        # Live migration: an announced crash's down window is
        # [_down_from, _down_until); residents re-place through the
        # ``migrate`` policy, keeping their progress.
        if cfg.migration is not None and cfg.faults is None:
            raise ValueError(
                "EngineConfig.migration requires EngineConfig.faults: the "
                "migration pass is driven by the crash announcements")
        self._down_from = np.full(cfg.n_replicas, -1, np.int64)
        self._mig_left = 0
        if cfg.migration is not None:
            self._migrate_fn = admission.make_queue_admitter(
                MigratePolicy(margin_scale=cfg.migration.margin_scale),
                self.params,
                batch_mode=cfg.admission_mode == "wavefront",
                topk=cfg.wavefront_topk,
                dedup_buckets=cfg.dedup_buckets,
                tie_margin=cfg.wavefront_tie_margin)
        # Load estimator (same registry as the simulator), refreshed once
        # per round from measured KV footprints; its noise, if any, comes
        # from ``noise.estimate(step, shape)``.
        self.noise = noise if noise is not None else GeneratorNoise(
            seed, device=self.device)
        self.estimator = resolve_estimator(cfg.estimator)
        self._est_state = self.estimator.init_state(cfg.n_replicas, 1,
                                                    device=self.device)
        self._usage_snap = np.zeros(cfg.n_replicas)
        self._declared_snap = np.zeros(cfg.n_replicas)
        # Estimator-drift guard: the watchdog run eagerly once per step on
        # the KV-footprint estimate; it draws no randomness.
        if cfg.guard is not None:
            self._g_win = watchdog.init_window(cfg.guard.window, 1,
                                               device=self.device)
            self._g_state = watchdog.CLOSED
            self._g_timer = 0
            self._g_err_q = 0.0
        self._admit_fn = admission.make_queue_admitter(
            self.policy, self.params,
            batch_mode=cfg.admission_mode == "wavefront",
            topk=cfg.wavefront_topk,
            dedup_buckets=cfg.dedup_buckets,
            tie_margin=cfg.wavefront_tie_margin)
        # driver hooks (real-model serving wires prefill/KV surgery here)
        self.on_admit: Optional[Callable[[Request], None]] = None
        self.on_evict: Optional[Callable[[Request], None]] = None

    # ---------------- replica state -> NodeState ----------------

    def _usage(self) -> np.ndarray:
        return np.array([sum(r.current_footprint for r in self.active[i])
                         for i in range(self.cfg.n_replicas)], float)

    def _declared(self) -> np.ndarray:
        return np.array([sum(r.declared_footprint for r in self.active[i])
                         for i in range(self.cfg.n_replicas)], float)

    def _straggler_extra(self) -> np.ndarray:
        """(N,) load inflation, in capacity units, from the step-time EMA.

        Down and announced replicas (faults) carry the drain load too, on
        both the estimate and the declared load, so every policy and mode
        rejects them as admission and migration targets.
        """
        cfg = self.cfg
        rel = self.step_time_ema / max(float(self.step_time_ema.mean()), 1e-9)
        extra = cfg.straggler_weight * np.maximum(rel - 1.0, 0.0)
        if cfg.drain_slowdown > 0:
            extra = np.where(rel >= cfg.drain_slowdown, _DRAIN_LOAD, extra)
        if cfg.faults is not None:
            extra = np.where(self._down_until > self.stats.steps,
                             _DRAIN_LOAD, extra)
        return extra.astype(np.float32)

    # ---------------- fault injection (repro_torch.faults) ----------------

    def _inject_faults(self):
        """Sample this step's replica crashes and straggler storms.

        Every step draws ``random(n)`` for crashes, then ``random(n)`` for
        storms, whatever the rates.  A crash evicts the replica's
        residents (with migration on, it is announced ``warn_slots``
        ahead and evicts what is still resident when it lands).  The
        burst's down window lasts ``crash_duration``, as the reference's.
        Stormed replicas report ``storm_slowdown`` times their step time,
        which the straggler mitigation sees through the EMA.
        """
        fc = self.cfg.faults
        t = self.stats.steps
        rng = self._fault_rng
        n = self.cfg.n_replicas
        up = self._down_until <= t
        crash = up & (rng.random(n) < fc.crash_rate)
        if fc.burst_slot >= 0 and t == fc.burst_slot:
            burst = np.zeros(n, bool)
            burst[:int(round(fc.burst_frac * n))] = True
            crash |= up & burst
        if self.cfg.migration is not None:
            warn = max(int(fc.warn_slots), 0)
            self._down_from = np.where(crash, t + warn, self._down_from)
            self._down_until = np.where(
                crash, t + warn + max(int(fc.crash_duration), 1),
                self._down_until)
            land = (self._down_from == t) & (self._down_until > t)
            evict_replicas = np.flatnonzero(land)
        else:
            self._down_until = np.where(
                crash, t + max(int(fc.crash_duration), 1), self._down_until)
            evict_replicas = np.flatnonzero(crash)
        for i in evict_replicas:
            victims = self.active[int(i)]
            self.active[int(i)] = []
            if self.cfg.migration is not None:
                # still resident at landing: the move failed into restart
                self.stats.migration_failed += len(victims)
            evicted = []
            for victim in reversed(victims):     # newest admission first
                victim.evictions += 1
                victim.replica = -1
                victim.generated = 0             # restart (no KV migration)
                victim.done = False
                self._ever_violated.add(victim.rid)
                self.stats.fault_evictions += 1
                if self.on_evict is not None:
                    self.on_evict(victim)
                evicted.append(victim)
            # extendleft reverses: victims return in admission order at
            # the head of the queue, ahead of fresh arrivals
            self.queue.extendleft(evicted)
        calm = self._storm_until <= t
        storm = calm & (rng.random(n) < fc.storm_rate)
        self._storm_until = np.where(
            storm, t + max(int(fc.storm_duration), 1), self._storm_until)
        self._storm_slowdown = np.where(
            self._storm_until > t, fc.storm_slowdown, 1.0)

    def _brownout_pressure(self) -> bool:
        """Windowed cluster QoS (float64, numpy) below the threshold?"""
        fc = self.cfg.faults
        if fc is None or not fc.degrade:
            return False
        window = self.stats.qos_series[-int(fc.qos_window):]
        if not window:
            return False
        thr = (fc.degrade_threshold if fc.degrade_threshold > 0
               else self.cfg.qos_target)
        return float(np.mean(window)) < thr

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def node_state(self) -> NodeState:
        """The replica table as the simulator's NodeState, from the
        round-start snapshots: requests admitted this round count only
        through the admission core's reservations."""
        cfg = self.cfg
        n = cfg.n_replicas
        kv_cap = float(cfg.kv_budget_tokens)
        slot_cap = float(cfg.max_active_per_replica)
        n_active = np.array([len(self.active[i]) for i in range(n)],
                            np.float32)
        s_extra = self._straggler_extra()

        est = np.zeros((n, 2), np.float32)
        est[:, KV_AXIS] = self._usage_snap / kv_cap + s_extra
        reserved = np.zeros((n, 2), np.float32)
        reserved[:, SLOT_AXIS] = n_active / slot_cap
        requested = np.zeros((n, 2), np.float32)
        requested[:, KV_AXIS] = self._declared_snap / kv_cap + s_extra
        src_count = np.zeros((n, NUM_SRC_BUCKETS), np.int32)
        for i in range(n):
            for r in self.active[i]:
                src_count[i, r.src % NUM_SRC_BUCKETS] += 1
        return NodeState(
            est_usage=self._tensor(est), reserved=self._tensor(reserved),
            requested=self._tensor(requested),
            n_tasks=self._tensor(n_active.astype(np.int32)),
            src_count=self._tensor(src_count))

    def _task_arrays(self, reqs: List[Request]):
        """(Q, 2) request vectors + (Q,) src/priority for the shared core."""
        cfg = self.cfg
        kv_cap = float(cfg.kv_budget_tokens)
        slot_cap = float(cfg.max_active_per_replica)
        q = len(reqs)
        r = np.zeros((q, 2), np.float32)
        r[:, KV_AXIS] = [req.declared_footprint / kv_cap for req in reqs]
        r[:, SLOT_AXIS] = 1.0 / slot_cap
        srcs = np.array([req.src % NUM_SRC_BUCKETS for req in reqs], np.int32)
        prios = np.array([req.priority for req in reqs], np.int32)
        return r, srcs, prios

    # ---------------- admission (the Flex core) ----------------

    def _guard_observe(self, measured: np.ndarray):
        """One watchdog step: last round's estimate against this round's
        measured usage, in KV-capacity units (float64 on the host, then
        float32), before the estimator refresh."""
        gcfg = self.cfg.guard
        kv_cap = float(self.cfg.kv_budget_tokens)
        prev = self._est_state.est[:, :1].cpu().numpy().astype(float) / kv_cap
        err = watchdog.drift_sample(
            self._tensor(prev.astype(np.float32)),
            self._tensor((measured[:, None] / kv_cap).astype(np.float32)))
        self._g_win = watchdog.push_errors(self._g_win, err)
        err_q = watchdog.trip_statistic_eager(self._g_win,
                                              gcfg.err_quantile)
        was_open = self._g_state == watchdog.OPEN
        s, t, _ = watchdog.breaker_step(
            torch.tensor(self._g_state, dtype=torch.int32,
                         device=self.device),
            torch.tensor(self._g_timer, dtype=torch.int32,
                         device=self.device), err_q, gcfg)
        self._g_state, self._g_timer = int(s), int(t)
        self._g_err_q = float(err_q)
        if self._g_state == watchdog.OPEN and not was_open:
            self.stats.guard_trips += 1
        if self._g_state == watchdog.OPEN:
            self.stats.guard_open_steps += 1

    def _guard_penalty(self) -> float:
        """The migrate pass's penalty, confidence-scaled while guarded."""
        pen = float(self.ctrl.penalty)
        if self.cfg.guard is not None:
            pen *= float(watchdog.penalty_scale_eager(self._g_err_q,
                                                      self.cfg.guard))
        return pen

    def refresh_snapshots(self):
        """Advance the estimator on measured usage; refresh round snapshots."""
        measured = self._usage()
        if self.cfg.guard is not None:
            self._guard_observe(measured)
        step = self.stats.steps
        self._est_state = self.estimator.refresh(
            self._est_state,
            self._tensor(measured[:, None].astype(np.float32)),
            lambda shape: self.noise.estimate(step, shape))
        self._usage_snap = (self._est_state.est[:, 0].cpu().numpy()
                            .astype(float))
        self._declared_snap = self._declared()
        if (self.cfg.guard is not None
                and self._g_state == watchdog.OPEN):
            # safe mode: the estimate blended toward the declared
            # footprints, in float64 as the reference's engine blends
            w = float(self.cfg.guard.open_blend)
            self._usage_snap = self._usage_snap + w * np.maximum(
                self._declared_snap - self._usage_snap, 0.0)

    def _admit_eager(self, node: NodeState, r: np.ndarray, srcs: np.ndarray,
                     prios: np.ndarray, order: np.ndarray,
                     penalty, valid: np.ndarray) -> np.ndarray:
        """Per-request reference loop: one feasible/score/argmax per task,
        through the same policy hooks and admit-one updates as the scan."""
        placements = np.full(len(r), -1, np.int32)
        pen = torch.tensor(penalty, dtype=torch.float32, device=self.device)
        for k in order:
            k = int(k)
            if not valid[k]:
                continue
            req = self._tensor(r[k])
            task = admission.TaskView(
                request=req,
                src=torch.tensor(int(srcs[k]), dtype=torch.int32,
                                 device=self.device),
                priority=torch.tensor(int(prios[k]), dtype=torch.int32,
                                      device=self.device))
            ctx = admission.PolicyContext(node=node, penalty=pen,
                                          params=self.params)
            feasible = self.policy.feasible(ctx, task)
            if not bool(feasible.any()):
                continue
            scores = admission.mask_infeasible(
                self.policy.score(ctx, task), feasible)
            i = int(torch.argmax(scores))
            placements[k] = i
            node.reserved[i] += req
            node.requested[i] += req
            node.n_tasks[i] += 1
            node.src_count[i, int(srcs[k])] += 1
        return placements

    def _admit_batched(self, node: NodeState, r: np.ndarray, srcs: np.ndarray,
                       prios: np.ndarray, order: np.ndarray,
                       penalty, valid_mask: np.ndarray) -> np.ndarray:
        """One ``admit_queue`` call per chunk of ``admit_batch`` requests;
        chunks carry the updated NodeState, so a long queue is admitted
        exactly as one pass would admit it."""
        q = len(r)
        w = int(self.cfg.admit_batch)
        placements = np.full(q, -1, np.int32)
        pen = torch.tensor(penalty, dtype=torch.float32, device=self.device)
        for lo in range(0, q, w):
            idx = order[lo:lo + w]
            node, pl = self._admit_fn(
                node, self._tensor(r[idx]), self._tensor(srcs[idx]),
                self._tensor(prios[idx]), self._tensor(valid_mask[idx]), pen)
            placements[idx] = pl.cpu().numpy()
        return placements

    def admit_pending(self) -> int:
        """Admit as many queued requests as fit this round (one pass).

        Applies the policy's ``queue_order`` hook, admits through the
        configured execution mode, and applies the placements: admitted
        requests join their replica in admission order; blocked requests
        stay queued in FIFO order.  Returns the number admitted.
        """
        if not self.queue:
            return 0
        reqs = list(self.queue)
        r, srcs, prios = self._task_arrays(reqs)
        valid = np.ones(len(reqs), bool)
        if self._brownout_pressure():
            # graceful degradation: defer CLASS_BATCH admissions (they
            # stay queued FIFO-stable), let production through
            valid &= prios >= CLASS_PRODUCTION
            self.stats.brownout_steps += 1
            self.stats.brownout_deferred += int((~valid).sum())
        if self.cfg.guard is not None and self._g_state != watchdog.CLOSED:
            # circuit breaker: OPEN defers sub-production admissions;
            # HALF_OPEN lets a FIFO-head trickle of them through
            before = valid.copy()
            allow = prios >= CLASS_PRODUCTION
            if self._g_state == watchdog.HALF_OPEN:
                trickle = np.zeros(len(reqs), bool)
                trickle[:int(self.cfg.guard.probe_reclaim)] = True
                allow = allow | trickle
            valid &= allow
            self.stats.guard_deferred += int((before & ~valid).sum())
        order = np.arange(len(reqs))
        hook = policy_queue_order(self.policy)
        if hook is not None:
            order = hook(self._tensor(r), self._tensor(prios),
                         self._tensor(valid)).cpu().numpy()
        node = self.node_state()
        penalty = float(self.ctrl.penalty)

        t0 = time.perf_counter()
        if self.cfg.admission_mode == "eager":
            placements = self._admit_eager(node, r, srcs, prios, order,
                                           penalty, valid)
        else:
            placements = self._admit_batched(node, r, srcs, prios, order,
                                             penalty, valid)
        self.stats.admit_latency_s.append(time.perf_counter() - t0)
        self.stats.decisions += int(valid.sum())

        admitted = 0
        for k in order:
            i = int(placements[k])
            if i < 0:
                continue
            req = reqs[int(k)]
            req.replica = i
            self.active[i].append(req)
            self.stats.admitted += 1
            admitted += 1
            if self.on_admit is not None:
                self.on_admit(req)
        self.queue = deque(req for req in reqs if req.replica < 0)
        return admitted

    # ---------------- live migration (repro_torch.migration) ----------------

    def _in_flight(self) -> int:
        """Requests still paying their transfer-latency stall."""
        return sum(1 for rs in self.active.values()
                   for r in rs if r.stall > 0)

    def _try_migrate(self, cands: List[Request],
                     extra_off: "np.ndarray | None" = None) -> List[Request]:
        """Re-place candidates through one ``migrate``-policy admitter
        call, bounded by the step's bandwidth and the in-flight pool.

        A moved request keeps ``generated`` and pays ``migrate_cost``
        stalled steps; its footprints move between the round snapshots.
        ``extra_off`` adds per-replica offsets to the reserved rows
        (``admission.mask_unavailable``; the overflow path excludes its
        source so).  The backend is not told: as in the reference, no
        hook runs.  Returns the requests that moved.
        """
        mig = self.cfg.migration
        room = int(mig.pool_size) - self._in_flight()
        take = cands[:max(min(self._mig_left, room,
                              int(self.cfg.admit_batch)), 0)]
        if not take:
            return []
        r, srcs, prios = self._task_arrays(take)
        node = self.node_state()
        if extra_off is not None:
            node = admission.mask_unavailable(node, self._tensor(extra_off))
        pen = torch.tensor(self._guard_penalty(), dtype=torch.float32,
                           device=self.device)
        _, pl = self._migrate_fn(
            node, self._tensor(r), self._tensor(srcs), self._tensor(prios),
            self._tensor(np.ones(len(take), bool)), pen)
        pl = pl.cpu().numpy()
        moved = []
        for k, req in enumerate(take):
            tgt = int(pl[k])
            if tgt < 0:
                continue
            src_rep = req.replica
            self.active[src_rep].remove(req)
            self.active[tgt].append(req)
            req.replica = tgt
            req.stall = int(mig.migrate_cost)
            req.migrations += 1
            self._usage_snap[src_rep] -= req.current_footprint
            self._usage_snap[tgt] += req.current_footprint
            self._declared_snap[src_rep] -= req.declared_footprint
            self._declared_snap[tgt] += req.declared_footprint
            self.stats.migrations += 1
            self._mig_left -= 1
            moved.append(req)
        return moved

    def _migrate_draining(self):
        """Drain pass: move the residents of announced-crash replicas,
        oldest first (they carry the drain load already, so they are no
        targets)."""
        t = self.stats.steps
        draining = np.flatnonzero((self._down_from > t)
                                  & (self._down_until > t))
        cands = [r for i in draining
                 for r in self.active[int(i)] if r.stall == 0]
        if cands:
            self._try_migrate(cands)

    # ---------------- decode + overflow handling ----------------

    def _stub_decode(self, replica: int, reqs: List[Request]) -> float:
        """Stand-in decode: advances counters; returns simulated step time."""
        return 1.0 + 0.05 * len(reqs)

    def _step_replica(self, i: int):
        reqs = self.active[i]
        if not reqs:
            return
        dt = self.decode_fn(i, reqs)
        if self.cfg.faults is not None:
            dt *= float(self._storm_slowdown[i])   # a straggler storm
        self.step_time_ema[i] = 0.8 * self.step_time_ema[i] + 0.2 * dt
        for r in reqs:
            if r.stall > 0:
                r.stall -= 1          # transfer latency: no token this step
                continue
            if not r.done:
                r.generated += 1
                self.stats.tokens_generated += 1
                if r.generated >= r.true_tokens:
                    r.done = True
        # overflow: real usage exceeded the budget -> evict newest first
        usage = sum(r.current_footprint for r in reqs)
        cap = self.cfg.kv_budget_tokens
        if usage > cap and self.cfg.migration is not None:
            # migrate-then-shed: move the newest admissions off first;
            # only what cannot move is evicted below
            cands, freed = [], 0.0
            for r2 in reversed(reqs):
                if r2.stall > 0:
                    continue
                cands.append(r2)
                freed += r2.current_footprint
                if usage - freed <= cap:
                    break
            off = np.zeros(self.cfg.n_replicas, np.float32)
            off[i] = _DRAIN_LOAD           # the source is never a target
            moved = self._try_migrate(cands, extra_off=off)
            self.stats.migration_failed += len(cands) - len(moved)
            usage = sum(r.current_footprint for r in reqs)
        evicted = []
        while usage > cap and reqs:
            victim = reqs.pop()           # LIFO: newest admission pays
            usage -= victim.current_footprint
            victim.evictions += 1
            victim.replica = -1
            victim.generated = 0          # restart (no KV migration)
            victim.done = False
            self._ever_violated.add(victim.rid)
            self.stats.evicted_events += 1
            if self.on_evict is not None:
                self.on_evict(victim)
            evicted.append(victim)
        # Re-queue FIFO-stable: victims were popped newest-first, so
        # extendleft (which reverses) restores their admission order at
        # the head of the queue, ahead of fresh arrivals.
        self.queue.extendleft(evicted)
        done = [r for r in reqs if r.done]
        self.active[i] = [r for r in reqs if not r.done]
        self.stats.finished += len(done)

    # ---------------- main loop ----------------

    def submit(self, req: Request):
        self.queue.append(req)

    def step(self):
        cfg = self.cfg
        if cfg.faults is not None:
            self._inject_faults()
        self.refresh_snapshots()
        if cfg.migration is not None:
            self._mig_left = int(cfg.migration.bandwidth)
            self._migrate_draining()
        self.admit_pending()

        for i in range(cfg.n_replicas):
            self._step_replica(i)

        # cluster QoS: active+finished requests that were never evicted
        n_seen = max(self.stats.admitted, 1)
        q = 1.0 - len(self._ever_violated) / n_seen
        self.ctrl = update_penalty(self.ctrl, q, self.params)
        self.stats.qos_series.append(float(q))
        self.stats.penalty_series.append(float(self.ctrl.penalty))
        self.stats.util_series.append(
            float(self._usage().sum())
            / (cfg.n_replicas * cfg.kv_budget_tokens))
        self.stats.steps += 1

    def run(self, steps: int):
        for _ in range(steps):
            self.step()
        return self.stats
