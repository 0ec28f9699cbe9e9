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

The estimator's noise comes from the port's noise source (the reference
folds its key with the step); the default ``current`` estimator draws
none.  Faults, migration and the guard are later slices and raise.
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
from repro_torch.api.protocols import (policy_prepare_params,
                                       policy_queue_order)
from repro_torch.api.registry import get_policy
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.penalty import update_penalty
from repro_torch.core.types import (CPU, MEM, NUM_SRC_BUCKETS,
                                    ControllerState, FlexParams, NodeState)
from repro_torch.estimators import resolve_estimator

# Engine resource axes on the shared (N, R) NodeState (see module doc).
SLOT_AXIS = CPU   # active-request slots, normalized by max_active_per_replica
KV_AXIS = MEM     # KV tokens, normalized by kv_budget_tokens

_DRAIN_LOAD = admission.DRAIN_LOAD

ADMISSION_MODES = ("eager", "sequential", "wavefront")

_LATER = {name: "ROADMAP queue 1 item 6 (the engine's faults, migration "
                "and guard)" for name in ("faults", "migration", "guard")}


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
    faults: "object | None" = None     # later slices: must stay None
    migration: "object | None" = None
    guard: "object | None" = None


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
        for name, later in _LATER.items():
            if getattr(cfg, name) is not None:
                raise NotImplementedError(
                    f"EngineConfig.{name} is not ported yet; {later} "
                    f"brings it")
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
        """(N,) load inflation, in capacity units, from the step-time EMA."""
        cfg = self.cfg
        rel = self.step_time_ema / max(float(self.step_time_ema.mean()), 1e-9)
        extra = cfg.straggler_weight * np.maximum(rel - 1.0, 0.0)
        if cfg.drain_slowdown > 0:
            extra = np.where(rel >= cfg.drain_slowdown, _DRAIN_LOAD, extra)
        return extra.astype(np.float32)

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

    def refresh_snapshots(self):
        """Advance the estimator on measured usage; refresh round snapshots."""
        measured = self._usage()
        step = self.stats.steps
        self._est_state = self.estimator.refresh(
            self._est_state,
            self._tensor(measured[:, None].astype(np.float32)),
            lambda shape: self.noise.estimate(step, shape))
        self._usage_snap = (self._est_state.est[:, 0].cpu().numpy()
                            .astype(float))
        self._declared_snap = self._declared()

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

    # ---------------- decode + overflow handling ----------------

    def _stub_decode(self, replica: int, reqs: List[Request]) -> float:
        """Stand-in decode: advances counters; returns simulated step time."""
        return 1.0 + 0.05 * len(reqs)

    def _step_replica(self, i: int):
        reqs = self.active[i]
        if not reqs:
            return
        dt = self.decode_fn(i, reqs)
        self.step_time_ema[i] = 0.8 * self.step_time_ema[i] + 0.2 * dt
        for r in reqs:
            if not r.done:
                r.generated += 1
                self.stats.tokens_generated += 1
                if r.generated >= r.true_tokens:
                    r.done = True
        # overflow: real usage exceeded the budget -> evict newest first
        usage = sum(r.current_footprint for r in reqs)
        cap = self.cfg.kv_budget_tokens
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
        self.refresh_snapshots()
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
