"""Core types of the Flex resource manager, as NamedTuples of torch tensors.

Mirrors ``repro.core.types``: every resource quantity is normalized to one
node's capacity (C = 1.0 per resource), resources are indexed [CPU, MEM]
(R = 2), and every function is generic over the trailing resource axis.
Dtypes are pinned to the reference's: float32 for quantities, int32 for
indices and counts.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

# Resource axis indices.
CPU = 0
MEM = 1
NUM_RESOURCES = 2

# Priority classes (the Google-trace classification of the paper, §2.2).
CLASS_BATCH = 0
CLASS_PRODUCTION = 1
CLASS_SYSTEM = 2
NUM_CLASSES = 3

# Hash buckets for task sources (users/jobs); Flex scoring spreads tasks of
# one source across nodes (§4.3).
NUM_SRC_BUCKETS = 64

F32 = torch.float32
I32 = torch.int32


class SchedulerKind(enum.IntEnum):
    """The paper's four placement policies (legacy names of the registry)."""

    LEAST_FIT = 0
    OVERSUB = 1
    FLEX_F = 2
    FLEX_L = 3


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


class FlexParams(NamedTuple):
    """Static algorithm parameters (Table 1 + §5.1 defaults), 0-d f32."""

    qos_target: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    p_init: torch.Tensor
    p_min: torch.Tensor
    p_max: torch.Tensor
    theta: torch.Tensor
    w_load: torch.Tensor
    w_src: torch.Tensor

    @staticmethod
    def default(qos_target: float = 0.99, alpha: float = 0.99,
                beta: float = 1.0, p_init: float = 1.5, p_min: float = 1.0,
                p_max: float = 16.0, theta: float = 1.0, w_load: float = 1.0,
                w_src: float = 0.25, *, device="cuda") -> "FlexParams":
        return FlexParams(*(_scalar(v, device) for v in (
            qos_target, alpha, beta, p_init, p_min, p_max, theta, w_load,
            w_src)))


class NodeState(NamedTuple):
    """Per-node cluster state (every leaf leads with N = number of nodes)."""

    est_usage: torch.Tensor  # (N, R) f32 load estimate L-hat
    reserved: torch.Tensor   # (N, R) f32 requests reserved this round
    requested: torch.Tensor  # (N, R) f32 requests of running tasks
    n_tasks: torch.Tensor    # (N,) i32 running task count
    src_count: torch.Tensor  # (N, NUM_SRC_BUCKETS) i32 tasks per source

    @staticmethod
    def zeros(n_nodes: int, *, device="cuda") -> "NodeState":
        z = lambda *shape, dtype=F32: torch.zeros(shape, dtype=dtype,
                                                  device=device)
        return NodeState(
            est_usage=z(n_nodes, NUM_RESOURCES),
            reserved=z(n_nodes, NUM_RESOURCES),
            requested=z(n_nodes, NUM_RESOURCES),
            n_tasks=z(n_nodes, dtype=I32),
            src_count=z(n_nodes, NUM_SRC_BUCKETS, dtype=I32),
        )


class ControllerState(NamedTuple):
    """State of the estimation-penalty controller (Alg. 3)."""

    penalty: torch.Tensor   # () f32 current P
    prev_qos: torch.Tensor  # () f32 Q(t-1)

    @staticmethod
    def init(params: FlexParams) -> "ControllerState":
        return ControllerState(penalty=params.p_init.clone(),
                               prev_qos=torch.ones_like(params.p_init))


class TaskSet(NamedTuple):
    """A workload trace: struct-of-arrays over T tasks."""

    arrival: torch.Tensor     # (T,) i32 arrival slot
    duration: torch.Tensor    # (T,) i32 lifetime in slots (>= 1)
    request: torch.Tensor     # (T, R) f32 requested resources
    mean_usage: torch.Tensor  # (T, R) f32 mean of the demand process
    std_usage: torch.Tensor   # (T, R) f32 std of the demand process
    peak_usage: torch.Tensor  # (T, R) f32 clip ceiling of demand
    ar_rho: torch.Tensor      # (T,) f32 AR(1) correlation of demand
    priority: torch.Tensor    # (T,) i32 CLASS_*
    src: torch.Tensor         # (T,) i32 source bucket

    @property
    def num_tasks(self) -> int:
        return self.arrival.shape[0]

    def to(self, device) -> "TaskSet":
        return TaskSet(*(x.to(device) for x in self))


class SimConfig(NamedTuple):
    """Static simulation configuration (§5.1).

    Field names and defaults are those of ``repro.core.types.SimConfig``.
    This port runs the sequential and wavefront admission paths; the
    simulator raises ``NotImplementedError`` for the features later slices
    bring (faults, migration, guard, reclamation, retry backoff and
    jitter).  ``kernel_interpret`` has no counterpart: the port has no
    kernel interpreter, and a run on CPU tensors takes each kernel's plain
    PyTorch version.
    """

    n_nodes: int = 4000
    n_slots: int = 288
    arrivals_per_slot: int = 4096
    retry_capacity: int = 1024
    wfs_iters: int = 4
    demand_scale: float = 1.0
    record_node_usage: bool = False
    use_kernel: bool = False
    kernel_interpret: bool = False
    admission_mode: str = "sequential"
    max_retries: int = 16
    wavefront_topk: int = 8
    dedup_buckets: int = 64
    wavefront_tie_margin: float = 1e-5
    estimator: str = ""
    reclamation: bool = False
    reclaim_margin: float = 0.1
    reclaim_pool: int = 256
    retry_backoff: int = 0
    retry_backoff_cap: int = 64
    retry_jitter: int = 0
    faults: "object | None" = None
    migration: "object | None" = None
    guard: "object | None" = None


class SlotMetrics(NamedTuple):
    """Per-slot time series emitted by the simulator (leading axis S)."""

    usage: torch.Tensor              # (S, R)
    requested: torch.Tensor          # (S, R)
    qos: torch.Tensor                # (S,)
    penalty: torch.Tensor            # (S,)
    usage_std: torch.Tensor          # (S, R)
    usage_mean: torch.Tensor         # (S, R)
    n_running: torch.Tensor          # (S,)
    n_rejected: torch.Tensor         # (S,) cumulative
    node_usage: torch.Tensor         # (S, N, R), or (S, 0, R) unless recorded
    est_usage: torch.Tensor          # (S, R)
    node_est: torch.Tensor           # (S, N, R), or (S, 0, R)
    node_requested: torch.Tensor     # (S, N, R), or (S, 0, R)
    n_reclaimed: torch.Tensor        # (S,)
    n_fault_evicted: torch.Tensor    # (S,)
    n_degrade_evicted: torch.Tensor  # (S,)
    degraded: torch.Tensor           # (S,)
    n_migrated: torch.Tensor         # (S,)
    n_migration_failed: torch.Tensor  # (S,)
    guard_tripped: torch.Tensor      # (S, 0) without a guard
    n_guard_deferred: torch.Tensor   # (S, 0) without a guard
    guard_err_q: torch.Tensor        # (S, 0) without a guard


class SimResult(NamedTuple):
    metrics: SlotMetrics
    placement: torch.Tensor     # (T,) i32 node index or -1
    admit_slot: torch.Tensor    # (T,) i32 admission slot or -1
    qos_ok_slots: torch.Tensor  # (T,) i32 slots the task met its QoS
    active_slots: torch.Tensor  # (T,) i32 slots the task was running
