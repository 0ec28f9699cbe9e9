"""Summaries of a simulation (port of ``repro.traces.analysis.summarize``).

Each function returns plain Python numbers.  ``summarize`` returns the
reference's keys and values and warns where the reference warns: when
the per-node series were not recorded, and when the run was unguarded.
Under a crash the ``requested`` series, and with it ``avg_request_cpu``
and ``avg_request_mem``, is the port's repaired sum, not the reference's
(the metrics of ``core.simulator.simulate_runs``).
"""
from __future__ import annotations

import warnings
from typing import Dict

import torch

from repro_torch.core.numerics import fma
from repro_torch.core.qos import recovery_slots
from repro_torch.core.types import SimResult, TaskSet

_CLASS_NAMES = {0: "batch", 1: "production", 2: "system"}
_NEEDS_NODE_SERIES = (
    "needs the per-node series (SlotMetrics.{field} is empty); run the "
    "simulation with SimConfig(record_node_usage=True)")


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of a flat f32 tensor, with the
    reference's float32 arithmetic."""
    a = torch.sort(x.reshape(-1).float()).values
    n = float(a.numel())
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    lo = int(min(max(low.item(), 0.0), n - 1.0))
    hi = int(min(max(high.item(), 0.0), n - 1.0))
    return fma(a[lo], low_w.to(a.device), a[hi] * high_w.to(a.device))


def cdf(x: torch.Tensor, qs=(0.1, 0.25, 0.5, 0.75, 0.9, 0.99)
        ) -> Dict[str, float]:
    return {f"p{int(q * 100)}": float(_quantile(x, q)) for q in qs}


def _mean(x: torch.Tensor) -> float:
    return float(x.float().mean())


def cluster_level(result: SimResult) -> Dict[str, float]:
    """Fig. 1: total usage / total request vs. cluster capacity."""
    m = result.metrics
    return {
        "avg_usage_cpu": _mean(m.usage[:, 0]),
        "avg_usage_mem": _mean(m.usage[:, 1]),
        "avg_request_cpu": _mean(m.requested[:, 0]),
        "avg_request_mem": _mean(m.requested[:, 1]),
    }


def machine_level(result: SimResult) -> Dict[str, float]:
    """Fig. 2/3: distribution of per-node usage over (node, slot) samples."""
    u = result.metrics.node_usage
    if u.numel() == 0:
        raise ValueError(
            "machine_level " + _NEEDS_NODE_SERIES.format(field="node_usage"))
    out = {}
    for r, name in ((0, "cpu"), (1, "mem")):
        ratios = u[..., r]
        out.update({f"usage_to_cap_{name}_{k}": v
                    for k, v in cdf(ratios).items()})
        out[f"frac_idle_{name}"] = _mean(ratios < 0.01)
        out[f"frac_below_half_{name}"] = _mean(ratios < 0.5)
    return out


def task_level(ts: TaskSet) -> Dict[str, float]:
    """Fig. 4/5: usage-vs-request statistics, overall and per class."""
    out = {}
    mean_ratio = ts.mean_usage / torch.clamp(ts.request, min=1e-6)
    peak_ratio = ts.peak_usage / torch.clamp(ts.request, min=1e-6)
    std_over_mean = ts.std_usage / torch.clamp(ts.mean_usage, min=1e-6)
    for r, name in ((0, "cpu"), (1, "mem")):
        out[f"mean_usage_over_request_{name}"] = _mean(mean_ratio[:, r])
        out[f"peak_usage_over_request_{name}"] = _mean(peak_ratio[:, r])
        out[f"std_over_mean_{name}"] = _mean(std_over_mean[:, r])
        for cls in (0, 1, 2):
            m = ts.priority == cls
            denom = max(int(m.sum()), 1)
            out[f"{_CLASS_NAMES[cls]}_mean_ratio_{name}"] = float(
                torch.where(m, mean_ratio[:, r], 0.0).sum() / denom)
            out[f"{_CLASS_NAMES[cls]}_peak_ratio_{name}"] = float(
                torch.where(m, peak_ratio[:, r], 0.0).sum() / denom)
    return out


def load_balance(result: SimResult) -> Dict[str, float]:
    """Fig. 9: normalized std of per-node usage over time."""
    m = result.metrics
    norm_std = m.usage_std / torch.clamp(m.usage_mean, min=1e-6)
    return {
        "mean_norm_std_cpu": _mean(norm_std[:, 0]),
        "mean_norm_std_mem": _mean(norm_std[:, 1]),
    }


def estimator_error(result: SimResult) -> Dict[str, float]:
    """One-slot-ahead estimate error: est[t] against usage[t+1]."""
    est = result.metrics.node_est
    usage = result.metrics.node_usage
    if est.numel() == 0 or usage.numel() == 0:
        raise ValueError(
            "estimator_error " + _NEEDS_NODE_SERIES.format(field="node_est"))
    err = est[..., :-1, :, :] - usage[..., 1:, :, :]
    out = {}
    for r, name in ((0, "cpu"), (1, "mem")):
        e = err[..., r]
        out.update({f"est_abs_err_{name}_{k}": v
                    for k, v in cdf(e.abs()).items()})
        out[f"est_bias_{name}"] = _mean(e)
        out[f"est_under_frac_{name}"] = _mean(e < 0.0)
    return out


def overprovisioning(result: SimResult) -> Dict[str, float]:
    """Requested minus realized usage per (node, slot)."""
    req = result.metrics.node_requested
    usage = result.metrics.node_usage
    if req.numel() == 0 or usage.numel() == 0:
        raise ValueError(
            "overprovisioning "
            + _NEEDS_NODE_SERIES.format(field="node_requested"))
    gap = req - usage
    out = {}
    for r, name in ((0, "cpu"), (1, "mem")):
        out.update({f"overprov_{name}_{k}": v
                    for k, v in cdf(gap[..., r]).items()})
        out[f"mean_overprov_{name}"] = _mean(gap[..., r])
    return out


def zombie_nodes(result: SimResult, req_floor: float = 0.05,
                 usage_eps: float = 0.01) -> Dict[str, float]:
    """Share of (node, slot) samples holding requests while nearly idle."""
    req = result.metrics.node_requested
    usage = result.metrics.node_usage
    if req.numel() == 0 or usage.numel() == 0:
        raise ValueError(
            "zombie_nodes " + _NEEDS_NODE_SERIES.format(field="node_requested"))
    out = {}
    for r, name in ((0, "cpu"), (1, "mem")):
        zombie = (req[..., r] > req_floor) & (usage[..., r] < usage_eps)
        out[f"zombie_frac_{name}"] = _mean(zombie)
    return out


def fault_recovery(result: SimResult, qos_target: float,
                   consecutive: int = 3) -> Dict[str, float]:
    """Time to recover from a QoS dip, evictions by cause, retained work."""
    m = result.metrics
    return {
        "recovery_slots": int(recovery_slots(m.qos, qos_target,
                                             consecutive=consecutive)),
        "n_fault_evicted": int(m.n_fault_evicted[-1]),
        "n_degrade_evicted": int(m.n_degrade_evicted[-1]),
        "degraded_frac": _mean(m.degraded),
        "retained_task_slots": int(m.n_running.sum()),
        "qos_min": float(m.qos.min()),
        "n_migrated": int(m.n_migrated[-1]),
        "n_migration_failed": int(m.n_migration_failed[-1]),
    }


def guard_report(result: SimResult) -> Dict[str, float]:
    """Drift-watchdog summary of a guarded run: breaker trips (transitions
    into OPEN), the share of slots OPEN and HALF_OPEN, the reclaim
    candidates held back, and the trip statistic's maximum and mean.
    Raises ValueError on an unguarded run (its guard series are empty)."""
    m = result.metrics
    if m.guard_tripped.numel() == 0:
        raise ValueError(
            "guard_report needs the drift-watchdog series "
            "(SlotMetrics.guard_tripped is empty); run the simulation "
            "with SimConfig(guard=GuardConfig(...))")
    state = m.guard_tripped
    opened = state == 1
    prev = torch.cat([torch.zeros_like(opened[..., :1]), opened[..., :-1]],
                     dim=-1)
    return {
        "guard_trips": int((opened & ~prev).sum()),
        "open_frac": _mean(opened),
        "half_open_frac": _mean(state == 2),
        "n_guard_deferred": int(m.n_guard_deferred[..., -1].max()),
        "err_q_max": float(m.guard_err_q.max()),
        "err_q_mean": _mean(m.guard_err_q),
    }


def summarize(ts: TaskSet, result: SimResult,
              qos_target: float) -> Dict[str, float]:
    """Utilization, QoS and admission summary of one run."""
    m = result.metrics
    admitted = result.placement >= 0
    out = {
        **cluster_level(result),
        **load_balance(result),
        "qos_mean": _mean(m.qos),
        "qos_violation_frac": _mean(m.qos < qos_target),
        "admitted_frac": _mean(admitted),
        "n_admitted": int(admitted.sum()),
        "n_rejected": int(m.n_rejected[-1]),
        "n_reclaimed": int(m.n_reclaimed[-1]),
        "final_penalty": float(m.penalty[-1]),
        **fault_recovery(result, qos_target),
    }
    if m.node_usage.numel():
        out.update(machine_level(result))
        out.update(estimator_error(result))
        out.update(overprovisioning(result))
        out.update(zombie_nodes(result))
    else:
        warnings.warn(
            "summarize: skipping machine-level keys (machine_level, "
            "estimator_error, overprovisioning, zombie_nodes) — per-node "
            "series were not recorded; pass "
            "SimConfig(record_node_usage=True) to include them",
            stacklevel=2)
    if m.guard_tripped.numel():
        out.update(guard_report(result))
    else:
        warnings.warn(
            "summarize: skipping guard keys (guard_report) — the run was "
            "unguarded; pass SimConfig(guard=GuardConfig(...)) to include "
            "them",
            stacklevel=2)
    return out
