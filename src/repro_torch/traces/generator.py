"""Google-cluster-trace statistical twin (paper §2.2, §5.1).

Port of ``repro.traces.generator``.  Generation is host-side numpy with
the reference's draws in the reference's order, so an equal seed gives a
bit-identical :class:`TaskSet`; only the final hand-over makes tensors.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from repro_torch.core.types import NUM_RESOURCES, NUM_SRC_BUCKETS, TaskSet


class ClassStats(NamedTuple):
    frac: float
    req_mean: float
    req_sigma: float
    use_ratio_cpu: float
    use_ratio_mem: float
    cv_cpu: float
    cv_mem: float
    peak_ratio_cpu: float
    peak_ratio_mem: float
    dur_mean: float
    ar_rho: float


class TraceParams(NamedTuple):
    batch: ClassStats = ClassStats(0.75, 0.08, 0.9, 0.55, 0.50, 0.60, 0.25,
                                   2.00, 1.20, 4.0, 0.80)
    production: ClassStats = ClassStats(0.20, 0.30, 0.7, 0.45, 0.50, 0.20,
                                        0.10, 1.00, 1.00, 48.0, 0.97)
    system: ClassStats = ClassStats(0.05, 0.05, 0.8, 0.40, 0.45, 0.80, 0.30,
                                    3.00, 1.50, 96.0, 0.90)
    diurnal_amp: float = 0.3
    zipf_a: float = 1.4

    def classes(self):
        return [self.batch, self.production, self.system]


def _expected_request_slots(p: TraceParams) -> float:
    """E[request * duration] per task (for offered-load calibration)."""
    e = 0.0
    for c in p.classes():
        req = c.req_mean * np.exp(c.req_sigma ** 2 / 2.0)
        e += c.frac * req * c.dur_mean
    return e


def n_tasks_for_offered_load(n_nodes: int, n_slots: int,
                             offered_load: float = 1.0,
                             params: TraceParams = TraceParams()) -> int:
    """Task count so that mean admitted request ~= offered_load * capacity."""
    per_task = _expected_request_slots(params)
    return int(round(offered_load * n_nodes * n_slots / per_task))


def _generate_arrays(seed: int, n_tasks: int, n_slots: int,
                     params: TraceParams) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)

    fracs = np.array([c.frac for c in params.classes()])
    fracs = fracs / fracs.sum()
    prio = rng.choice(len(fracs), size=n_tasks, p=fracs).astype(np.int32)

    request = np.zeros((n_tasks, NUM_RESOURCES), np.float32)
    mean_usage = np.zeros_like(request)
    std_usage = np.zeros_like(request)
    peak_usage = np.zeros_like(request)
    duration = np.zeros(n_tasks, np.int32)
    ar_rho = np.zeros(n_tasks, np.float32)

    for cls_id, c in enumerate(params.classes()):
        m = prio == cls_id
        n = int(m.sum())
        if n == 0:
            continue
        req = np.exp(rng.normal(np.log(c.req_mean), c.req_sigma, (n, 2)))
        req = np.clip(req, 0.005, 0.5).astype(np.float32)
        request[m] = req

        ratio = np.stack([
            np.clip(rng.normal(c.use_ratio_cpu, 0.15 * c.use_ratio_cpu, n),
                    0.05, 1.5),
            np.clip(rng.normal(c.use_ratio_mem, 0.15 * c.use_ratio_mem, n),
                    0.05, 1.2),
        ], axis=1).astype(np.float32)
        mean_usage[m] = req * ratio
        cv = np.array([c.cv_cpu, c.cv_mem], np.float32)
        std_usage[m] = mean_usage[m] * cv
        peak = np.array([c.peak_ratio_cpu, c.peak_ratio_mem], np.float32)
        peak_usage[m] = np.minimum(req * peak, 1.0)

        duration[m] = np.clip(rng.geometric(1.0 / c.dur_mean, n), 1,
                              max(2, n_slots)).astype(np.int32)
        ar_rho[m] = c.ar_rho

    t = np.arange(n_slots)
    rate = 1.0 + params.diurnal_amp * np.sin(2 * np.pi * t / max(n_slots, 1))
    rate = rate / rate.sum()
    arrival = rng.choice(n_slots, size=n_tasks, p=rate).astype(np.int32)

    src = (rng.zipf(params.zipf_a, n_tasks) % NUM_SRC_BUCKETS).astype(np.int32)

    return dict(arrival=arrival, duration=duration, request=request,
                mean_usage=mean_usage, std_usage=std_usage,
                peak_usage=peak_usage, ar_rho=ar_rho, priority=prio, src=src)


def generate_taskset(seed: int, n_tasks: int, n_slots: int,
                     params: TraceParams = TraceParams(), *,
                     device="cuda") -> TaskSet:
    from repro_torch.convert import taskset_from_numpy

    return taskset_from_numpy(
        _generate_arrays(seed, n_tasks, n_slots, params), device=device)


def generate_calibrated(seed: int, n_nodes: int, n_slots: int,
                        offered_load: float = 1.0,
                        params: TraceParams = TraceParams(), *,
                        device="cuda") -> TaskSet:
    """Two-pass generation hitting a realized offered load.

    The analytic count ignores horizon truncation, so generate once,
    measure the realized request-slot mass, and regenerate with a
    corrected task count.
    """
    n0 = n_tasks_for_offered_load(n_nodes, n_slots, offered_load, params)
    a = _generate_arrays(seed, n0, n_slots, params)
    eff_dur = np.minimum(a["duration"], n_slots - a["arrival"])
    realized = float(
        (a["request"].mean(axis=1) * eff_dur).sum()) / (n_nodes * n_slots)
    n1 = max(1, int(round(n0 * offered_load / max(realized, 1e-6))))
    return generate_taskset(seed, n1, n_slots, params, device=device)
