"""Quality of service (paper §3 eq. 14 and §5.1), port of ``repro.core.qos``.

q_j(t) = 1 iff the task got at least min(demand, request) on every
resource; cluster QoS Q(t) is the fraction of active tasks with q_j = 1.
"""
from __future__ import annotations

import torch

_EPS = 1e-6


def task_qos(alloc: torch.Tensor, demand: torch.Tensor,
             request: torch.Tensor) -> torch.Tensor:
    """(T,) bool from (T, R) inputs."""
    need = torch.minimum(demand, request)
    return (alloc + _EPS >= need).all(dim=-1)


def cluster_qos(q: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Q(t): mean of q over active tasks, 1.0 when none is active (() f32;
    (B,) for (B, T) inputs, each run's own)."""
    n = active.sum(dim=-1, dtype=torch.int32)
    ok = (q & active).sum(dim=-1, dtype=torch.int32)
    frac = ok.float() / torch.clamp(n, min=1).float()
    return torch.where(n > 0, frac, torch.ones_like(frac))


def violation_fraction(qos_series: torch.Tensor,
                       target: float) -> torch.Tensor:
    """Fraction of slots with Q(t) < target (paper Fig. 7b)."""
    return (qos_series < target).float().mean()


def recovery_slots(qos_series: torch.Tensor, target: float,
                   consecutive: int = 3) -> torch.Tensor:
    """Slots from the first QoS violation back to sustained health.

    Onset is the first slot with Q(t) < target; recovery is the first slot
    at or after onset opening a run of ``consecutive`` healthy slots (a
    healthy tail shorter than the run counts).  0 when the series never
    violates, ``S - onset`` when it never recovers.  () i32.
    """
    s = qos_series.shape[0]
    dev = qos_series.device
    below = qos_series < target
    onset = torch.argmax(below.to(torch.int32))
    good = (~below).float()
    w = min(max(int(consecutive), 1), s)
    c = torch.cumsum(torch.cat([good.new_zeros(1), good]), dim=0)
    t = torch.arange(s, device=dev)
    hi = torch.clamp(t + w, max=s)
    run = (c[hi] - c[:-1]) >= (hi - t).float()
    cand = run & (t >= onset)
    rec = torch.where(cand.any(), torch.argmax(cand.to(torch.int32)),
                      torch.tensor(s, device=dev))
    return torch.where(below.any(), rec - onset,
                       torch.zeros_like(rec)).to(torch.int32)
