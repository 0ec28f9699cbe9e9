"""Graceful degradation under QoS pressure (port of
``repro.faults.degrade``).

The controller watches a windowed cluster-QoS trend, a ``(W,)`` ring of
the last slots' Q(t) (newest first): a sustained dip is pressure, one bad
slot is not.  Under pressure the simulator evicts up to
``degrade_evict`` resident tasks a slot, reclaimed tasks first, then
batch tasks, sparing production and system work unless
``degrade_spare_production=False``; within a rank the newest admission
goes first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.numerics import xla_sum
from repro_torch.core.types import CLASS_PRODUCTION

# Victim ranking: higher evicts first; 0 is never evicted.
_RANK_BATCH = 1
_RANK_RECLAIMED = 2


def push_window(window: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Shift the ring one slot and put ``q`` at index 0 (newest first)."""
    out = torch.roll(window, 1, dims=0)
    out[0] = q
    return out


def under_pressure(window: torch.Tensor, threshold) -> torch.Tensor:
    """() bool: the window's mean QoS is below ``threshold``.  The mean
    adds in the order the reference's compiled ``jnp.mean`` does, so the
    comparison agrees bit for bit."""
    mean = xla_sum(window) * float(np.float32(1.0 / window.shape[0]))
    return mean < threshold


def victim_rank(priority: torch.Tensor, reclaimed: torch.Tensor,
                spare_production: bool) -> torch.Tensor:
    """(T,) i32 eviction rank: reclaimed 2 > batch 1 > production 0
    (spared); without ``spare_production`` every task ranks at least 1."""
    rank = torch.where(reclaimed, _RANK_RECLAIMED, 0)
    rank = torch.maximum(rank, torch.where(priority < CLASS_PRODUCTION,
                                           _RANK_BATCH, 0))
    if not spare_production:
        rank = torch.clamp(rank, min=1)
    return rank.to(torch.int32)


def select_victims(evictable: torch.Tensor, rank: torch.Tensor,
                   admit_slot: torch.Tensor, n_slots: int,
                   max_evict: int) -> torch.Tensor:
    """(T,) bool mask of at most ``max_evict`` victims, by rank
    descending, then newest admission first; with leading run axes (B, T)
    inputs, each run's own.

    The reference takes ``lax.top_k`` of the key ``rank * (n_slots + 1) +
    admit_slot + 1``, on which many tasks tie; ``top_k`` puts the lower
    index first among ties, and so does a stable descending sort
    (``torch.topk`` promises no order among ties).  The key's values are
    small integers, exact in float32 however it is rounded.
    """
    t = evictable.shape[-1]
    k = min(int(max_evict), t)
    if k <= 0:
        return torch.zeros_like(evictable, dtype=torch.bool)
    key = (rank.to(torch.float32) * float(n_slots + 1)
           + admit_slot.to(torch.float32) + 1.0)
    key = torch.where(evictable & (rank > 0), key, 0.0)
    top_val, top_idx = torch.sort(key, dim=-1, descending=True, stable=True)
    out = torch.zeros_like(evictable, dtype=torch.bool)
    return out.scatter(-1, top_idx[..., :k], top_val[..., :k] > 0.0)
