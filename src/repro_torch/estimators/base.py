"""The stateful estimator contract (port of ``repro.estimators.base``).

``EstimatorState(est, aux)``: ``est`` is the (N, R) load estimate L-hat
the ULB filter reads, ``aux`` any estimator-specific state.  Estimators
are frozen dataclasses with ``init_state(n_nodes, n_resources, device)``
and ``refresh(state, node_usage, draw)``, where ``draw(shape)`` returns
the estimator's standard normals for the slot.  A legacy stateless
estimator (``refresh(prev_est, node_usage, draw) -> est``) is adapted by
:class:`StatelessAdapter`, whose state carries ``est`` alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.types import NUM_RESOURCES


class EstimatorState(NamedTuple):
    est: torch.Tensor  # (N, R) f32 current load estimate L-hat
    aux: Any = ()      # estimator-specific state


def zeros_state(n_nodes: int, n_resources: int = NUM_RESOURCES,
                aux: Any = (), *, device="cuda") -> EstimatorState:
    return EstimatorState(
        est=torch.zeros((n_nodes, n_resources), dtype=torch.float32,
                        device=device), aux=aux)


def is_stateful(est) -> bool:
    return getattr(est, "init_state", None) is not None


@dataclasses.dataclass(frozen=True)
class StatelessAdapter:
    """A legacy ``refresh(prev_est, node_usage, draw) -> est`` object as a
    stateful estimator; its state starts at zeros, like the simulator's
    carry before estimators kept state."""

    inner: Any

    def init_state(self, n_nodes: int, n_resources: int = NUM_RESOURCES, *,
                   device="cuda") -> EstimatorState:
        return zeros_state(n_nodes, n_resources, device=device)

    def refresh(self, state: EstimatorState, node_usage: torch.Tensor,
                draw) -> EstimatorState:
        return EstimatorState(
            est=self.inner.refresh(state.est, node_usage, draw), aux=())


def as_stateful(est):
    """An estimator of either convention as a stateful one."""
    if is_stateful(est):
        return est
    if getattr(est, "refresh", None) is None:
        raise TypeError(
            f"{est!r} is not an estimator: it implements neither the "
            f"stateful init_state/refresh pair nor the legacy "
            f"refresh(prev_est, node_usage, draw) hook")
    return StatelessAdapter(est)
