"""The stateful estimator contract (port of ``repro.estimators.base``).

``EstimatorState(est, aux)``: ``est`` is the (N, R) load estimate L-hat
the ULB filter reads, ``aux`` any estimator-specific state.  Estimators
are frozen dataclasses with ``init_state(n_nodes, n_resources, device)``
and ``refresh(state, node_usage, draw)``, where ``draw(shape)`` returns
the estimator's standard normals for the slot.  A legacy stateless
estimator (``refresh(prev_est, node_usage, draw) -> est``) is adapted by
:class:`StatelessAdapter`, whose state carries ``est`` alone.

An estimator with ``run_axis = True`` serves B runs at once
(``core.simulator.simulate_runs``): ``init_state(..., runs=B)`` gives
every per-node leaf a run axis in front of its node axis (``est`` (B, N,
R)), and ``refresh`` takes usage (B, N, R) and a ``draw`` whose shape
leads with B, each run refreshed exactly as a run of its own.  The
simulator refreshes any other estimator run by run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.types import NUM_RESOURCES


class EstimatorState(NamedTuple):
    est: torch.Tensor  # (N, R) f32 current load estimate L-hat
    aux: Any = ()      # estimator-specific state


def node_shape(n_nodes: int, n_resources: int, runs=None) -> tuple:
    """(N, R), or (B, N, R) for ``runs`` = B."""
    return (() if runs is None else (runs,)) + (n_nodes, n_resources)


def zeros_state(n_nodes: int, n_resources: int = NUM_RESOURCES,
                aux: Any = (), *, device="cuda", runs=None) -> EstimatorState:
    return EstimatorState(
        est=torch.zeros(node_shape(n_nodes, n_resources, runs),
                        dtype=torch.float32, device=device), aux=aux)


def is_stateful(est) -> bool:
    return getattr(est, "init_state", None) is not None


@dataclasses.dataclass(frozen=True)
class StatelessAdapter:
    """A legacy ``refresh(prev_est, node_usage, draw) -> est`` object as a
    stateful estimator; its state starts at zeros, like the simulator's
    carry before estimators kept state."""

    inner: Any

    @property
    def run_axis(self) -> bool:
        return bool(getattr(self.inner, "run_axis", False))

    def init_state(self, n_nodes: int, n_resources: int = NUM_RESOURCES, *,
                   device="cuda", runs=None) -> EstimatorState:
        return zeros_state(n_nodes, n_resources, device=device, runs=runs)

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
