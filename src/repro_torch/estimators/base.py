"""The stateful estimator contract (port of ``repro.estimators.base``).

``EstimatorState(est, aux)``: ``est`` is the (N, R) load estimate L-hat
the ULB filter reads, ``aux`` any estimator-specific state.  Estimators
are frozen dataclasses with ``init_state(n_nodes, n_resources, device)``
and ``refresh(state, node_usage, draw)``, where ``draw(shape)`` returns
the estimator's standard normals for the slot.  The reference's adapter
for legacy stateless estimators has no counterpart: the port has none.
"""
from __future__ import annotations

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


def as_stateful(est):
    """Check that ``est`` implements the stateful contract; return it."""
    if is_stateful(est) and getattr(est, "refresh", None) is not None:
        return est
    raise TypeError(
        f"{est!r} is not an estimator: it lacks the stateful "
        f"init_state/refresh pair")
