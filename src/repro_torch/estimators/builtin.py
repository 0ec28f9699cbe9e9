"""Built-in load estimators ``current`` and ``ewma``.

Port of the two memoryless entries of ``repro.estimators.builtin``; both
call back into :mod:`repro_torch.core.estimator`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import estimator as _est
from repro_torch.core.types import NUM_RESOURCES
from repro_torch.estimators.base import EstimatorState, zeros_state
from repro_torch.estimators.registry import register_estimator


@register_estimator("current")
@dataclasses.dataclass(frozen=True)
class CurrentEstimator:
    """The paper's estimator: L-hat = measured current usage.

    ``noise_std`` adds multiplicative measurement noise, clamped at zero.
    """

    noise_std: float = 0.0

    def init_state(self, n_nodes: int, n_resources: int = NUM_RESOURCES, *,
                   device="cuda") -> EstimatorState:
        return zeros_state(n_nodes, n_resources, device=device)

    def refresh(self, state: EstimatorState, node_usage: torch.Tensor,
                draw) -> EstimatorState:
        return EstimatorState(
            est=_est.current_usage(node_usage, draw, self.noise_std), aux=())


@register_estimator("ewma")
@dataclasses.dataclass(frozen=True)
class EwmaEstimator:
    """EWMA smoothing; ``decay=0`` is ``current`` exactly."""

    decay: float = 0.7

    def init_state(self, n_nodes: int, n_resources: int = NUM_RESOURCES, *,
                   device="cuda") -> EstimatorState:
        return zeros_state(n_nodes, n_resources, device=device)

    def refresh(self, state: EstimatorState, node_usage: torch.Tensor,
                draw) -> EstimatorState:
        return EstimatorState(
            est=_est.ewma(state.est, node_usage, self.decay), aux=())
