"""Estimation-penalty controller (paper §4.2, Alg. 3 lines 19-25).

Port of ``repro.core.penalty``.  QoS healthy: P = max(alpha * P, P_min);
QoS violated and still degrading: P = P + beta * (P - 1); then clamp to
[P_min, P_max].
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import fma
from repro_torch.core.types import ControllerState, FlexParams


def update_penalty(state: ControllerState, qos: torch.Tensor,
                   params: FlexParams) -> ControllerState:
    """One PeriodicEstimationPenaltyUpdate step (Alg. 3)."""
    qos = torch.as_tensor(qos, dtype=torch.float32,
                          device=state.penalty.device)
    p = state.penalty
    healthy = qos >= params.qos_target
    degrading = (qos < params.qos_target) & (qos < state.prev_qos)

    p_decrease = torch.maximum(p * params.alpha, params.p_min)
    p_increase = fma(params.beta, p - 1.0, p)
    new_p = torch.where(healthy, p_decrease,
                        torch.where(degrading, p_increase, p))
    new_p = torch.minimum(torch.maximum(new_p, params.p_min), params.p_max)
    return ControllerState(penalty=new_p, prev_qos=qos)
