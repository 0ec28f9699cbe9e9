"""Load-estimator primitives L-hat (paper §4.2, §5.1).

Port of ``repro.core.estimator``: current usage with an optional
multiplicative noise knob, and EWMA.  The stateful estimator objects live
in :mod:`repro_torch.estimators`.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.numerics import fma

# draw(shape) -> f32 standard normals: the estimator's noise stream.
Draw = Callable[[Sequence[int]], torch.Tensor]


def current_usage(node_usage: torch.Tensor, draw: Optional[Draw] = None,
                  noise_std: float = 0.0) -> torch.Tensor:
    """The paper's estimator: L-hat = measured current usage."""
    if draw is not None and noise_std > 0.0:
        noise = fma(noise_std, draw(node_usage.shape), 1.0)
        return torch.clamp(node_usage * noise, min=0.0)
    return node_usage


def ewma(prev_est: torch.Tensor, measurement: torch.Tensor,
         decay: float = 0.7) -> torch.Tensor:
    """Exponentially-weighted moving average estimator."""
    return fma(decay, prev_est, (1.0 - decay) * measurement)
