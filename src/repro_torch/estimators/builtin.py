"""Built-in load estimators ``current``, ``ewma`` and ``quantile``.

Port of ``repro.estimators.builtin``.  ``current`` and ``ewma`` call back
into :mod:`repro_torch.core.estimator`.  ``quantile`` is the sliding
peak-window predictor: L-hat is the q-quantile of the last ``window``
usage samples per node and resource, held in a ``(window, N, R)`` ring
buffer.  The ``learned`` estimator lives in
:mod:`repro_torch.estimators.learned`.

A windowed estimator's slot counter is a Python int carried in its
state, so a refresh writes its ring slot without reading the device.

All three serve B runs at once (``run_axis``): ``current`` and ``ewma``
are elementwise, and ``quantile``'s ring of B runs is (window, B, N, R),
the window axis first as in one run's, so the ring functions below run
unchanged.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import estimator as _est
from repro_torch.core.numerics import fma
from repro_torch.core.types import NUM_RESOURCES
from repro_torch.estimators.base import (EstimatorState, node_shape,
                                         zeros_state)
from repro_torch.estimators.registry import register_estimator


def ring_push(buffer: torch.Tensor, t: int,
              usage: torch.Tensor) -> torch.Tensor:
    """A copy of the (W, ...) ring ``buffer`` with ``usage`` in slot
    ``t % W``.

    The first measurement (t == 0) fills every slot, so the window is
    always full: until it wraps once, unwritten slots repeat the first
    sample.
    """
    if t == 0:
        return usage.expand(buffer.shape).clone()
    out = buffer.clone()
    out[t % buffer.shape[0]] = usage
    return out


def ring_chronological(buffer: torch.Tensor, t: int) -> torch.Tensor:
    """The ring buffer oldest-first (newest sample last), after
    ``ring_push`` at slot ``t``."""
    return torch.roll(buffer, -(t % buffer.shape[0] + 1), dims=0)


def window_quantile(buffer: torch.Tensor, q: float, *,
                    fuse_high: bool = False) -> torch.Tensor:
    """The ``q``-quantile over axis 0, linear interpolation (numpy's
    default method).

    Rounded as ``jnp.quantile`` computes it: the position ``q * (W - 1)``
    in float32, then ``low * (1 - w) + high * w`` with the first product
    fused into the sum, as XLA compiles it inside a jitted program.
    ``fuse_high`` fuses the other product instead, as XLA compiles
    ``jnp.quantile`` called on its own, with ``q`` a run-time input.
    """
    pos = np.float32(q) * np.float32(buffer.shape[0] - 1)
    low, high = math.floor(pos), math.ceil(pos)
    w_high = np.float32(pos - np.float32(low))
    w_low = np.float32(1.0) - w_high
    ordered = torch.sort(buffer, dim=0).values
    if fuse_high:
        return fma(ordered[high], float(w_high),
                   ordered[low] * float(w_low))
    return fma(ordered[low], float(w_low), ordered[high] * float(w_high))


@register_estimator("current")
@dataclasses.dataclass(frozen=True)
class CurrentEstimator:
    """The paper's estimator: L-hat = measured current usage.

    ``noise_std`` adds multiplicative measurement noise, clamped at zero.
    """

    noise_std: float = 0.0
    run_axis = True

    def init_state(self, n_nodes: int, n_resources: int = NUM_RESOURCES, *,
                   device="cuda", runs=None) -> EstimatorState:
        return zeros_state(n_nodes, n_resources, device=device, runs=runs)

    def refresh(self, state: EstimatorState, node_usage: torch.Tensor,
                draw) -> EstimatorState:
        return EstimatorState(
            est=_est.current_usage(node_usage, draw, self.noise_std), aux=())


@register_estimator("ewma")
@dataclasses.dataclass(frozen=True)
class EwmaEstimator:
    """EWMA smoothing; ``decay=0`` is ``current`` exactly."""

    decay: float = 0.7
    run_axis = True

    def init_state(self, n_nodes: int, n_resources: int = NUM_RESOURCES, *,
                   device="cuda", runs=None) -> EstimatorState:
        return zeros_state(n_nodes, n_resources, device=device, runs=runs)

    def refresh(self, state: EstimatorState, node_usage: torch.Tensor,
                draw) -> EstimatorState:
        return EstimatorState(
            est=_est.ewma(state.est, node_usage, self.decay), aux=())


@register_estimator("quantile")
@dataclasses.dataclass(frozen=True)
class QuantileWindowEstimator:
    """Sliding peak-window quantile predictor.

    L-hat is the ``q``-quantile of the last ``window`` usage samples per
    node and resource.  State: the ``(window, N, R)`` ring buffer
    (``(window, B, N, R)`` for B runs) and the slot counter.
    """

    window: int = 12   # 1 h of history at the trace's 5-minute slots
    q: float = 0.9
    run_axis = True

    def init_state(self, n_nodes: int, n_resources: int = NUM_RESOURCES, *,
                   device="cuda", runs=None) -> EstimatorState:
        buffer = torch.zeros(
            (self.window,) + node_shape(n_nodes, n_resources, runs),
            dtype=torch.float32, device=device)
        return zeros_state(n_nodes, n_resources, aux=(buffer, 0),
                           device=device, runs=runs)

    def refresh(self, state: EstimatorState, node_usage: torch.Tensor,
                draw) -> EstimatorState:
        buffer, t = state.aux
        buffer = ring_push(buffer, t, node_usage)
        return EstimatorState(est=window_quantile(buffer, self.q),
                              aux=(buffer, t + 1))
