"""Estimator-drift watchdog and circuit breaker (port of
``repro.guard.watchdog``).

The monitored signal is the one-slot-ahead estimate error: the estimate
refreshed at slot t-1 against the usage realized at slot t, its mean
absolute value over the nodes per resource.  A ``(W, R)`` ring holds the
last W samples (newest at row 0, zero at start, so a cold window never
trips); the trip statistic is the worst resource's q-quantile over the
window.  The breaker is a three-state machine carried as integers:

  CLOSED (0)     normal; the statistic tightens the reclaim and migrate
                 passes' cap continuously (``penalty_scale``);
  OPEN (1)       the statistic crossed ``trip_threshold``: reclamation
                 suspended, admission's estimate blended toward the
                 residents' requests, for ``cooldown`` slots;
  HALF_OPEN (2)  a bounded reclaim trickle for ``probe_slots`` slots;
                 renewed drift re-opens, a clean probe closes.

Rounding follows the reference as XLA compiles it: the mean over nodes
adds in XLA's order (``numerics.xla_sum``) and multiplies by ``1 / N``;
the division by the trip threshold is a multiplication by its rounded
reciprocal; ``1 + g * conf`` and the blend are fused multiply-adds.
The serving engine runs the reference's watchdog eagerly, op by op, and
there the division is a true division, ``1 + g * conf`` rounds twice,
and ``jnp.quantile``, which then takes ``q`` as a run-time input, fuses
the other product of its interpolation: ``trip_statistic_eager``,
``confidence_eager`` and ``penalty_scale_eager`` round as it does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.numerics import fma, xla_sum
from repro_torch.estimators.builtin import window_quantile
from repro_torch.faults.degrade import push_window

CLOSED = 0
OPEN = 1
HALF_OPEN = 2


def init_window(window: int, n_resources: int, *,
                device="cuda") -> torch.Tensor:
    """(W, R) f32 drift ring; zero error = a trusted estimator."""
    return torch.zeros((window, n_resources), dtype=torch.float32,
                       device=device)


def drift_sample(prev_est: torch.Tensor, usage: torch.Tensor
                 ) -> torch.Tensor:
    """(R,) mean over nodes of ``|est[t-1] - usage[t]|``."""
    n = prev_est.shape[0]
    return (xla_sum(torch.abs(prev_est - usage))
            * float(np.float32(1.0 / n)))


def push_errors(window: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """Ring-push one (R,) sample; newest at row 0 (the degradation's
    ``push_window``)."""
    return push_window(window, err)


def trip_statistic(window: torch.Tensor, q: float) -> torch.Tensor:
    """() f32: the worst resource's windowed q-quantile, rounded as
    ``jnp.quantile`` (``estimators.builtin.window_quantile``)."""
    return window_quantile(window, q).max()


def trip_statistic_eager(window: torch.Tensor, q: float) -> torch.Tensor:
    """``trip_statistic`` as eager JAX rounds it: ``jnp.quantile`` with
    the other product of its interpolation fused."""
    return window_quantile(window, q, fuse_high=True).max()


def confidence(err_q: torch.Tensor, gcfg) -> torch.Tensor:
    """() f32 in [0, 1]: the drift as a fraction of the trip bar."""
    inv = float(np.float32(1.0) / np.float32(gcfg.trip_threshold))
    return torch.clamp(err_q * inv, 0.0, 1.0)


def penalty_scale(err_q: torch.Tensor, gcfg) -> torch.Tensor:
    """``1 + guard_scale * confidence``: the reclaim and migrate passes
    see ``P * penalty_scale``, a slot constant."""
    return fma(float(np.float32(gcfg.guard_scale)), confidence(err_q, gcfg),
               1.0)


def confidence_eager(err_q: float, gcfg) -> np.float32:
    """``confidence`` as eager JAX rounds it: a float32 division."""
    c = np.float32(err_q) / np.float32(gcfg.trip_threshold)
    return min(max(c, np.float32(0.0)), np.float32(1.0))


def penalty_scale_eager(err_q: float, gcfg) -> np.float32:
    """``penalty_scale`` as eager JAX rounds it: product, then sum."""
    return np.float32(1.0) + (np.float32(gcfg.guard_scale)
                              * confidence_eager(err_q, gcfg))


def breaker_step(state: torch.Tensor, timer: torch.Tensor,
                 err_q: torch.Tensor, gcfg):
    """One slot of the breaker.  Returns ``(state, timer, tripped)``, the
    state governing this slot: a trip from any state re-arms the full
    ``cooldown``, and an OPEN window that expires under drift re-opens."""
    tripped = err_q > float(np.float32(gcfg.trip_threshold))
    is_open = state == OPEN
    is_half = state == HALF_OPEN
    open_expired = is_open & (timer <= 1)
    to_open = tripped & (~is_open | open_expired)
    to_half = open_expired & ~tripped
    half_closes = is_half & ~tripped & (timer <= 1)
    next_state = torch.where(
        to_open, OPEN,
        torch.where(to_half, HALF_OPEN,
                    torch.where(half_closes, CLOSED, state)))
    next_timer = torch.where(
        to_open, int(gcfg.cooldown),
        torch.where(to_half, int(gcfg.probe_slots),
                    torch.clamp(timer - 1, min=0)))
    return (next_state.to(torch.int32), next_timer.to(torch.int32),
            tripped)


def blend_estimate(est: torch.Tensor, requested: torch.Tensor, is_open,
                   gcfg) -> torch.Tensor:
    """Safe mode: ``est + w * max(requested - est, 0)`` with ``w`` the
    ``open_blend`` while OPEN and 0 otherwise (then ``est`` exactly)."""
    w = torch.where(torch.as_tensor(is_open, device=est.device),
                    float(np.float32(gcfg.open_blend)), 0.0)
    return fma(w, torch.clamp(requested - est, min=0.0), est)


def reclaim_width(state: int, pool_width: int, gcfg) -> int:
    """How many head-of-pool reclaim candidates stay valid: the whole pool
    while CLOSED, none while OPEN, ``probe_reclaim`` while HALF_OPEN.  A
    tensor of states (one a run) gives a tensor of widths, on the device
    and without reading it."""
    if isinstance(state, torch.Tensor):
        half = min(int(gcfg.probe_reclaim), int(pool_width))
        return torch.where(state == OPEN, 0, torch.where(
            state == HALF_OPEN, half, int(pool_width))).to(state.dtype)
    if state == OPEN:
        return 0
    if state == HALF_OPEN:
        return min(int(gcfg.probe_reclaim), int(pool_width))
    return int(pool_width)
