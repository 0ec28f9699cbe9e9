"""Misprediction-safe overcommit: the estimator-drift watchdog and its
circuit breaker (port of ``repro.guard``).

``SimConfig(guard=GuardConfig(...))`` runs the watchdog in the slot loop:
the drift statistic scales the reclaim and migrate passes' penalty while
the breaker is closed, an open breaker suspends reclamation and blends
admission's estimate toward the residents' requests, and a half-open
probe re-admits a bounded trickle.  ``guard=None`` leaves the simulator
untouched.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.faults.injection import install_config_validator
from repro_torch.guard.watchdog import (  # noqa: F401
    CLOSED,
    HALF_OPEN,
    OPEN,
    blend_estimate,
    breaker_step,
    confidence,
    confidence_eager,
    drift_sample,
    init_window,
    penalty_scale,
    penalty_scale_eager,
    push_errors,
    reclaim_width,
    trip_statistic,
    trip_statistic_eager,
)


class GuardConfig(NamedTuple):
    """Drift-watchdog and breaker knobs (the reference's fields and
    defaults)."""

    window: int = 16             # drift ring length, in slots
    err_quantile: float = 0.9    # windowed quantile of the trip statistic
    trip_threshold: float = 0.15  # statistic that opens the breaker; the
                                  # scale of the confidence ramp below it
    cooldown: int = 24           # slots the breaker stays OPEN
    probe_slots: int = 8         # HALF_OPEN probe length
    probe_reclaim: int = 8       # reclaim candidates a HALF_OPEN slot
    open_blend: float = 1.0      # estimate's retreat toward requests
                                 # while OPEN
    guard_scale: float = 1.0     # reclaim/migrate penalty
                                 # P * (1 + guard_scale * confidence)


def _validate_guard(cfg: GuardConfig) -> None:
    """Reject degenerate guard configs at construction."""
    if cfg.window <= 0:
        raise ValueError(
            f"GuardConfig.window must be a positive ring length, "
            f"got {cfg.window!r}")
    if not 0.0 <= float(cfg.err_quantile) <= 1.0:
        raise ValueError(
            f"GuardConfig.err_quantile must be in [0, 1], "
            f"got {cfg.err_quantile!r}")
    if float(cfg.trip_threshold) <= 0.0:
        raise ValueError(
            f"GuardConfig.trip_threshold must be > 0, "
            f"got {cfg.trip_threshold!r}")
    for knob in ("cooldown", "probe_slots"):
        if int(getattr(cfg, knob)) <= 0:
            raise ValueError(
                f"GuardConfig.{knob} must be a positive slot count, "
                f"got {getattr(cfg, knob)!r}")
    if cfg.probe_reclaim < 0:
        raise ValueError(
            f"GuardConfig.probe_reclaim must be >= 0, "
            f"got {cfg.probe_reclaim!r}")
    if not 0.0 <= float(cfg.open_blend) <= 1.0:
        raise ValueError(
            f"GuardConfig.open_blend must be in [0, 1], "
            f"got {cfg.open_blend!r}")
    if float(cfg.guard_scale) < 0.0:
        raise ValueError(
            f"GuardConfig.guard_scale must be >= 0, "
            f"got {cfg.guard_scale!r}")


install_config_validator(GuardConfig, _validate_guard)
