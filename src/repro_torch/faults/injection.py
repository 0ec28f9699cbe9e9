"""Fault injection as static-shape event tables (port of
``repro.faults.injection``).

A :class:`FaultSchedule` holds one ``(N,)`` row per slot for each event
kind, which the simulator reads slot by slot:

  * node crash/recover windows: ``node_up[s, n]`` False while node n is
    down; its residents are evicted into the retry queue;
  * capacity flaps: ``capacity[s, n] < 1``, folded into the node's
    reserved load (``api.admission.mask_unavailable``);
  * usage surges: ``demand_mult[s, n] > 1`` multiplies the demand of the
    tasks resident on node n;
  * drain windows: ``draining[s, n]`` True in the advance warning before
    a crash or flap, which only the migration pass reads.

A schedule comes from :func:`sample_schedule` (``SimConfig(faults=...)``,
drawn from a ``torch.Generator``), from :func:`crash_burst` or
:func:`usage_surge` (deterministic, bit-identical to the reference's),
or from the reference's own tables through ``repro_torch.convert``:
decisions equal the reference's only under such a replayed schedule.
``faults=None`` leaves the simulator's fault-free path untouched.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def install_config_validator(cls, validator) -> None:
    """Make a ``typing.NamedTuple`` config fail fast at construction.

    ``typing.NamedTuple`` forbids overriding ``__new__``/``_make`` in the
    class body, so they are replaced after the class is built: every
    construction route (positional or keyword ``__new__``, ``_make`` and
    ``_replace``, which calls ``_make``) runs ``validator(self)``, which
    raises :class:`ValueError` on a degenerate config.
    """
    orig_new = cls.__new__

    def __new__(_cls, *args, **kwargs):
        self = orig_new(_cls, *args, **kwargs)
        validator(self)
        return self

    def _make(_cls, iterable):
        self = tuple.__new__(_cls, iterable)
        if len(self) != len(cls._fields):
            raise TypeError(
                f"Expected {len(cls._fields)} arguments, got {len(self)}")
        validator(self)
        return self

    cls.__new__ = staticmethod(__new__)
    cls._make = classmethod(_make)


class FaultConfig(NamedTuple):
    """Fault-injection and degradation knobs (the reference's fields and
    defaults).  Rates are per node (or replica) per slot (or engine
    step); durations are in slots or steps."""

    # node crash/recover windows (sampled)
    crash_rate: float = 0.0
    crash_duration: int = 12
    # deterministic crash burst (correlated failure)
    burst_slot: int = -1           # -1: no burst
    burst_frac: float = 0.0
    burst_duration: int = 12
    # capacity flaps
    flap_rate: float = 0.0
    flap_capacity: float = 0.5
    flap_duration: int = 6
    # usage surges (cluster-wide events hitting a node subset)
    surge_rate: float = 0.0
    surge_frac: float = 0.25
    surge_mult: float = 2.0
    surge_duration: int = 6
    # straggler storms (serving engine only)
    storm_rate: float = 0.0
    storm_slowdown: float = 4.0
    storm_duration: int = 8
    # advance warning before a crash or flap, read by migration only
    warn_slots: int = 0
    # graceful-degradation controller
    degrade: bool = False
    qos_window: int = 8
    degrade_threshold: float = 0.0  # 0.0: the policy's qos_target
    degrade_evict: int = 64
    degrade_spare_production: bool = True


def _validate_faults(cfg: FaultConfig) -> None:
    """Reject degenerate fault configs at construction."""
    for knob in ("crash_rate", "flap_rate", "surge_rate", "storm_rate"):
        v = getattr(cfg, knob)
        if not 0.0 <= float(v) <= 1.0:
            raise ValueError(
                f"FaultConfig.{knob} must be a probability in [0, 1], "
                f"got {v!r}")
    for knob in ("crash_duration", "burst_duration", "flap_duration",
                 "surge_duration", "storm_duration"):
        if int(getattr(cfg, knob)) <= 0:
            raise ValueError(
                f"FaultConfig.{knob} must be a positive slot count, "
                f"got {getattr(cfg, knob)!r}")
    if cfg.burst_slot < -1:
        raise ValueError(
            f"FaultConfig.burst_slot must be >= 0 (or -1 for no burst), "
            f"got {cfg.burst_slot!r}")
    for knob in ("burst_frac", "surge_frac"):
        if not 0.0 <= float(getattr(cfg, knob)) <= 1.0:
            raise ValueError(
                f"FaultConfig.{knob} must be in [0, 1], "
                f"got {getattr(cfg, knob)!r}")
    if float(cfg.flap_capacity) < 0.0:
        raise ValueError(
            f"FaultConfig.flap_capacity must be >= 0, "
            f"got {cfg.flap_capacity!r}")
    for knob in ("surge_mult", "storm_slowdown"):
        if float(getattr(cfg, knob)) <= 0.0:
            raise ValueError(
                f"FaultConfig.{knob} must be > 0, "
                f"got {getattr(cfg, knob)!r}")
    if cfg.warn_slots < 0:
        raise ValueError(
            f"FaultConfig.warn_slots must be >= 0, got {cfg.warn_slots!r}")
    if cfg.qos_window <= 0:
        raise ValueError(
            f"FaultConfig.qos_window must be a positive window length, "
            f"got {cfg.qos_window!r}")
    if cfg.degrade_evict < 0:
        raise ValueError(
            f"FaultConfig.degrade_evict must be >= 0, "
            f"got {cfg.degrade_evict!r}")


install_config_validator(FaultConfig, _validate_faults)


class FaultSchedule(NamedTuple):
    """Event tables, one row per slot."""

    node_up: torch.Tensor      # (S, N) bool, False while the node is down
    capacity: torch.Tensor     # (S, N) f32 usable capacity (1.0 healthy)
    demand_mult: torch.Tensor  # (S, N) f32 demand shock on residents
    draining: "torch.Tensor | None" = None  # (S, N) bool warning window;
                                            # None reads as all-False

    @staticmethod
    def none(n_slots: int, n_nodes: int, *, device="cuda"
             ) -> "FaultSchedule":
        """The identity schedule: every node healthy every slot."""
        shape = (n_slots, n_nodes)
        return FaultSchedule(
            node_up=torch.ones(shape, dtype=torch.bool, device=device),
            capacity=torch.ones(shape, dtype=torch.float32, device=device),
            demand_mult=torch.ones(shape, dtype=torch.float32,
                                   device=device),
            draining=torch.zeros(shape, dtype=torch.bool, device=device))

    def to(self, device) -> "FaultSchedule":
        return FaultSchedule(*(None if x is None else x.to(device)
                               for x in self))


def stack_schedules(schedules) -> FaultSchedule:
    """B runs' schedules as one whose tables lead with B (a ``None``
    drain table reads as all-False where another run has one)."""
    from repro_torch.core.noise import stack_runs

    first = schedules[0]
    drains = [x.draining for x in schedules]
    if all(d is None for d in drains):
        draining = None
    else:
        draining = stack_runs([
            torch.zeros_like(x.node_up) if d is None else d
            for x, d in zip(schedules, drains)])
    return FaultSchedule(
        *(stack_runs([getattr(x, f) for x in schedules])
          for f in ("node_up", "capacity", "demand_mult")),
        draining=draining)


def _windows(starts: torch.Tensor, duration: int) -> torch.Tensor:
    """(S, N) bool: True for ``duration`` slots from each start (its own
    slot included); overlapping windows merge."""
    s = starts.shape[0]
    c = torch.cumsum(starts.to(torch.int32), dim=0)
    lag = torch.cat([c.new_zeros((min(duration, s),) + c.shape[1:]),
                     c])[:s]
    return (c - lag) > 0


def _announce(bad: torch.Tensor, warn_slots: int) -> torch.Tensor:
    """(S, N) bool drain table: the node is healthy at slot s and a bad
    window (down or flapping) opens within the next ``warn_slots``
    slots."""
    s = bad.shape[0]
    if warn_slots <= 0:
        return torch.zeros_like(bad, dtype=torch.bool)
    c = torch.cumsum(bad.to(torch.int32), dim=0)
    idx = torch.clamp(torch.arange(s, device=bad.device) + warn_slots,
                      max=s - 1)
    return ((c[idx] - c) > 0) & ~bad


def sample_schedule(faults: FaultConfig, gen: torch.Generator,
                    n_slots: int, n_nodes: int) -> FaultSchedule:
    """One fault realization drawn from ``gen`` at the config's rates, on
    ``gen``'s device.  All-zero rates give the identity schedule exactly.
    The draws are not the reference's (threefry); replay its schedule for
    parity."""
    dev = gen.device
    shape = (n_slots, n_nodes)

    def bernoulli(p, size):
        return torch.rand(size, generator=gen, device=dev) < p

    down = _windows(bernoulli(faults.crash_rate, shape),
                    faults.crash_duration)
    if faults.burst_slot >= 0 and faults.burst_frac > 0.0:
        n_burst = int(round(faults.burst_frac * n_nodes))
        hit = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
        hit[torch.randperm(n_nodes, generator=gen, device=dev)[:n_burst]] = (
            True)
        slots = torch.arange(n_slots, device=dev)[:, None]
        in_window = ((slots >= faults.burst_slot)
                     & (slots < faults.burst_slot + faults.burst_duration))
        down = down | (in_window & hit[None, :])

    flapping = _windows(bernoulli(faults.flap_rate, shape),
                        faults.flap_duration)
    one = torch.ones(shape, dtype=torch.float32, device=dev)
    capacity = torch.where(flapping, float(np.float32(faults.flap_capacity)),
                           one)

    surge_event = bernoulli(faults.surge_rate, (n_slots, 1))
    surging = _windows(surge_event & bernoulli(faults.surge_frac, shape),
                       faults.surge_duration)
    demand_mult = torch.where(surging, float(np.float32(faults.surge_mult)),
                              one)
    return FaultSchedule(node_up=~down, capacity=capacity,
                         demand_mult=demand_mult,
                         draining=_announce(down | flapping,
                                            faults.warn_slots))


def crash_burst(n_slots: int, n_nodes: int, slot: int, frac: float,
                duration: int, nodes=None, warn_slots: int = 0, *,
                device="cuda") -> FaultSchedule:
    """Correlated failure: ``frac`` of the nodes (the first ones, or
    ``nodes``) go down together at ``slot`` for ``duration`` slots, with
    a drain window of ``warn_slots`` slots before it.  Deterministic."""
    if nodes is None:
        nodes = np.arange(int(round(frac * n_nodes)))
    nodes = np.asarray(nodes, int)
    node_up = np.ones((n_slots, n_nodes), bool)
    lo, hi = max(int(slot), 0), min(int(slot) + int(duration), n_slots)
    node_up[lo:hi, nodes] = False
    draining = np.zeros((n_slots, n_nodes), bool)
    if warn_slots > 0:
        draining[max(lo - int(warn_slots), 0):lo, nodes] = True
    shape = (n_slots, n_nodes)
    return FaultSchedule(
        node_up=torch.from_numpy(node_up).to(device),
        capacity=torch.ones(shape, dtype=torch.float32, device=device),
        demand_mult=torch.ones(shape, dtype=torch.float32, device=device),
        draining=torch.from_numpy(draining).to(device))


def usage_surge(n_slots: int, n_nodes: int, start: int, ramp: int,
                hold: int, peak_mult: float, *, device="cuda"
                ) -> FaultSchedule:
    """Cluster-wide demand ramp: 1 to ``peak_mult`` over ``ramp`` slots
    from ``start``, held ``hold`` slots, ramped back down.  Deterministic
    (the reference's numpy arithmetic)."""
    mult = np.ones(n_slots, np.float32)
    start, ramp, hold = int(start), max(int(ramp), 1), max(int(hold), 0)
    for i in range(ramp):
        s = start + i
        if 0 <= s < n_slots:
            mult[s] = 1.0 + (float(peak_mult) - 1.0) * (i + 1) / ramp
    for i in range(hold):
        s = start + ramp + i
        if 0 <= s < n_slots:
            mult[s] = float(peak_mult)
    for i in range(ramp):
        s = start + ramp + hold + i
        if 0 <= s < n_slots:
            mult[s] = 1.0 + (float(peak_mult) - 1.0) * (ramp - 1 - i) / ramp
    shape = (n_slots, n_nodes)
    return FaultSchedule(
        node_up=torch.ones(shape, dtype=torch.bool, device=device),
        capacity=torch.ones(shape, dtype=torch.float32, device=device),
        demand_mult=torch.from_numpy(mult).to(device)[:, None].expand(
            shape),
        draining=torch.zeros(shape, dtype=torch.bool, device=device))


def jitter_table(gen: torch.Generator, n_tasks: int,
                 jitter: int) -> torch.Tensor:
    """(T,) i32 per-task retry jitter in ``[0, jitter]`` drawn from
    ``gen``; all zeros when ``jitter`` is 0."""
    if jitter <= 0:
        return torch.zeros(n_tasks, dtype=torch.int32, device=gen.device)
    return torch.randint(0, jitter + 1, (n_tasks,), generator=gen,
                         dtype=torch.int32, device=gen.device)


def backoff_delay(attempts: torch.Tensor, backoff: int,
                  cap: int) -> torch.Tensor:
    """``min(backoff * 2**(attempts - 1), cap)`` slots, i32.

    ``attempts`` counts failures including the one just suffered.
    ``backoff=0`` retries the next slot.  Computed in float32, where
    powers of two are exact, so a large count saturates at ``cap``.
    """
    if backoff <= 0:
        return torch.zeros_like(attempts)
    exp = torch.clamp(attempts - 1, 0, 30).to(torch.float32)
    delay = float(backoff) * torch.exp2(exp)
    return torch.clamp(delay, max=float(cap)).to(torch.int32)
