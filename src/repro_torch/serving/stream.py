"""Open-loop arrival driving for the serving engine.

Port of ``repro.serving.stream`` (numpy, so equal seeds give equal
requests).  Arrivals are pushed at the engine at a configured production
rate, whether or not it keeps up, never drained from a pre-filled queue:
:class:`RequestStream` turns the per-slot arrival processes of
:func:`repro_torch.traces.generator.arrival_counts` (Poisson / diurnal /
burst) into :class:`~repro_torch.serving.engine.Request` objects with
trace-like marginals: Zipf sources, a production-priority fraction, and
declared token budgets that over-estimate true generation lengths.

Usage::

    eng = ServeEngine(EngineConfig(...))
    stream = RequestStream(StreamConfig(pattern="burst", mean_rate=32.0),
                           horizon=512)
    stats = stream.drive(eng)          # submit slot arrivals, step, repeat
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.types import CLASS_BATCH, CLASS_PRODUCTION, NUM_SRC_BUCKETS
from repro_torch.serving.engine import EngineStats, Request, ServeEngine
from repro_torch.traces.generator import ARRIVAL_PATTERNS, arrival_counts


@dataclasses.dataclass
class StreamConfig:
    pattern: str = "poisson"        # one of traces.ARRIVAL_PATTERNS
    mean_rate: float = 8.0          # mean arrivals per engine step
    prompt_mean: int = 64           # mean prompt length (geometric)
    max_tokens_mean: int = 128      # mean DECLARED generation budget
    use_ratio: float = 0.45         # E[true_tokens / max_tokens] — the
                                    # usage/request gap the paper measures
                                    # (~45%, Fig. 1); 1.0 = honest clients
    zipf_a: float = 1.4             # source-popularity skew (same-source rule)
    prod_frac: float = 0.2          # fraction of CLASS_PRODUCTION requests
    diurnal_amp: float = 0.5        # diurnal pattern: rate modulation depth
    diurnal_period: Optional[int] = None   # slots per cycle (None = horizon)
    burst_prob: float = 0.05        # burst pattern: P(slot is a burst)
    burst_mult: float = 10.0        # burst pattern: rate multiplier
    shock_start: int = -1           # black-swan demand shock: first slot of a
                                    # deterministic arrival-rate spike (-1 =
                                    # none) — the open-loop companion to the
                                    # fault injector's usage surges
                                    # (faults): offered load jumps
                                    # whether or not the engine keeps up
    shock_len: int = 0              # slots the shock lasts
    shock_mult: float = 1.0         # arrival-count multiplier during the shock
    seed: int = 0


class RequestStream:
    """Pre-sampled arrival schedule over a fixed horizon of engine steps."""

    def __init__(self, cfg: StreamConfig, horizon: int):
        if cfg.pattern not in ARRIVAL_PATTERNS:
            raise ValueError(
                f"unknown arrival pattern {cfg.pattern!r}; "
                f"one of {ARRIVAL_PATTERNS}")
        self.cfg = cfg
        self.horizon = int(horizon)
        self.counts = arrival_counts(
            cfg.seed, self.horizon, cfg.mean_rate, cfg.pattern,
            diurnal_amp=cfg.diurnal_amp, diurnal_period=cfg.diurnal_period,
            burst_prob=cfg.burst_prob, burst_mult=cfg.burst_mult)
        if cfg.shock_start >= 0 and cfg.shock_len > 0:
            self.counts = np.array(self.counts, copy=True)
            lo = int(cfg.shock_start)
            hi = min(lo + int(cfg.shock_len), self.horizon)
            self.counts[lo:hi] = np.round(
                self.counts[lo:hi] * cfg.shock_mult).astype(self.counts.dtype)
        self._rng = np.random.default_rng(cfg.seed + 1)
        self._next_rid = 0

    def _make_request(self) -> Request:
        cfg = self.cfg
        rng = self._rng
        prompt = int(rng.geometric(1.0 / max(cfg.prompt_mean, 1)))
        declared = int(rng.geometric(1.0 / max(cfg.max_tokens_mean, 1)))
        # True generation length: a noisy fraction of the declared budget,
        # clipped into [1, declared] — clients over-ask, usage under-fills.
        ratio = float(np.clip(rng.normal(cfg.use_ratio, 0.15 * cfg.use_ratio),
                              0.05, 1.0))
        true_tokens = max(1, min(declared, int(round(declared * ratio))))
        req = Request(
            rid=self._next_rid,
            prompt_len=prompt,
            max_tokens=declared,
            true_tokens=true_tokens,
            src=int(rng.zipf(cfg.zipf_a) % NUM_SRC_BUCKETS),
            priority=(CLASS_PRODUCTION
                      if rng.random() < cfg.prod_frac else CLASS_BATCH),
        )
        self._next_rid += 1
        return req

    @property
    def submitted(self) -> int:
        """Requests materialized so far (monotone rid counter)."""
        return self._next_rid

    def step(self, t: int) -> List[Request]:
        """The requests arriving in slot ``t`` (empty past the horizon)."""
        if not 0 <= t < self.horizon:
            return []
        return [self._make_request() for _ in range(int(self.counts[t]))]

    def drive(self, engine: ServeEngine,
              steps: Optional[int] = None) -> EngineStats:
        """Open-loop: submit slot ``t``'s arrivals, step the engine, repeat.

        ``steps`` beyond the horizon run with no new arrivals (drain
        tail); default is exactly the horizon.
        """
        for t in range(self.horizon if steps is None else int(steps)):
            for req in self.step(t):
                engine.submit(req)
            engine.step()
        return engine.stats
