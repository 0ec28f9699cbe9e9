"""Where the simulator's randomness comes from.

The JAX reference draws each slot's demand noise with
``jax.random.normal(fold_in(key, slot), (T,))`` (threefry), which PyTorch
cannot reproduce.  The port takes its standard normals from a noise
source instead:

* :class:`GeneratorNoise` draws from a seeded ``torch.Generator`` on the
  run's device (standalone runs);
* :class:`ReplayNoise` serves a given ``(S, T)`` float32 table, which the
  parity tests fill with the draws of the reference's key schedule.

Decisions equal the reference's only under replay.  Replay covers the
demand stream and, when given one, the per-task retry-jitter table: an
estimator that draws noise raises under it, and so does a sampled fault
schedule (pass the reference's to the simulator as ``fault_schedule``).
A generator source draws the fault schedule and the jitter table from
generators of their own, as the reference takes them from streams of
their own, so turning faults or jitter on leaves the demand draws as
they were.

A simulation of B runs (``core.simulator.simulate_runs``) keeps the B
runs' sources together in a :class:`RunNoise`: every draw is the runs'
draws stacked, run b's from its own source in the order a single run of
it draws, so a batched run under ``GeneratorNoise`` is bit-equal to the
loop of single runs, not only under ``ReplayNoise``.
"""
from __future__ import annotations

from typing import Protocol, Sequence

import torch


class NoiseSource(Protocol):
    def demand(self, slot: int, n_tasks: int) -> torch.Tensor:
        """(n_tasks,) f32 standard normals of slot ``slot``'s demand."""
        ...

    def estimate(self, slot: int, shape: Sequence[int]) -> torch.Tensor:
        """f32 standard normals for a noisy estimator at ``slot``."""
        ...

    def jitter(self, n_tasks: int, jitter: int) -> torch.Tensor:
        """(n_tasks,) i32 retry jitter in ``[0, jitter]``."""
        ...

    def faults(self, fcfg, n_slots: int, n_nodes: int):
        """A fault schedule sampled at ``fcfg``'s rates."""
        ...


# Offsets of the fault and jitter generators' seeds from the run's seed:
# the reference's fold_in stream constants.
_FAULT_STREAM = 0x7FFFFFFF
_JITTER_STREAM = 0x7FFFFFFE


class GeneratorNoise:
    """Standard normals from a seeded ``torch.Generator``.

    Draws are sequential, so a source serves one run: make a new one (same
    seed) to repeat a run.
    """

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.gen = self._generator(0)

    def _generator(self, stream: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + stream)
        return gen

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen,
                           dtype=torch.float32, device=self.device)

    def demand(self, slot: int, n_tasks: int) -> torch.Tensor:
        return self._normal((n_tasks,))

    def estimate(self, slot: int, shape: Sequence[int]) -> torch.Tensor:
        return self._normal(shape)

    def jitter(self, n_tasks: int, jitter: int) -> torch.Tensor:
        from repro_torch.faults.injection import jitter_table
        return jitter_table(self._generator(_JITTER_STREAM), n_tasks, jitter)

    def faults(self, fcfg, n_slots: int, n_nodes: int):
        from repro_torch.faults.injection import sample_schedule
        return sample_schedule(fcfg, self._generator(_FAULT_STREAM),
                               n_slots, n_nodes)


class ReplayNoise:
    """Serves row ``slot`` of an ``(S, T)`` float32 table of demand noise,
    and a ``(T,)`` int32 retry-jitter table when given one."""

    def __init__(self, table: torch.Tensor,
                 jitter: torch.Tensor | None = None):
        if table.dim() != 2 or table.dtype != torch.float32:
            raise ValueError(
                f"ReplayNoise needs an (S, T) float32 table, got "
                f"{tuple(table.shape)} {table.dtype}")
        if jitter is not None and (jitter.dtype != torch.int32
                                   or tuple(jitter.shape)
                                   != (table.shape[1],)):
            raise ValueError(
                f"ReplayNoise needs a ({table.shape[1]},) int32 jitter "
                f"table, got {tuple(jitter.shape)} {jitter.dtype}")
        self.table = table
        self.jitter_table = jitter

    def demand(self, slot: int, n_tasks: int) -> torch.Tensor:
        if slot >= self.table.shape[0] or n_tasks != self.table.shape[1]:
            raise ValueError(
                f"replay table {tuple(self.table.shape)} has no row of "
                f"{n_tasks} draws for slot {slot}")
        return self.table[slot]

    def estimate(self, slot: int, shape: Sequence[int]) -> torch.Tensor:
        raise ValueError(
            "ReplayNoise replays demand noise only; a noisy estimator "
            "draws a stream it does not hold (use noise_std=0, or "
            "GeneratorNoise)")

    def jitter(self, n_tasks: int, jitter: int) -> torch.Tensor:
        if self.jitter_table is None:
            raise ValueError(
                "ReplayNoise holds no jitter table; replay the reference's "
                "(convert.noise_table_from_numpy(..., jitter=...))")
        return self.jitter_table

    def faults(self, fcfg, n_slots: int, n_nodes: int):
        from repro_torch.faults.injection import FaultSchedule

        if (fcfg.crash_rate == fcfg.flap_rate == fcfg.surge_rate == 0
                and (fcfg.burst_slot < 0 or fcfg.burst_frac == 0)):
            # zero rates draw the identity schedule whatever the stream
            return FaultSchedule.none(n_slots, n_nodes,
                                      device=self.table.device)
        raise ValueError(
            "ReplayNoise samples no fault schedule; pass the reference's "
            "as simulate(..., fault_schedule=...) "
            "(convert.fault_schedule_from_numpy)")


def stack_runs(parts):
    """A list of B per-run tensors as one with a leading run axis: a view
    when B = 1 (no launch)."""
    if len(parts) == 1:
        return parts[0].unsqueeze(0)
    return torch.stack(parts)


class RunNoise:
    """The noise sources of B runs, drawn together.

    Each method returns the runs' draws with a leading run axis: run b's
    come from ``sources[b]``, which draws them in the order a single run
    of it would (demand then estimate, slot after slot; the jitter table
    and the fault schedule from streams of their own).
    """

    def __init__(self, sources: Sequence[NoiseSource]):
        self.sources = list(sources)

    def __len__(self) -> int:
        return len(self.sources)

    def demand(self, slot: int, n_tasks: int) -> torch.Tensor:
        """(B, n_tasks) f32."""
        return stack_runs([s.demand(slot, n_tasks) for s in self.sources])

    def estimate(self, slot: int, shape: Sequence[int]) -> torch.Tensor:
        """f32 of ``shape``, which leads with B: run b's draw of
        ``shape[1:]``."""
        return stack_runs([s.estimate(slot, tuple(shape[1:]))
                           for s in self.sources])

    def jitter(self, n_tasks: int, jitter: int) -> torch.Tensor:
        """(B, n_tasks) i32."""
        return stack_runs([s.jitter(n_tasks, jitter) for s in self.sources])

    def faults(self, fcfg, n_slots: int, n_nodes: int):
        """A FaultSchedule whose tables lead with B."""
        from repro_torch.faults.injection import stack_schedules
        return stack_schedules([s.faults(fcfg, n_slots, n_nodes)
                                for s in self.sources])
