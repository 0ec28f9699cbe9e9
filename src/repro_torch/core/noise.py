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
demand stream alone: an estimator that draws noise raises under it.
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


class GeneratorNoise:
    """Standard normals from a seeded ``torch.Generator``.

    Draws are sequential, so a source serves one run: make a new one (same
    seed) to repeat a run.
    """

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen,
                           dtype=torch.float32, device=self.device)

    def demand(self, slot: int, n_tasks: int) -> torch.Tensor:
        return self._normal((n_tasks,))

    def estimate(self, slot: int, shape: Sequence[int]) -> torch.Tensor:
        return self._normal(shape)


class ReplayNoise:
    """Serves row ``slot`` of an ``(S, T)`` float32 table of demand noise."""

    def __init__(self, table: torch.Tensor):
        if table.dim() != 2 or table.dtype != torch.float32:
            raise ValueError(
                f"ReplayNoise needs an (S, T) float32 table, got "
                f"{tuple(table.shape)} {table.dtype}")
        self.table = table

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
