"""``Experiment``: a workload x cluster x policy study.

Port of ``repro.api.experiment``.  The reference traces the simulator
once and ``vmap``s it over PRNG seeds and ``FlexParams`` sweep points;
the port runs every (sweep point, seed) pair as one simulation with a
leading run axis (``core.simulator.simulate_runs``): one slot loop, one
host sync a slot and one kernel launch a queue, decision or sweep for all
of them.  The leading axes are the reference's:

    exp = Experiment(trace, cluster, policy="flex-f", device="cuda")
    res = exp.run(seeds=range(10))                   # leaves: (10, S, ...)
    res = exp.run(seeds=[0, 1], sweep=[p1, p2, p3])  # leaves: (3, 2, S, ...)
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import simulator
from repro_torch.core.noise import GeneratorNoise, NoiseSource, RunNoise
from repro_torch.core.types import FlexParams, SimConfig, SimResult, TaskSet


def _unstack_params(sweep) -> list:
    """list[FlexParams] | FlexParams with a leading axis -> list."""
    if isinstance(sweep, FlexParams):
        return [FlexParams(*(leaf[i] for leaf in sweep))
                for i in range(sweep.qos_target.shape[0])]
    return list(sweep)


class Experiment:
    """A workload x cluster x policy study.

    ``noise(seed)`` builds the noise source of one run; it defaults to
    ``GeneratorNoise(seed, device)``.  Sweep points are taken verbatim:
    ``prepare_params`` pinning is not applied to them, as in the
    reference.  ``run`` simulates its P sweep points x S seeds as B = P S
    runs of one simulation; run (p, s) is bit for bit the run of sweep
    point p under ``noise(s)`` alone.  With ``use_kernel`` the sequential
    queue kernel admits the B runs' queues in one launch of B clusters;
    the card holds about 8 of them at once at the paper's 4000 nodes, and
    more run in waves inside that launch.
    """

    def __init__(self, trace: TaskSet, cluster: Optional[SimConfig] = None,
                 policy="flex-f", params: Optional[FlexParams] = None,
                 estimator=None, est_noise_std: float = 0.0,
                 controller=None, *, device="cuda",
                 noise: Optional[Callable[[int], NoiseSource]] = None):
        self.device = torch.device(device)
        self.trace = trace.to(self.device)
        self.cluster = cluster if cluster is not None else SimConfig()
        (self.policy, self.params, self.estimator,
         self.controller) = simulator._resolve(
            policy, params, estimator, "current", est_noise_std, controller,
            self.cluster, device=self.device)
        self.noise = noise or (lambda seed: GeneratorNoise(seed,
                                                           self.device))
        self._table = None

    @property
    def arrival_table(self) -> torch.Tensor:
        if self._table is None:
            table = simulator.build_arrival_table(
                self.trace.arrival.cpu().numpy(), self.cluster.n_slots,
                self.cluster.arrivals_per_slot)
            self._table = torch.from_numpy(table).to(self.device)
        return self._table

    def run(self, seeds=0, sweep=None) -> SimResult:
        """Simulate every (sweep point, seed), all in one simulation.

        seeds: an int (no seed axis) or a sequence of ints (a leading seed
        axis on every leaf).  sweep: an optional list of FlexParams, or a
        FlexParams with a leading axis; adds an outer sweep axis.
        """
        single_seed = not isinstance(seeds, (Sequence, range, np.ndarray,
                                             torch.Tensor))
        seed_list = [seeds] if single_seed else [int(s) for s in seeds]
        points = [self.params] if sweep is None else _unstack_params(sweep)
        pairs = [(p, s) for p in points for s in seed_list]
        params = FlexParams(*(
            torch.stack([p[i].to(self.device).reshape(()) for p, _ in pairs])
            for i in range(len(FlexParams._fields))))
        res = simulator.simulate_runs(
            self.trace, self.arrival_table, self.cluster, self.policy,
            params, RunNoise([self.noise(int(s)) for _, s in pairs]),
            self.estimator, self.controller)
        axes = (len(points), len(seed_list))
        res = simulator._index(
            res, lambda x: x.reshape(axes + tuple(x.shape[1:])))
        if single_seed:
            res = simulator._index(res, lambda x: x[:, 0])
        if sweep is None:
            res = simulator._index(res, lambda x: x[0])
        return res

    def summarize(self, qos_target: float = 0.99, **run_kw):
        """``analysis.summarize`` of one ``run()``."""
        from repro_torch.traces import analysis
        return analysis.summarize(self.trace, self.run(**run_kw), qos_target)
