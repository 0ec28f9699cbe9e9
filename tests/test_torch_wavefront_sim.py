"""The port's simulator in wavefront mode against the JAX reference.

``SimConfig(admission_mode="wavefront")`` runs of the four kernel-hooked
policies at the small configuration of ``tests/test_torch_simulator.py``
(S=12 slots, A=64 arrivals, Qr=32 retries) and N in {5, 100, 513} nodes,
both sides under the same replayed demand noise, compared exactly as that
file compares sequential runs: decisions, QoS and rejection counters
exactly, per-slot float sums and ``summarize`` floats to rtol = atol =
1e-6.  The JAX side takes its batched reference einsums.
"""
import numpy as np
import pytest
import torch

from repro.core import SimConfig as JSimConfig
from repro.core import run as jax_run
from repro.traces import generate_calibrated as jax_generate
from repro_torch.convert import noise_table_from_numpy, taskset_from_numpy
from repro_torch.core import SimConfig, run
from test_torch_simulator import (SMALL, _summaries, assert_result_matches,
                                  assert_summary_matches, noise_table)

HOOKED = ["flex-f", "flex-l", "best-fit-usage", "flex-priority"]

# The tensors here are tiny: one intra-op thread is fastest, and keeps
# PyTorch's pool from contending with XLA's in the same process.
torch.set_num_threads(1)


def _runs(name, n, **cfg_kw):
    small = dict(SMALL, n_nodes=n)
    jts = jax_generate(0, n, small["n_slots"], 1.6)
    ts = taskset_from_numpy({k: np.asarray(v) for k, v in
                             jts._asdict().items()}, device="cpu")
    jres = jax_run(jts, JSimConfig(**small, **cfg_kw), name)
    table = noise_table(0, small["n_slots"], ts.num_tasks)
    tres = run(ts, SimConfig(**small, **cfg_kw), name, device="cpu",
               noise=noise_table_from_numpy(table, device="cpu"))
    return jts, ts, jres, tres


@pytest.mark.parametrize("n", [5, 100, 513])
@pytest.mark.parametrize("name", HOOKED)
def test_wavefront_simulator_matches_reference(name, n):
    jts, ts, jres, tres = _runs(name, n, admission_mode="wavefront")
    assert_result_matches(jres, tres)
    assert_summary_matches(*_summaries(jts, ts, jres, tres))
    assert int((tres.placement >= 0).sum()) > 0


def test_wavefront_knobs_reach_the_simulator():
    # the legacy loop, dedup off and a wide tie margin move rounds and
    # sweeps, never decisions
    from repro_torch.api import admission
    _, ts, jres, _ = _runs("flex-f", 100)
    for knobs in (dict(wavefront_topk=0),
                  dict(wavefront_topk=4, dedup_buckets=0),
                  dict(wavefront_tie_margin=1e-2)):
        admission.reset_decisions()
        table = noise_table(0, SMALL["n_slots"], ts.num_tasks)
        tres = run(ts, SimConfig(**dict(SMALL, n_nodes=100),
                                 admission_mode="wavefront", **knobs),
                   "flex-f", device="cpu",
                   noise=noise_table_from_numpy(table, device="cpu"))
        assert_result_matches(jres, tres)
        assert admission.SWEEPS > 0
        if knobs.get("wavefront_topk") == 0:
            assert admission.SWEEPS == admission.ROUNDS


def test_least_fit_wavefront_falls_back_to_the_scan():
    from repro_torch.api import admission
    admission.reset_decisions()
    jts, ts, jres, tres = _runs("least-fit", 100, admission_mode="wavefront")
    assert_result_matches(jres, tres)
    assert admission.DECISIONS > 0 and admission.SWEEPS == 0
