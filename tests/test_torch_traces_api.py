"""The last names of the already ported files against the JAX reference:
``traces.analysis.task_level``, ``traces.scale_demand`` and the legacy
stateless estimators of ``api.policies`` (``CurrentUsageEstimator``,
``EwmaEstimator``, ``ESTIMATORS``).

``task_level``'s means are sums over tasks, which XLA and PyTorch add in
different orders: rtol = atol = 1e-6, as the simulator's summaries.
``scale_demand`` is elementwise and must be bit-equal.  The legacy
estimators' refreshes must be bit-equal to the jitted reference's (the
noisy one fed the same normals on both sides), and a study that runs one
through ``StatelessAdapter`` must make the reference's decisions under
replayed noise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import policies as jpolicies
from repro.core import SimConfig as JSimConfig
from repro.core import run as jax_run
from repro.traces import analysis as j_analysis
from repro.traces import generate_calibrated as jax_generate
from repro.traces import scale_demand as j_scale_demand
from repro_torch import api
from repro_torch.api import policies
from repro_torch.convert import noise_table_from_numpy, taskset_from_numpy
from repro_torch.core import SimConfig, run
from repro_torch.estimators import StatelessAdapter, as_stateful
from repro_torch.traces import analysis, scale_demand

torch.set_num_threads(1)

SMALL = dict(n_nodes=16, n_slots=12, arrivals_per_slot=64, retry_capacity=32)


def _port_ts(jts):
    return taskset_from_numpy({k: np.asarray(v) for k, v in
                               jts._asdict().items()}, device="cpu")


@pytest.fixture(scope="module")
def trace():
    jts = jax_generate(0, SMALL["n_nodes"], SMALL["n_slots"], 1.6)
    return jts, _port_ts(jts)


# ---------------------------------------------------------------- traces

@pytest.mark.parametrize("seed,n_nodes", [(0, 16), (1, 60), (2, 200)])
def test_task_level_matches_reference(seed, n_nodes):
    jts = jax_generate(seed, n_nodes, 12, 1.6)
    want = j_analysis.task_level(jts)
    got = analysis.task_level(_port_ts(jts))
    assert list(got) == list(want)
    for key, w in want.items():
        assert type(got[key]) is float, key
        np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_task_level_empty_class_divides_by_one(trace):
    jts, ts = trace
    prio = np.zeros(ts.num_tasks, np.int32)          # every task batch
    jts1 = jts._replace(priority=jnp.asarray(prio))
    ts1 = ts._replace(priority=torch.from_numpy(prio))
    got, want = analysis.task_level(ts1), j_analysis.task_level(jts1)
    assert got["system_mean_ratio_cpu"] == want["system_mean_ratio_cpu"] == 0
    np.testing.assert_allclose(got["batch_mean_ratio_mem"],
                               want["batch_mean_ratio_mem"], rtol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 1.0, 1.37, 3.0])
def test_scale_demand_bit_equal(trace, scale):
    jts, ts = trace
    got, want = scale_demand(ts, scale), j_scale_demand(jts, scale)
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # requests stay, the peaks clip at 1
    assert got.request is ts.request
    assert float(got.peak_usage.max()) <= 1.0


# ---------------------------------------------------------------- estimators

def test_legacy_names_exported():
    assert api.CurrentUsageEstimator is policies.CurrentUsageEstimator
    assert api.EwmaEstimator is policies.EwmaEstimator
    assert list(policies.ESTIMATORS) == list(jpolicies.ESTIMATORS)
    for name, cls in policies.ESTIMATORS.items():
        jcls = jpolicies.ESTIMATORS[name]
        assert cls.__name__ == jcls.__name__
        assert ([f.name for f in dataclasses.fields(cls)]
                == [f.name for f in dataclasses.fields(jcls)])
        assert cls() == cls()          # frozen and hashable
        hash(cls())
    assert japi.CurrentUsageEstimator is jpolicies.CurrentUsageEstimator


def _usage_seq(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n_steps, 40, 2)).astype(np.float32)


@pytest.mark.parametrize("port,ref", [
    (policies.CurrentUsageEstimator(), jpolicies.CurrentUsageEstimator()),
    (policies.CurrentUsageEstimator(noise_std=0.3),
     jpolicies.CurrentUsageEstimator(noise_std=0.3)),
    (policies.EwmaEstimator(), jpolicies.EwmaEstimator()),
    (policies.EwmaEstimator(decay=0.25), jpolicies.EwmaEstimator(decay=0.25)),
])
def test_legacy_refresh_bit_equal(port, ref, monkeypatch):
    """Each reference refresh jitted.  Both sides get the same standard
    normals: the port's ``draw`` serves them, and the reference's
    ``jax.random.normal`` is made to return its key argument, through
    which they enter the jitted refresh as an input (drawn inside the
    fused refresh, XLA's normals themselves round otherwise than drawn
    alone, and the port never replays a noisy estimator's stream)."""
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: key)
    seq = _usage_seq(8, seed=5)
    refresh = jax.jit(ref.refresh)
    rng = np.random.default_rng(9)
    j_est = jnp.zeros(seq.shape[1:], jnp.float32)
    t_est = torch.zeros(seq.shape[1:])
    for t in range(seq.shape[0]):
        normals = rng.standard_normal(seq.shape[1:]).astype(np.float32)
        j_est = refresh(j_est, jnp.asarray(seq[t]), jnp.asarray(normals))
        t_est = port.refresh(t_est, torch.from_numpy(seq[t]),
                             lambda shape: torch.from_numpy(normals))
        np.testing.assert_array_equal(t_est.numpy(), np.asarray(j_est))


def _noise_table(seed, n_slots, n_tasks):
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, s), (n_tasks,), jnp.float32))
        for s in range(n_slots)])


@pytest.mark.parametrize("policy", ["flex-f", "least-fit"])
def test_legacy_ewma_study_matches_reference(trace, policy):
    """A study with the legacy ``EwmaEstimator(0.4)``: adapted by
    ``StatelessAdapter`` in the port as the reference adapts it, the
    placements, admit slots and per-slot estimates equal the reference's
    under replayed demand noise."""
    jts, ts = trace
    assert isinstance(as_stateful(policies.EwmaEstimator(0.4)),
                      StatelessAdapter)
    jres = jax_run(jts, JSimConfig(**SMALL, record_node_usage=True), policy,
                   estimator=jpolicies.EwmaEstimator(0.4))
    table = _noise_table(0, SMALL["n_slots"], ts.num_tasks)
    tres = run(ts, SimConfig(**SMALL, record_node_usage=True), policy,
               device="cpu", estimator=policies.EwmaEstimator(0.4),
               noise=noise_table_from_numpy(table, device="cpu"))
    for name in ("placement", "admit_slot"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)))
    for name in ("node_est", "n_running", "n_rejected"):
        np.testing.assert_array_equal(
            getattr(tres.metrics, name).numpy(),
            np.asarray(getattr(jres.metrics, name)), err_msg=name)
