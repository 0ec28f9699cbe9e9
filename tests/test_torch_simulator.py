"""The slice as a whole: the port's simulator against the JAX reference.

A small cluster (N=16 nodes, S=12 slots, A=64 arrivals, Qr=32 retries)
under each of the six ported policies.  Both sides see the same demand
noise: the table the reference's key schedule draws
(``normal(fold_in(key, slot), (T,))``), replayed into the port.  The JAX
side runs hooked policies through its interpret-mode Pallas kernel.

Decisions (placement, admit slot, QoS and activity counters, rejections)
must be exactly equal, and so must the per-slot QoS, penalty and counts.
The per-slot float sums (usage, requested, their std and mean, the
estimate) and the ``summarize`` floats agree to rtol = atol = 1e-6: XLA
and PyTorch reduce those sums over nodes and slots in different orders.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Experiment as JExperiment
from repro.core import SimConfig as JSimConfig
from repro.core import run as jax_run
from repro.core.types import FlexParams as JFlexParams
from repro.traces import analysis as j_analysis
from repro.traces import generate_calibrated as jax_generate
from repro_torch.api import Experiment
from repro_torch.convert import noise_table_from_numpy, taskset_from_numpy
from repro_torch.core import SimConfig, run
from repro_torch.core.types import FlexParams
from repro_torch.traces import analysis

SMALL = dict(n_nodes=16, n_slots=12, arrivals_per_slot=64, retry_capacity=32)
HOOKED = ["flex-f", "flex-l", "best-fit-usage", "flex-priority"]
PLAIN = ["least-fit", "oversub"]
EXACT = ["placement", "admit_slot", "qos_ok_slots", "active_slots"]
EXACT_METRICS = ["qos", "penalty", "n_running", "n_rejected", "n_reclaimed",
                 "n_fault_evicted", "n_degrade_evicted", "degraded",
                 "n_migrated", "n_migration_failed", "node_usage",
                 "node_est", "node_requested", "guard_tripped",
                 "n_guard_deferred", "guard_err_q"]
SUMMED_METRICS = ["usage", "requested", "usage_std", "usage_mean",
                  "est_usage"]

# The tensors here are tiny: one intra-op thread is fastest, and keeps
# PyTorch's pool from contending with XLA's in the same process.
torch.set_num_threads(1)


def noise_table(seed, n_slots, n_tasks):
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, s), (n_tasks,), jnp.float32))
        for s in range(n_slots)])


@pytest.fixture(scope="module")
def trace():
    jts = jax_generate(0, SMALL["n_nodes"], SMALL["n_slots"], 1.6)
    ts = taskset_from_numpy({k: np.asarray(v) for k, v in
                             jts._asdict().items()}, device="cpu")
    return jts, ts


def _port_run(ts, name, use_kernel, seed=0, **cfg_kw):
    table = noise_table(seed, SMALL["n_slots"], ts.num_tasks)
    cfg = SimConfig(**SMALL, use_kernel=use_kernel, **cfg_kw)
    return run(ts, cfg, name, seed=seed, device="cpu",
               noise=noise_table_from_numpy(table, device="cpu"))


def _summaries(jts, ts, jres, tres):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (j_analysis.summarize(jts, jres, 0.99),
                analysis.summarize(ts, tres, 0.99))


def assert_result_matches(jres, tres):
    for name in EXACT:
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    for name in EXACT_METRICS:
        got = getattr(tres.metrics, name).numpy()
        want = np.asarray(getattr(jres.metrics, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in SUMMED_METRICS:
        got = getattr(tres.metrics, name).numpy()
        want = np.asarray(getattr(jres.metrics, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def assert_summary_matches(js, ts_):
    assert set(js) == set(ts_)
    for key, want in js.items():
        got = ts_[key]
        assert type(got) is type(want), key
        if isinstance(want, int):
            assert got == want, key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("name", HOOKED + PLAIN)
def test_simulator_matches_reference(trace, name):
    jts, ts = trace
    hooked = name in HOOKED
    jcfg = JSimConfig(**SMALL, use_kernel=hooked, kernel_interpret=hooked)
    jres = jax_run(jts, jcfg, name)
    for use_kernel in ((False, True) if hooked else (False,)):
        tres = _port_run(ts, name, use_kernel)
        assert_result_matches(jres, tres)
        assert_summary_matches(*_summaries(jts, ts, jres, tres))
    assert int((tres.placement >= 0).sum()) > 0
    assert int(tres.metrics.n_rejected[-1]) > 0   # the run is contended


def test_reference_only_policy_ignores_use_kernel(trace):
    _, ts = trace
    a = _port_run(ts, "least-fit", use_kernel=False)
    b = _port_run(ts, "least-fit", use_kernel=True)
    assert torch.equal(a.placement, b.placement)


def test_recorded_node_series_match(trace):
    jts, ts = trace
    jcfg = JSimConfig(**SMALL, record_node_usage=True)
    jres = jax_run(jts, jcfg, "flex-f")
    tres = _port_run(ts, "flex-f", False, record_node_usage=True)
    n, s = SMALL["n_nodes"], SMALL["n_slots"]
    assert tres.metrics.node_usage.shape == (s, n, 2)
    assert_result_matches(jres, tres)
    js, ts_ = _summaries(jts, ts, jres, tres)
    assert "usage_to_cap_cpu_p50" in ts_ and "zombie_frac_mem" in ts_
    assert_summary_matches(js, ts_)


def test_summarize_warns_where_reference_warns(trace):
    jts, ts = trace
    tres = _port_run(ts, "least-fit", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        analysis.summarize(ts, tres, 0.99)
    messages = [str(w.message) for w in caught]
    assert any("machine-level" in m for m in messages)
    assert any("guard" in m for m in messages)


def test_experiment_seeds_and_sweep_axes(trace):
    jts, ts = trace
    seeds = [0, 1]
    jsweep = [JFlexParams.default(), JFlexParams.default(alpha=0.95,
                                                         w_src=0.5)]
    jres = JExperiment(jts, JSimConfig(**SMALL), "flex-f").run(
        seeds=seeds, sweep=jsweep)
    tables = {s: noise_table(s, SMALL["n_slots"], ts.num_tasks)
              for s in seeds}
    exp = Experiment(ts, SimConfig(**SMALL), "flex-f", device="cpu",
                     noise=lambda s: noise_table_from_numpy(tables[s],
                                                            device="cpu"))
    sweep = [FlexParams.default(device="cpu"),
             FlexParams.default(alpha=0.95, w_src=0.5, device="cpu")]
    tres = exp.run(seeds=seeds, sweep=sweep)
    assert tres.placement.shape == (2, 2, ts.num_tasks)
    assert tres.metrics.usage.shape == (2, 2, SMALL["n_slots"], 2)
    for name in EXACT:
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tres.metrics.penalty.numpy(),
                                  np.asarray(jres.metrics.penalty))
    np.testing.assert_allclose(tres.metrics.usage.numpy(),
                               np.asarray(jres.metrics.usage),
                               rtol=1e-6, atol=1e-6)
    # a stacked sweep gives the same rows as a list of points
    stacked = FlexParams(*(torch.stack(leaves) for leaves in zip(*sweep)))
    again = exp.run(seeds=seeds, sweep=stacked)
    assert torch.equal(again.placement, tres.placement)
    single = exp.run(seeds=1)
    assert torch.equal(single.placement, tres.placement[0, 1])


@pytest.mark.parametrize("field,value,slice_name", [
    ("faults", object(), "faults"),
    ("migration", object(), "migration"),
    ("guard", object(), "guard"),
    ("reclamation", True, "reclamation"),
    ("retry_backoff", 2, "faults"),
    ("retry_jitter", 3, "faults"),
])
def test_later_slices_raise(trace, field, value, slice_name):
    _, ts = trace
    cfg = SimConfig(**SMALL)._replace(**{field: value})
    with pytest.raises(NotImplementedError, match=slice_name):
        run(ts, cfg, "flex-f", device="cpu")


def test_wavefront_mode_runs(trace):
    _, ts = trace
    seq = _port_run(ts, "flex-f", False)
    wav = _port_run(ts, "flex-f", False, admission_mode="wavefront")
    for name in ("placement", "admit_slot", "qos_ok_slots"):
        assert torch.equal(getattr(wav, name), getattr(seq, name)), name
    assert torch.equal(wav.metrics.n_rejected, seq.metrics.n_rejected)


def test_unknown_admission_mode_raises(trace):
    _, ts = trace
    with pytest.raises(ValueError, match="admission_mode"):
        run(ts, SimConfig(**SMALL, admission_mode="batched"), "flex-f",
            device="cpu")


def test_generator_noise_runs_are_repeatable(trace):
    _, ts = trace
    cfg = SimConfig(**SMALL)
    a = run(ts, cfg, "flex-f", seed=3, device="cpu")
    b = run(ts, cfg, "flex-f", seed=3, device="cpu")
    assert torch.equal(a.placement, b.placement)
    assert a.metrics.usage.dtype == torch.float32
    assert a.placement.dtype == torch.int32


def test_noisy_estimator_under_replay_raises(trace):
    _, ts = trace
    with pytest.raises(ValueError, match="noisy estimator"):
        _port_run(ts, "flex-f", False)  # noise-free: runs
        table = noise_table(0, SMALL["n_slots"], ts.num_tasks)
        run(ts, SimConfig(**SMALL), "flex-f", device="cpu",
            noise=noise_table_from_numpy(table, device="cpu"),
            est_noise_std=0.1)
