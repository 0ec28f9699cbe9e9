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
from repro_torch.faults import FaultConfig
from repro_torch.guard import GuardConfig
from repro_torch.migration import MigrationConfig
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
    ("faults", FaultConfig(), "faults"),
    ("migration", MigrationConfig(), "migration"),
    ("guard", GuardConfig(), "guard"),
    ("retry_backoff", 2, "faults"),
    ("retry_jitter", 3, "faults"),
])
def test_later_slices_raise(trace, field, value, slice_name):
    """Every SimConfig field runs in the simulator now (migration without
    faults raises, as in the reference); the serving engine builds with
    its faults and guard, and its migration without faults raises there
    too."""
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    _, ts = trace
    cfg = SimConfig(**SMALL)._replace(**{field: value})
    if field == "migration":
        with pytest.raises(ValueError, match="requires fault injection"):
            run(ts, cfg, "flex-f", device="cpu")
    else:
        res = run(ts, cfg, "flex-f", device="cpu")
        assert res.placement.shape == (ts.num_tasks,)
    if field == slice_name == "migration":
        with pytest.raises(ValueError, match="migration requires"):
            ServeEngine(EngineConfig(**{field: value}), device="cpu")
    elif field == slice_name:
        eng = ServeEngine(EngineConfig(**{field: value}), device="cpu")
        assert getattr(eng.cfg, field) == value


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


# ---------------------------------------------------------------------------
# Headroom reclamation (simulator step 7) on the reference's reclaim_runs
# cluster: 60 nodes, 32 slots, 256 arrivals a slot, 64 retries.
# ---------------------------------------------------------------------------

RECLAIM = dict(n_nodes=60, n_slots=32, arrivals_per_slot=256,
               retry_capacity=64)
QUANTILE_RECL = dict(estimator="quantile", reclamation=True,
                     reclaim_pool=256)
# (name, config, use_kernel values): least-fit is the reference's bench
# policy; under flex-f the reclaim cap is tighter than primary admission's,
# so it reclaims only once the arrivals stop: the drain case runs 8 slots
# past the trace's last arrivals.
RECLAIM_CASES = {
    "least-fit-current": ("least-fit", dict(estimator="current"), (False,)),
    "least-fit-reclaim": ("least-fit", QUANTILE_RECL, (False,)),
    "flex-f-sequential": ("flex-f", QUANTILE_RECL, (False, True)),
    "flex-f-wavefront-topk8": ("flex-f", dict(
        QUANTILE_RECL, admission_mode="wavefront", wavefront_topk=8),
        (False, True)),
    "flex-f-wavefront-topk0": ("flex-f", dict(
        QUANTILE_RECL, admission_mode="wavefront", wavefront_topk=0),
        (False, True)),
    "flex-f-drain": ("flex-f", dict(QUANTILE_RECL, n_slots=40), (True,)),
}


@pytest.fixture(scope="module")
def reclaim_trace():
    jts = jax_generate(0, RECLAIM["n_nodes"], RECLAIM["n_slots"], 1.5)
    ts = taskset_from_numpy({k: np.asarray(v) for k, v in
                             jts._asdict().items()}, device="cpu")
    return jts, ts


def _reclaim_port_run(ts, name, use_kernel=False, **kw):
    cfg = SimConfig(**{**RECLAIM, **kw}, use_kernel=use_kernel)
    table = noise_table(0, cfg.n_slots, ts.num_tasks)
    return run(ts, cfg, name, device="cpu",
               noise=noise_table_from_numpy(table, device="cpu"))


@pytest.fixture(scope="module")
def reclaim_runs(reclaim_trace):
    """The port's runs of the reference's reclaim_runs fixture."""
    _, ts = reclaim_trace
    base = _reclaim_port_run(ts, "least-fit", estimator="current")
    recl = _reclaim_port_run(ts, "least-fit", **QUANTILE_RECL)
    return base, recl


@pytest.mark.parametrize("case", sorted(RECLAIM_CASES))
def test_reclamation_matches_reference(reclaim_trace, case):
    """Placements, admit slots, n_reclaimed and n_rejected exactly equal;
    the float sums within 1e-6."""
    jts, ts = reclaim_trace
    name, kw, kernel_modes = RECLAIM_CASES[case]
    hooked = name in HOOKED
    jcfg = JSimConfig(**{**RECLAIM, **kw}, use_kernel=hooked,
                      kernel_interpret=True)
    jres = jax_run(jts, jcfg, name)
    for use_kernel in kernel_modes:
        tres = _reclaim_port_run(ts, name, use_kernel, **kw)
        assert_result_matches(jres, tres)
    reclaimed = int(tres.metrics.n_reclaimed[-1])
    if case in ("least-fit-reclaim", "flex-f-drain"):
        assert reclaimed > 0
    if not kw.get("reclamation"):
        assert reclaimed == 0


def test_reclamation_admits_more_at_equal_qos(reclaim_runs):
    """The reference's acceptance bar: the quantile estimator with
    reclamation admits >= 1.2x the ``current`` baseline at no worse a
    QoS-violation fraction."""
    base, recl = reclaim_runs
    n_base = int((base.placement >= 0).sum())
    n_recl = int((recl.placement >= 0).sum())
    assert int(recl.metrics.n_reclaimed[-1]) > 0
    assert n_recl >= 1.2 * n_base
    viol_base = float((base.metrics.qos < 0.99).float().mean())
    viol_recl = float((recl.metrics.qos < 0.99).float().mean())
    assert viol_recl <= viol_base


def test_reclamation_respects_capacity(reclaim_runs):
    _, recl = reclaim_runs
    assert torch.isfinite(recl.metrics.usage).all()
    pl = recl.placement
    assert bool(((pl >= -1) & (pl < RECLAIM["n_nodes"])).all())


def test_reclamation_off_keeps_counter_zero(reclaim_runs):
    base, _ = reclaim_runs
    assert int(base.metrics.n_reclaimed[-1]) == 0


def test_no_second_admission_path():
    """The reclaim pass goes through the same ``admission.admit_queue``
    front end as primary admission, and never calls the wavefront
    directly."""
    import inspect

    from repro_torch.api import ReclaimPolicy, policy_supports_kernel
    from repro_torch.core import simulator

    assert policy_supports_kernel(ReclaimPolicy())
    src = inspect.getsource(simulator)
    assert "admit_queue_wavefront(" not in src
    assert src.count("admission.admit_queue(") >= 2


def test_reclaim_pass_runs_in_wavefront_rounds(reclaim_trace):
    """A sequential study's reclaim pass takes the wavefront path: its
    rounds and sweeps are the only ones counted."""
    from repro_torch.api import admission

    _, ts = reclaim_trace
    admission.reset_decisions()
    _reclaim_port_run(ts, "least-fit", **dict(QUANTILE_RECL, n_slots=12))
    assert admission.SWEEPS > 0 and admission.ROUNDS > 0
    admission.reset_decisions()
    _reclaim_port_run(ts, "least-fit", n_slots=12)
    assert admission.SWEEPS == admission.ROUNDS == 0


def test_quantile_estimates_match_reference_scan(reclaim_trace):
    """The quantile estimate inside the reference's jitted scan, node for
    node, bit for bit."""
    jts, ts = reclaim_trace
    kw = dict(estimator="quantile", record_node_usage=True, n_slots=16)
    jres = jax_run(jts, JSimConfig(**{**RECLAIM, **kw}), "flex-f")
    tres = _reclaim_port_run(ts, "flex-f", **kw)
    np.testing.assert_array_equal(tres.metrics.node_est.numpy(),
                                  np.asarray(jres.metrics.node_est))
    np.testing.assert_array_equal(tres.placement.numpy(),
                                  np.asarray(jres.placement))


def test_reclaim_kernel_inputs_equal_feasible_and_score():
    """The reclaim policy's kernel template (penalty, cap, weights) gives
    the feasibility and scores of its plain hooks."""
    from repro_torch.api import ReclaimPolicy
    from repro_torch.api.admission import PolicyContext, TaskView
    from repro_torch.core.numerics import fma
    from repro_torch.core.types import NodeState

    pol = ReclaimPolicy(margin_scale=0.1)
    gen = torch.Generator().manual_seed(0)
    u = lambda *shape: torch.rand(shape, generator=gen)
    tp = FlexParams.default(device="cpu")
    for penalty in (1.0, 1.7, 4.0, 12.0):
        node = NodeState(u(40, 2) * 0.5, u(40, 2) * 0.1, u(40, 2) * 0.9,
                         (u(40) * 8).to(torch.int32),
                         (u(40, 64) * 3).to(torch.int32))
        ctx = PolicyContext(node=node, penalty=torch.tensor(penalty),
                            params=tp)
        for k in range(8):
            task = TaskView(u(2) * 0.3, torch.tensor(k * 7 % 64,
                                                     dtype=torch.int32),
                            torch.tensor(k % 3, dtype=torch.int32))
            ki = pol.kernel_inputs(ctx, task)
            load = fma(ki.penalty, ki.est_usage, ki.reserved)
            feas = (load + task.request <= ki.cap).all(dim=-1)
            score = -fma(ki.w_load, load.max(dim=-1).values,
                         ki.w_src * ki.src_frac)
            want_feas = pol.feasible(ctx, task)
            assert torch.equal(feas, want_feas)
            assert torch.equal(score[feas], pol.score(ctx, task)[feas])


def test_reclaim_cap_rounds_as_the_jitted_reference():
    """``max(1 - m * P, 0)``: the jitted reference contracts it into one
    fused multiply-add, and so does the port, over a sweep of penalties
    and margins."""
    from repro.api import ReclaimPolicy as JReclaimPolicy
    from repro.api.admission import PolicyContext as JPolicyContext
    from repro_torch.api import ReclaimPolicy
    from repro_torch.api.admission import PolicyContext

    rng = np.random.default_rng(0)
    pens = np.concatenate([rng.uniform(0.5, 12.0, 4000),
                           np.linspace(1.0, 3.0, 2001),
                           [10.0, 11.0, 20.0]]).astype(np.float32)
    for margin in (0.1, 0.05, 0.3):
        jpol, tpol = JReclaimPolicy(margin_scale=margin), ReclaimPolicy(
            margin_scale=margin)
        want = np.asarray(jax.jit(jax.vmap(lambda p: jpol._cap(
            JPolicyContext(node=None, penalty=p, params=None))))(pens))
        got = tpol._cap(PolicyContext(node=None,
                                      penalty=torch.from_numpy(pens),
                                      params=None)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got == 0).any() and (got < 1).all()
