"""The estimator-drift watchdog and its breaker: the port against the JAX
reference (``tests/test_guard.py``'s simulator cases; the engine's guard
is held in ``tests/test_torch_engine_faults.py``).

The watchdog's functions are held bit for bit against the jitted
reference: the drift sample adds over the nodes in XLA's order
(``numerics.xla_sum``), the trip statistic is ``jnp.quantile``'s rounding
(``window_quantile``), the confidence multiplies by the threshold's
rounded reciprocal, and ``1 + g * conf`` and the safe-mode blend are
fused multiply-adds, as XLA compiles them.  So the breaker's states equal
the reference's with no margin to state.  Whole runs replay the
reference's noise: a demand ramp that trips the breaker at 8 nodes (the
reference's case), and least-fit with the quantile estimator and
reclamation at 64 nodes, where the breaker suspends and trickles a pool
that reclaims.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimConfig as JSimConfig
from repro.faults import FaultConfig as JFaultConfig
from repro.faults import injection as j_inject
from repro.guard import GuardConfig as JGuardConfig
from repro.guard import watchdog as j_wd
from repro.traces import analysis as j_analysis
from repro.traces import generate_calibrated as jax_generate
from repro_torch.core import SimConfig, run
from repro_torch.faults import FaultConfig
from repro_torch.guard import (CLOSED, HALF_OPEN, OPEN, GuardConfig,
                               breaker_step, push_errors, reclaim_width,
                               trip_statistic)
from repro_torch.guard import watchdog as wd
from repro_torch.migration import MigrationConfig
from repro_torch.traces import analysis
from test_torch_faults import (FULL_BASE, FULL_N, FULL_S, assert_same,
                               assert_same_decisions, both_runs,
                               jax_taskset, port_only, port_taskset)

torch.set_num_threads(1)

# The reference's inert guard: never trips, never tightens a cap.
INERT = GuardConfig(trip_threshold=1e9, guard_scale=0.0)
CONFIGS = [GuardConfig(), GuardConfig(trip_threshold=0.05, guard_scale=2.5,
                                      open_blend=0.3),
           GuardConfig(trip_threshold=0.3, guard_scale=0.7, open_blend=0.5)]


def _jcfg(gcfg):
    return JGuardConfig(*gcfg)


# ---------------------------------------------------------------------------
# functions, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 33, 64, 250, 4000, 4097])
def test_drift_sample_matches_reference(n):
    rng = np.random.default_rng(n)
    f = jax.jit(j_wd.drift_sample)
    for _ in range(10):
        est = rng.uniform(0, 1, (n, 2)).astype(np.float32)
        usage = (rng.uniform(0, 1, (n, 2)) * rng.uniform(0, 2)).astype(
            np.float32)
        got = wd.drift_sample(torch.from_numpy(est), torch.from_numpy(usage))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(f(est, usage)))


@pytest.mark.parametrize("window,q", [(16, 0.9), (6, 0.9), (4, 0.5),
                                      (7, 0.75), (1, 0.9)])
def test_window_and_trip_statistic_match_reference(window, q):
    rng = np.random.default_rng(window)
    win = wd.init_window(window, 2, device="cpu")
    jwin = j_wd.init_window(window, 2)
    stat = jax.jit(lambda w: j_wd.trip_statistic(w, q))
    for _ in range(3 * window):
        err = rng.uniform(0, 0.5, 2).astype(np.float32)
        win = push_errors(win, torch.from_numpy(err))
        jwin = j_wd.push_errors(jwin, jnp.asarray(err))
        np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
        np.testing.assert_array_equal(trip_statistic(win, q).numpy(),
                                      np.asarray(stat(jwin)))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_confidence_and_penalty_scale_match_reference(cfg):
    rng = np.random.default_rng(0)
    thr = cfg.trip_threshold
    e = np.concatenate([rng.uniform(0, 2 * thr, 20000),
                        np.linspace(0, 2 * thr, 4001)]).astype(np.float32)
    p = rng.uniform(1, 16, e.size).astype(np.float32)
    jc = _jcfg(cfg)
    want_c = jax.jit(jax.vmap(lambda x: j_wd.confidence(x, jc)))(e)
    want_p = jax.jit(jax.vmap(
        lambda pen, x: pen * j_wd.penalty_scale(x, jc)))(p, e)
    te = torch.from_numpy(e)
    np.testing.assert_array_equal(wd.confidence(te, cfg).numpy(),
                                  np.asarray(want_c))
    np.testing.assert_array_equal(
        (torch.from_numpy(p) * wd.penalty_scale(te, cfg)).numpy(),
        np.asarray(want_p))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_blend_estimate_matches_reference(cfg):
    rng = np.random.default_rng(1)
    est = rng.uniform(0, 1, (3000, 2)).astype(np.float32)
    req = rng.uniform(0, 1.5, (3000, 2)).astype(np.float32)
    for is_open in (False, True):
        want = jax.jit(lambda a, b: j_wd.blend_estimate(
            a, b, jnp.asarray(is_open), _jcfg(cfg)))(est, req)
        got = wd.blend_estimate(torch.from_numpy(est), torch.from_numpy(req),
                                torch.tensor(is_open), cfg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_breaker_step_matches_reference():
    rng = np.random.default_rng(2)
    cfg = GuardConfig(trip_threshold=0.1, cooldown=3, probe_slots=2)
    step = jax.jit(lambda s, t, e: j_wd.breaker_step(s, t, e, _jcfg(cfg)))
    for state in (CLOSED, OPEN, HALF_OPEN):
        for timer in range(0, 5):
            for e in (0.0, 0.05, 0.1, np.float32(0.1) * (1 + 2 ** -23),
                      rng.uniform(0, 0.3)):
                e = np.float32(e)
                got = breaker_step(torch.tensor(state, dtype=torch.int32),
                                   torch.tensor(timer, dtype=torch.int32),
                                   torch.tensor(e), cfg)
                want = step(jnp.int32(state), jnp.int32(timer), e)
                assert [int(x) for x in got] == [int(x) for x in want]


def test_reclaim_width_matches_reference():
    for cfg in (GuardConfig(probe_reclaim=3), GuardConfig(probe_reclaim=8)):
        for width in (0, 2, 16):
            for state in (CLOSED, OPEN, HALF_OPEN):
                assert reclaim_width(state, width, cfg) == int(
                    j_wd.reclaim_width(jnp.int32(state), width, _jcfg(cfg)))


def test_drift_window_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    W, R, steps, q = 7, 2, 25, 0.9
    errs = rng.uniform(0.0, 0.5, size=(steps, R)).astype(np.float32)
    win = wd.init_window(W, R, device="cpu")
    for t in range(steps):
        win = push_errors(win, torch.from_numpy(errs[t]))
        hist = np.zeros((W, R), np.float32)
        take = errs[max(0, t - W + 1):t + 1][::-1]
        hist[:len(take)] = take
        oracle = float(np.max(np.quantile(hist, q, axis=0)))
        assert float(trip_statistic(win, q)) == pytest.approx(oracle,
                                                              abs=1e-6)
        np.testing.assert_array_equal(win[0].numpy(), errs[t])


def _step_seq(cfg, errs, state=CLOSED, timer=0):
    states = []
    state, timer = torch.tensor(state), torch.tensor(timer)
    for e in errs:
        state, timer, _ = breaker_step(state, timer, torch.tensor(e), cfg)
        states.append(int(state))
    return states, int(state), int(timer)


def test_breaker_trajectories():
    hi, lo = 0.5, 0.01
    cfg = GuardConfig(trip_threshold=0.1, cooldown=3, probe_slots=2)
    states, *_ = _step_seq(cfg, [lo, hi, lo, lo, lo, lo, lo, lo, lo])
    assert states == [CLOSED, OPEN, OPEN, OPEN, HALF_OPEN, HALF_OPEN,
                      CLOSED, CLOSED, CLOSED]
    cfg = GuardConfig(trip_threshold=0.1, cooldown=3, probe_slots=4)
    states, _, timer = _step_seq(cfg, [hi, lo, lo, lo, hi])
    assert states == [OPEN, OPEN, OPEN, HALF_OPEN, OPEN]
    assert timer == cfg.cooldown
    cfg = GuardConfig(trip_threshold=0.1, cooldown=2, probe_slots=2)
    assert _step_seq(cfg, [0.5] * 6)[0] == [OPEN] * 6


@pytest.mark.parametrize("kwargs", [
    dict(window=0), dict(window=-3), dict(err_quantile=1.5),
    dict(err_quantile=-0.1), dict(trip_threshold=0.0),
    dict(trip_threshold=-1.0), dict(cooldown=0), dict(probe_slots=-1),
    dict(probe_reclaim=-1), dict(open_blend=2.0), dict(guard_scale=-0.5),
])
def test_guardconfig_rejects_degenerate(kwargs):
    with pytest.raises(ValueError):
        GuardConfig(**kwargs)
    with pytest.raises(ValueError):
        GuardConfig()._replace(**kwargs)


def test_guardconfig_fields_match_reference():
    assert GuardConfig._fields == JGuardConfig._fields
    assert tuple(GuardConfig()) == tuple(JGuardConfig())
    assert SimConfig().guard is None


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_sim_inert_guard_bit_identical(mode):
    jts = jax_generate(0, 8, 24, 1.4)
    base = SimConfig(n_nodes=8, n_slots=24, arrivals_per_slot=64,
                     retry_capacity=32, admission_mode=mode,
                     reclamation=True, reclaim_pool=64, estimator="ewma")
    assert_same_decisions(port_only(jts, base),
                          port_only(jts, base._replace(guard=INERT)))


def test_sim_inert_guard_bit_identical_with_faults_and_migration():
    jts = jax_generate(1, 8, 24, 1.4)
    ts = port_taskset(jts)
    base = SimConfig(n_nodes=8, n_slots=24, arrivals_per_slot=64,
                     retry_capacity=32, reclamation=True, reclaim_pool=64,
                     estimator="ewma",
                     faults=FaultConfig(crash_rate=0.01, warn_slots=2),
                     migration=MigrationConfig(bandwidth=8, pool_size=32))
    res = [run(ts, cfg, "flex-f", device="cpu", seed=2)
           for cfg in (base, base._replace(guard=INERT))]
    assert_same_decisions(*res)
    assert int(res[0].metrics.n_fault_evicted[-1]) > 0


def test_guard_metrics_empty_when_off():
    ts = port_taskset(jax_taskset([0, 1], [0.3, 0.3]))
    res = run(ts, SimConfig(n_nodes=2, n_slots=8, arrivals_per_slot=4,
                            retry_capacity=4), "flex-f", device="cpu")
    for name in ("guard_tripped", "n_guard_deferred", "guard_err_q"):
        assert getattr(res.metrics, name).shape == (8, 0)
    with pytest.raises(ValueError, match="guard"):
        analysis.guard_report(res)


def test_breaker_never_trips_under_exact_estimator():
    ts = port_taskset(jax_taskset([0, 0, 0, 0], [0.3] * 4, duration=100,
                                  mean_frac=0.2))
    cfg = SimConfig(n_nodes=4, n_slots=32, arrivals_per_slot=8,
                    retry_capacity=8, reclamation=True, reclaim_pool=16,
                    estimator="current", guard=GuardConfig())
    res = run(ts, cfg, "flex-f", device="cpu")
    assert (res.metrics.guard_tripped == CLOSED).all()
    assert int(res.metrics.n_guard_deferred[-1]) == 0


def test_summarize_warns_without_guard_and_reports_with_it():
    ts = port_taskset(jax_generate(4, 4, 16, 1.2))
    cfg = SimConfig(n_nodes=4, n_slots=16, arrivals_per_slot=32,
                    retry_capacity=16)
    res = run(ts, cfg, "flex-f", device="cpu")
    with pytest.warns(UserWarning, match="guard=GuardConfig"):
        out = analysis.summarize(ts, res, qos_target=0.99)
    assert "guard_trips" not in out and "qos_mean" in out
    res = run(ts, cfg._replace(guard=GuardConfig()), "flex-f", device="cpu")
    with pytest.warns(UserWarning) as caught:
        out = analysis.summarize(ts, res, qos_target=0.99)
    assert not any("guard" in str(w.message) for w in caught)
    for k in ("guard_trips", "open_frac", "half_open_frac",
              "n_guard_deferred", "err_q_max", "err_q_mean"):
        assert k in out, k


def test_surge_trips_breaker_and_suspends_reclaim():
    """The reference's case: a demand ramp trips the breaker, which defers
    the reclaim pool; breaker states, deferrals and decisions equal the
    reference's, and so does guard_report."""
    jts = jax_generate(3, 8, 48, 1.6)
    jcfg = JSimConfig(n_nodes=8, n_slots=48, arrivals_per_slot=64,
                      retry_capacity=32, reclamation=True, reclaim_pool=64,
                      estimator="ewma", faults=JFaultConfig(),
                      guard=JGuardConfig(window=6, trip_threshold=0.05,
                                         cooldown=8, probe_slots=4))
    sched = j_inject.usage_surge(48, 8, start=12, ramp=8, hold=8,
                                 peak_mult=3.0)
    jres, (tres,) = both_runs(jts, jcfg, "flex-f", sched=sched)
    assert_same(jres, tres)
    states = tres.metrics.guard_tripped
    assert (states == OPEN).any() and int(states[0]) == CLOSED
    rep = analysis.guard_report(tres)
    want = j_analysis.guard_report(jres)
    assert set(rep) == set(want)
    for k, v in want.items():
        assert rep[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
    assert rep["guard_trips"] >= 1 and rep["open_frac"] > 0
    assert rep["err_q_max"] > 0.05
    assert int(tres.metrics.n_guard_deferred[-1]) > 0


@pytest.fixture(scope="module")
def guard_trace():
    return jax_generate(0, FULL_N, FULL_S, 1.5)


@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_guarded_reclamation_matches_reference(guard_trace, mode):
    """least-fit with the quantile estimator and reclamation under a
    demand ramp at 64 nodes: the pool reclaims while CLOSED, is held back
    while OPEN and trickles while HALF_OPEN, as in the reference."""
    jcfg = JSimConfig(**FULL_BASE, estimator="quantile", reclamation=True,
                      reclaim_pool=256, faults=JFaultConfig(),
                      guard=JGuardConfig(window=4, trip_threshold=0.2,
                                         cooldown=3, probe_slots=3,
                                         probe_reclaim=4, guard_scale=0.5))
    sched = j_inject.usage_surge(FULL_S, FULL_N, start=14, ramp=3, hold=2,
                                 peak_mult=2.5)
    jres, truns = both_runs(guard_trace, jcfg, "least-fit", sched=sched,
                            cache="guarded", admission_mode=mode)
    assert_same(jres, truns[0])
    m = truns[0].metrics
    states = set(m.guard_tripped.tolist())
    assert {CLOSED, OPEN} <= states, states
    assert int(m.n_reclaimed[-1]) > 0 and int(m.n_guard_deferred[-1]) > 0
