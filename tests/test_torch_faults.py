"""Fault injection and graceful degradation: the port against the JAX
reference (``tests/test_faults.py``'s simulator cases, and the functions
of ``faults/`` and the admission offsets bit for bit).

Whole runs replay the reference's demand noise, its fault schedule (its
sampled one too, through ``convert.fault_schedule_from_numpy``) and its
retry-jitter table.  Placements, admit slots and every integer counter
must be exactly equal, and so must the per-slot QoS, penalty and breaker
series; the float sums agree to rtol = atol = 1e-6, except ``requested``
under a crash, where the reference's sum cancels catastrophically and
the port's is repaired (pinned below).  The full-stack cases run faults,
degradation, migration, the guard, reclamation, retry backoff and jitter
together at 64 nodes, for flex-f, least-fit and flex-brownout in both
admission modes, the port with ``use_kernel`` both ways (on the CPU the
kernels' plain versions).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import admission as j_admission
from repro.core import SimConfig as JSimConfig
from repro.core import run as jax_run
from repro.core.simulator import _FAULT_STREAM, _JITTER_STREAM
from repro.core.types import TaskSet as JTaskSet
from repro.faults import FaultConfig as JFaultConfig
from repro.faults import FaultSchedule as JFaultSchedule
from repro.faults import degrade as j_degrade
from repro.faults import injection as j_inject
from repro.guard import GuardConfig as JGuardConfig
from repro.migration import MigrationConfig as JMigrationConfig
from repro.traces import analysis as j_analysis
from repro.traces import generate_calibrated as jax_generate
from repro_torch.api import admission
from repro_torch.convert import (fault_schedule_from_numpy,
                                 noise_table_from_numpy, taskset_from_numpy)
from repro_torch.core import SimConfig, run, simulator
from repro_torch.faults import (FaultConfig, FaultSchedule, crash_burst,
                                sample_schedule, usage_surge)
from repro_torch.faults import degrade, injection
from repro_torch.guard import GuardConfig
from repro_torch.migration import MigrationConfig
from repro_torch.traces import analysis
from test_torch_simulator import assert_summary_matches, noise_table

torch.set_num_threads(1)

EXACT = ["placement", "admit_slot", "qos_ok_slots", "active_slots"]
EXACT_METRICS = ["qos", "penalty", "n_running", "n_rejected", "n_reclaimed",
                 "n_fault_evicted", "n_degrade_evicted", "degraded",
                 "n_migrated", "n_migration_failed", "guard_tripped",
                 "n_guard_deferred", "guard_err_q", "node_usage",
                 "node_est", "node_requested"]
SUMMED = ["usage", "usage_std", "usage_mean", "est_usage"]


# ---------------------------------------------------------------------------
# helpers shared by the fault, retry, migration and guard files
# ---------------------------------------------------------------------------

def port_taskset(jts):
    return taskset_from_numpy({k: np.asarray(v) for k, v in
                               jts._asdict().items()}, device="cpu")


def jax_taskset(arrival, request, duration=50, mean_frac=0.5, priority=None,
                mean_usage=None):
    """A deterministic reference TaskSet (no noise), as the reference's
    test files build them."""
    t = len(arrival)
    request = jnp.asarray(request, jnp.float32)
    if request.ndim == 1:
        request = jnp.stack([request, request], axis=1)
    mean = (jnp.asarray(mean_usage, jnp.float32)[:, None] * jnp.ones((1, 2))
            if mean_usage is not None else request * mean_frac)
    return JTaskSet(
        arrival=jnp.asarray(arrival, jnp.int32),
        duration=(jnp.asarray(duration, jnp.int32) if np.ndim(duration)
                  else jnp.full((t,), duration, jnp.int32)),
        request=request, mean_usage=mean,
        std_usage=jnp.zeros((t, 2), jnp.float32), peak_usage=mean,
        ar_rho=jnp.zeros((t,), jnp.float32),
        priority=(jnp.asarray(priority, jnp.int32) if priority is not None
                  else jnp.zeros((t,), jnp.int32)),
        src=jnp.zeros((t,), jnp.int32))


def port_config(jcfg, **kw):
    """The port's SimConfig of a reference one (its configs converted)."""
    fields = jcfg._asdict()
    for name, cls in (("faults", FaultConfig), ("migration", MigrationConfig),
                      ("guard", GuardConfig)):
        if fields[name] is not None:
            fields[name] = cls(*fields[name])
    return SimConfig(**fields)._replace(**kw)


_REFERENCE_RUNS = {}


def both_runs(jts, jcfg, policy, sched=None, seed=0, use_kernel=(False,),
              cache=None, **port_kw):
    """The reference's run (its plain path) and the port's under the same
    demand noise, fault schedule (the reference's sampled one when
    ``sched`` is None and faults are on) and jitter table; one port run
    per ``use_kernel``, with ``port_kw`` replacing config fields (the
    reference's sequential and wavefront modes decide alike, so one
    reference run serves both of the port's).  A ``cache`` key keeps the
    reference's run for later calls.  Returns (jres, [tres...])."""
    kw = {} if sched is None else dict(fault_schedule=sched)
    if cache in _REFERENCE_RUNS:
        jres = _REFERENCE_RUNS[cache]
    else:
        jres = jax_run(jts, jcfg, policy, seed=seed, **kw)
        if cache is not None:
            _REFERENCE_RUNS[cache] = jres
    key = jax.random.PRNGKey(seed)
    if sched is None and jcfg.faults is not None:
        sched = j_inject.sample_schedule(
            jcfg.faults, jax.random.fold_in(key, _FAULT_STREAM),
            jcfg.n_slots, jcfg.n_nodes)
    jitter = None
    ts = port_taskset(jts)
    if jcfg.retry_jitter > 0:
        jitter = np.asarray(j_inject.jitter_table(
            jax.random.fold_in(key, _JITTER_STREAM), ts.num_tasks,
            jcfg.retry_jitter))
    table = noise_table(seed, jcfg.n_slots, ts.num_tasks)
    out = []
    for uk in use_kernel:
        cfg = port_config(jcfg, use_kernel=uk, **port_kw)
        out.append(run(ts, cfg, policy, device="cpu",
                       noise=noise_table_from_numpy(table, jitter=jitter,
                                                    device="cpu"),
                       fault_schedule=None if sched is None
                       else fault_schedule_from_numpy(sched, device="cpu")))
    return jres, out


def assert_same(jres, tres, requested=True):
    """Decisions and counters exactly, float sums within 1e-6;
    ``requested`` compared too unless False (a crash run)."""
    for name in EXACT:
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    for name in EXACT_METRICS:
        got = getattr(tres.metrics, name).numpy()
        want = np.asarray(getattr(jres.metrics, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in SUMMED + (["requested"] if requested else []):
        np.testing.assert_allclose(getattr(tres.metrics, name).numpy(),
                                   np.asarray(getattr(jres.metrics, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def assert_same_decisions(a, b):
    """The reference's _assert_results_equal, port against port."""
    for name in ("placement", "admit_slot"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("qos", "n_rejected", "penalty"):
        assert torch.equal(getattr(a.metrics, name),
                           getattr(b.metrics, name)), name


def port_only(jts, cfg, policy="flex-f", sched=None, seed=0):
    """A port run under the reference's demand noise (no JAX run)."""
    ts = port_taskset(jts)
    table = noise_table(seed, cfg.n_slots, ts.num_tasks)
    return run(ts, cfg, policy, device="cpu",
               noise=noise_table_from_numpy(table, device="cpu"),
               fault_schedule=sched)


# ---------------------------------------------------------------------------
# functions, bit for bit
# ---------------------------------------------------------------------------

def _sched_equal(port, ref):
    for name in ("node_up", "capacity", "demand_mult", "draining"):
        a, b = getattr(port, name), getattr(ref, name)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        assert a.numpy().dtype == np.asarray(b).dtype, name


@pytest.mark.parametrize("duration", [1, 3, 7, 40])
def test_windows_and_announce_match_reference(duration):
    rng = np.random.default_rng(duration)
    starts = rng.random((30, 17)) < 0.1
    got = injection._windows(torch.from_numpy(starts), duration)
    want = np.asarray(j_inject._windows(jnp.asarray(starts), duration))
    np.testing.assert_array_equal(got.numpy(), want)
    for warn in (0, 1, 3, 5):
        got_a = injection._announce(got, warn)
        want_a = np.asarray(j_inject._announce(jnp.asarray(want), warn))
        np.testing.assert_array_equal(got_a.numpy(), want_a)


def test_deterministic_schedules_match_reference():
    for args, kw in (((24, 16, 6, 0.4, 8), dict(warn_slots=3)),
                     ((24, 16, 0, 0.25, 30), {}),
                     ((12, 5, 4, 0.0, 3), dict(nodes=[1, 3], warn_slots=9)),
                     ((10, 8, 9, 1.0, 5), dict(warn_slots=2))):
        _sched_equal(crash_burst(*args, **kw, device="cpu"),
                     j_inject.crash_burst(*args, **kw))
    for args in ((24, 16, 4, 6, 4, 2.0), (48, 8, 12, 8, 8, 3.0),
                 (10, 3, 8, 5, 0, 1.7), (6, 2, -2, 1, 2, 4.0)):
        _sched_equal(usage_surge(*args, device="cpu"),
                     j_inject.usage_surge(*args))
    _sched_equal(FaultSchedule.none(7, 3, device="cpu"),
                 JFaultSchedule.none(7, 3))


def test_sampled_zero_rates_is_identity_schedule():
    gen = torch.Generator().manual_seed(0)
    sched = sample_schedule(FaultConfig(), gen, 16, 4)
    _sched_equal(sched, JFaultSchedule.none(16, 4))
    sampled = sample_schedule(FaultConfig(crash_rate=0.1, flap_rate=0.1,
                                          surge_rate=0.5, burst_slot=3,
                                          burst_frac=0.5, warn_slots=2),
                              gen, 16, 8)
    assert not sampled.node_up[3:15, :].all()
    assert (sampled.capacity < 1).any() and (sampled.demand_mult > 1).any()
    assert sampled.draining.any()


def test_fault_load_offset_and_mask_match_reference():
    rng = np.random.default_rng(1)
    up = rng.random(200) < 0.7
    cap = np.where(rng.random(200) < 0.3, rng.uniform(0, 1, 200),
                   1.0).astype(np.float32)
    got = admission.fault_load_offset(torch.from_numpy(up),
                                      torch.from_numpy(cap))
    want = np.asarray(j_admission.fault_load_offset(jnp.asarray(up),
                                                    jnp.asarray(cap)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[torch.from_numpy(up & (cap == 1))] == 0).all()
    res = rng.uniform(0, 0.3, (200, 2)).astype(np.float32)
    node = simulator.NodeState(*(torch.zeros(1),) * 5)._replace(
        reserved=torch.from_numpy(res))
    masked = admission.mask_unavailable(node, got).reserved
    np.testing.assert_array_equal(masked.numpy(), res + want[:, None])


def test_degrade_functions_match_reference_with_ties():
    rng = np.random.default_rng(2)
    t, n_slots = 500, 24
    # few distinct (rank, admit slot) pairs: most keys tie
    prio = rng.integers(0, 3, t).astype(np.int32)
    admit = rng.integers(-1, 4, t).astype(np.int32)
    for spare in (True, False):
        recl = rng.random(t) < 0.2
        got_r = degrade.victim_rank(torch.from_numpy(prio),
                                    torch.from_numpy(recl), spare)
        want_r = np.asarray(j_degrade.victim_rank(jnp.asarray(prio),
                                                  jnp.asarray(recl), spare))
        np.testing.assert_array_equal(got_r.numpy(), want_r)
        for k in (0, 1, 16, 64, 499, 600):
            ev = rng.random(t) < 0.8
            got = degrade.select_victims(torch.from_numpy(ev), got_r,
                                         torch.from_numpy(admit), n_slots, k)
            want = np.asarray(j_degrade.select_victims(
                jnp.asarray(ev), jnp.asarray(want_r), jnp.asarray(admit),
                n_slots, k))
            np.testing.assert_array_equal(got.numpy(), want)
    # the key rank * (S + 1) + admit + 1, against the jitted reference's
    key = jax.jit(lambda r, a: r.astype(jnp.float32) * (n_slots + 1)
                  + a.astype(jnp.float32) + 1.0)(jnp.asarray(want_r),
                                                 jnp.asarray(admit))
    port_key = (got_r.float() * float(n_slots + 1)
                + torch.from_numpy(admit).float() + 1.0)
    np.testing.assert_array_equal(port_key.numpy(), np.asarray(key))


def test_pressure_window_matches_reference():
    rng = np.random.default_rng(3)
    for w in (1, 6, 8, 33):
        win = torch.ones(w)
        jwin = jnp.ones((w,), jnp.float32)
        for _ in range(40):
            q = np.float32(rng.choice([1.0, rng.uniform(0.9, 1.0),
                                       rng.uniform(0.0, 1.0)]))
            win = degrade.push_window(win, torch.tensor(q))
            jwin = j_degrade.push_window(jwin, q)
            np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
            for thr in (0.99, 0.95, float(np.float32(win.mean()))):
                assert bool(degrade.under_pressure(win, thr)) == bool(
                    jax.jit(j_degrade.under_pressure)(jwin, thr))


@pytest.mark.parametrize("scale,floor", [(0.25, 0.2), (0.1, 0.0),
                                         (0.37, 0.5)])
def test_brownout_cap_rounds_as_the_jitted_reference(scale, floor):
    """``clip(1 - s (P - p_min), floor, 1)``: the jitted reference fuses
    it into one multiply-add, and so does the port; production keeps 1."""
    from repro.api.admission import PolicyContext as JPolicyContext
    from repro.api.admission import TaskView as JTaskView
    from repro.api.policies import BrownoutPolicy as JBrownoutPolicy
    from repro.core.types import FlexParams as JFlexParams
    from repro_torch.api import BrownoutPolicy
    from repro_torch.api.admission import PolicyContext, TaskView
    from repro_torch.core.types import FlexParams

    rng = np.random.default_rng(0)
    pens = np.concatenate([rng.uniform(1, 16, 8000),
                           np.linspace(1, 5, 2001)]).astype(np.float32)
    jpol = JBrownoutPolicy(brownout_scale=scale, floor=floor)
    tpol = BrownoutPolicy(brownout_scale=scale, floor=floor)
    jp, tp = JFlexParams.default(), FlexParams.default(device="cpu")
    for prio in (0, 1, 2):
        want = jax.jit(jax.vmap(lambda p, pm: jpol._cap(
            JPolicyContext(node=None, penalty=p, params=jp._replace(
                p_min=pm)), JTaskView(None, None, jnp.int32(prio)))))(
            pens, jnp.full(pens.shape, jp.p_min))
        got = tpol._cap(PolicyContext(node=None,
                                      penalty=torch.from_numpy(pens),
                                      params=tp),
                        TaskView(None, None, torch.tensor(prio)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got == 1).all() == (prio >= 1)


def test_brownout_kernel_rows_equal_kernel_inputs():
    """The per-task cap reaches the queue kernel's rows, each equal to the
    task's kernel_inputs."""
    from repro_torch.api import BrownoutPolicy
    from repro_torch.api.admission import PolicyContext, TaskView
    from repro_torch.core.types import FlexParams, NodeState

    pol = BrownoutPolicy()
    gen = torch.Generator().manual_seed(0)
    node = NodeState(torch.rand(16, 2, generator=gen), torch.zeros(16, 2),
                     torch.zeros(16, 2), torch.zeros(16, dtype=torch.int32),
                     torch.zeros(16, 64, dtype=torch.int32))
    ctx = PolicyContext(node=node, penalty=torch.tensor(3.0),
                        params=FlexParams.default(device="cpu"))
    prio = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    tasks = TaskView(torch.rand(4, 2, generator=gen),
                     torch.zeros(4, dtype=torch.int32), prio)
    rows = pol.queue_kernel_rows(ctx, tasks)
    for q in range(4):
        ki = pol.kernel_inputs(ctx, TaskView(tasks.request[q], tasks.src[q],
                                             prio[q]))
        assert float(rows[q, 3]) == float(ki.cap)
    assert rows[:, 3].tolist() == [0.5, 1.0, 1.0, 0.5]


@pytest.mark.parametrize("kwargs", [
    dict(crash_rate=-0.1), dict(crash_rate=1.5), dict(crash_duration=0),
    dict(flap_rate=-1.0), dict(flap_capacity=-0.5), dict(surge_frac=2.0),
    dict(surge_mult=0.0), dict(surge_duration=-4), dict(storm_rate=-0.2),
    dict(storm_slowdown=-1.0), dict(warn_slots=-1), dict(qos_window=0),
    dict(degrade_evict=-1), dict(burst_slot=-2), dict(burst_frac=1.1),
])
def test_faultconfig_rejects_degenerate(kwargs):
    with pytest.raises(ValueError):
        FaultConfig(**kwargs)
    with pytest.raises(ValueError):
        FaultConfig()._replace(**kwargs)


def test_faultconfig_fields_match_reference():
    assert FaultConfig._fields == JFaultConfig._fields
    assert tuple(FaultConfig()) == tuple(JFaultConfig())


# ---------------------------------------------------------------------------
# whole runs: the full stack at 64 nodes
# ---------------------------------------------------------------------------

FULL_N, FULL_S = 64, 24
FULL_BASE = dict(n_nodes=FULL_N, n_slots=FULL_S, arrivals_per_slot=256,
                 retry_capacity=64)
GRACEFUL = dict(degrade=True, qos_window=8, degrade_evict=16,
                degrade_spare_production=True)
GUARD = dict(window=4, trip_threshold=0.15, cooldown=3, probe_slots=2,
             probe_reclaim=4)


def stack_schedule(n_slots, n_nodes):
    """A crash burst with a drain warning, capacity flaps and a demand
    ramp in one schedule (numpy), for both packages."""
    burst = j_inject.crash_burst(n_slots, n_nodes, slot=6, frac=0.4,
                                 duration=8, warn_slots=3)
    capacity = np.ones((n_slots, n_nodes), np.float32)
    capacity[3:16, n_nodes // 2:n_nodes // 2 + n_nodes // 8] = 0.5
    surge = j_inject.usage_surge(n_slots, n_nodes, start=12, ramp=4, hold=3,
                                 peak_mult=2.0)
    return JFaultSchedule(node_up=burst.node_up,
                          capacity=jnp.asarray(capacity),
                          demand_mult=surge.demand_mult,
                          draining=burst.draining)


@pytest.fixture(scope="module")
def full_trace():
    return jax_generate(0, FULL_N, FULL_S, 1.6)


def full_stack_config():
    return JSimConfig(**FULL_BASE, retry_backoff=2, retry_jitter=2,
                      estimator="ewma", reclamation=True, reclaim_pool=64,
                      faults=JFaultConfig(**GRACEFUL),
                      migration=JMigrationConfig(bandwidth=16, pool_size=32),
                      guard=JGuardConfig(**GUARD))


def full_stack_runs(jts, policy, mode, use_kernel=(False,)):
    return both_runs(jts, full_stack_config(), policy,
                     sched=stack_schedule(FULL_S, FULL_N),
                     use_kernel=use_kernel, cache=("full", policy),
                     admission_mode=mode)


@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
@pytest.mark.parametrize("policy", ["flex-f", "least-fit", "flex-brownout"])
def test_full_stack_matches_reference(full_trace, policy, mode):
    kernels = (False,) if policy == "least-fit" else (False, True)
    jres, truns = full_stack_runs(full_trace, policy, mode, kernels)
    for tres in truns:
        assert_same(jres, tres, requested=False)
    m = truns[0].metrics
    assert int(m.n_fault_evicted[-1]) > 0
    assert int(m.n_degrade_evicted[-1]) > 0
    assert int(m.n_migrated[-1]) > 0 and int(m.n_migration_failed[-1]) > 0
    states = set(m.guard_tripped.tolist())
    assert states == {0, 1, 2}, states         # trips, probes, closes
    assert int(m.n_guard_deferred[-1]) > 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = j_analysis.summarize(full_trace, jres, 0.99)
        ts_ = analysis.summarize(port_taskset(full_trace), truns[0], 0.99)
    # the requested series is repaired in the port under a crash
    for key in ("avg_request_cpu", "avg_request_mem"):
        js.pop(key), ts_.pop(key)
    assert ts_["guard_trips"] >= 1
    assert_summary_matches(js, ts_)


def test_sampled_schedule_replayed_matches_reference(full_trace):
    """SimConfig(faults=...) with rates: the reference samples from its
    key's fault stream; the port replays that schedule."""
    fc = JFaultConfig(crash_rate=0.02, flap_rate=0.05, flap_capacity=0.4,
                      surge_rate=0.2, surge_mult=2.5, warn_slots=2,
                      **GRACEFUL)
    jcfg = JSimConfig(**FULL_BASE, faults=fc, retry_backoff=1)
    jres, (tres,) = both_runs(full_trace, jcfg, "flex-f", seed=3)
    assert_same(jres, tres, requested=False)
    assert int(tres.metrics.n_fault_evicted[-1]) > 0


# ---------------------------------------------------------------------------
# the requested metric under faults (a reference fault, repaired)
# ---------------------------------------------------------------------------

def _capture_requested(monkeypatch):
    """Record each slot's (requested, reserved, f_off) at the metric."""
    seen = []
    orig = simulator._requested_total

    def spy(node, f_off=None):
        seen.append((node.requested.clone(), node.reserved.clone(),
                     None if f_off is None else f_off.clone()))
        return orig(node, f_off)

    monkeypatch.setattr(simulator, "_requested_total", spy)
    return seen


def test_requested_matches_reference_without_crash(full_trace):
    """No faults, and flaps only: the reference's sum is sound, and the
    port agrees to 1e-6."""
    flaps = stack_schedule(FULL_S, FULL_N)
    flaps = flaps._replace(node_up=jnp.ones_like(flaps.node_up),
                           draining=jnp.zeros_like(flaps.draining))
    for sched, fc in ((None, None), (flaps, JFaultConfig())):
        jres, (tres,) = both_runs(
            full_trace, JSimConfig(**FULL_BASE, faults=fc), "flex-f",
            sched=sched)
        assert_same(jres, tres, requested=True)


def test_requested_under_crash_is_repaired(full_trace, monkeypatch):
    """Under a crash the port's mean requested is within 1e-6 of the
    float64 sum of each node's requests plus reservations; the
    reference's, which adds DRAIN_LOAD into its float32 total and takes
    it out after, is off by more than 1e-3."""
    seen = _capture_requested(monkeypatch)
    jres, (tres,) = full_stack_runs(full_trace, "flex-f", "sequential",
                                    use_kernel=(True,))
    assert_same(jres, tres, requested=False)
    truth = np.stack([
        (req.double() + (res.double() - off.double()[:, None])).sum(0)
        .numpy() / FULL_N for req, res, off in seen])
    got = tres.metrics.requested.numpy()
    want = np.asarray(jres.metrics.requested)
    # slots where a down or draining node carries DRAIN_LOAD
    drained = np.array([bool((off == admission.DRAIN_LOAD).any())
                        for _, _, off in seen])
    assert drained.any() and not drained.all()
    np.testing.assert_allclose(got, truth, rtol=0, atol=1e-6)
    assert np.abs(want - truth)[drained].max() > 1e-3
    # elsewhere (flaps only) the two agree
    np.testing.assert_allclose(got[~drained], want[~drained], rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the reference's simulator cases (tests/test_faults.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_sim_zero_faultconfig_bit_identical(mode):
    jts = jax_generate(0, 8, 24, 1.4)
    base = SimConfig(n_nodes=8, n_slots=24, arrivals_per_slot=64,
                     retry_capacity=32, admission_mode=mode)
    res0 = port_only(jts, base)
    res1 = port_only(jts, base._replace(faults=FaultConfig()))
    assert_same_decisions(res0, res1)
    for name in ("placement", "admit_slot", "qos_ok_slots", "active_slots"):
        assert torch.equal(getattr(res0, name), getattr(res1, name))
    for a, b in zip(res0.metrics, res1.metrics):
        assert torch.equal(a, b)


def test_sim_identity_schedule_bit_identical():
    jts = jax_generate(1, 8, 24, 1.4)
    base = SimConfig(n_nodes=8, n_slots=24, arrivals_per_slot=64,
                     retry_capacity=32)
    res0 = port_only(jts, base)
    res1 = port_only(jts, base, sched=FaultSchedule.none(24, 8,
                                                          device="cpu"))
    for a, b in zip(res0.metrics, res1.metrics):
        assert torch.equal(a, b)
    assert torch.equal(res0.placement, res1.placement)


def _port_taskset(**task_kw):
    return port_taskset(jax_taskset(**task_kw))


def _small_run(task_kw, sched, **cfg_kw):
    cfg = SimConfig(**dict(dict(arrivals_per_slot=4, retry_capacity=4),
                           **cfg_kw), faults=FaultConfig())
    return run(_port_taskset(**task_kw), cfg, "flex-f", device="cpu",
               fault_schedule=fault_schedule_from_numpy(sched, device="cpu"))


# The reference's small cases (tests/test_faults.py), with the values its
# assertions pin; the demand there is noise-free, so no table is replayed.

def test_crash_evicts_and_readmits_after_recovery():
    res = _small_run(dict(arrival=[0], request=[0.5]),
                     j_inject.crash_burst(16, 1, slot=4, frac=1.0,
                                          duration=4),
                     n_nodes=1, n_slots=16, max_retries=8)
    assert int(res.metrics.n_fault_evicted[3]) == 0
    assert int(res.metrics.n_fault_evicted[-1]) == 1
    assert int(res.admit_slot[0]) == 8 and int(res.placement[0]) == 0
    assert int(res.metrics.n_rejected[-1]) == 0


def test_down_node_admits_nothing():
    res = _small_run(dict(arrival=[0, 0, 2, 4], request=[0.3] * 4),
                     j_inject.crash_burst(12, 2, slot=0, frac=0.5,
                                          duration=12),
                     n_nodes=2, n_slots=12, arrivals_per_slot=8,
                     retry_capacity=8)
    pl = res.placement
    assert (pl[pl >= 0] == 1).all() and (pl >= 0).sum() > 0


def test_eviction_counts_as_qos_violation():
    res = _small_run(dict(arrival=[0, 0], request=[0.4, 0.4]),
                     j_inject.crash_burst(12, 2, slot=5, frac=0.5,
                                          duration=3),
                     n_nodes=2, n_slots=12)
    assert int(res.metrics.n_fault_evicted[5]) > 0
    assert float(res.metrics.qos[5]) < 1.0


def test_capacity_flap_blocks_large_tasks():
    flap = JFaultSchedule(node_up=jnp.ones((6, 1), bool),
                          capacity=jnp.full((6, 1), 0.4, jnp.float32),
                          demand_mult=jnp.ones((6, 1), jnp.float32))
    res = _small_run(dict(arrival=[0, 0], request=[0.6, 0.2],
                          mean_frac=0.2), flap, n_nodes=1, n_slots=6,
                     max_retries=0)
    assert int(res.placement[0]) == -1      # 0.6 + 0.6 offset > 1
    assert int(res.placement[1]) == 0       # 0.2 fits under the flap


def test_usage_surge_breaks_qos():
    task_kw = dict(arrival=[0, 1], request=[0.7, 0.6], mean_frac=0.25)
    surge = JFaultSchedule(
        node_up=jnp.ones((12, 1), bool),
        capacity=jnp.ones((12, 1), jnp.float32),
        demand_mult=jnp.ones((12, 1), jnp.float32).at[6:9].set(4.0))
    base = _small_run(task_kw, JFaultSchedule.none(12, 1), n_nodes=1,
                      n_slots=12)
    res = _small_run(task_kw, surge, n_nodes=1, n_slots=12)
    assert torch.equal(res.metrics.qos[:6], base.metrics.qos[:6])
    assert res.metrics.qos[6:9].min() < base.metrics.qos[6:9].min()


def test_metrics_fields_zero_without_faults():
    res = run(_port_taskset(arrival=[0], request=[0.3]),
              SimConfig(n_nodes=1, n_slots=4, arrivals_per_slot=4,
                        retry_capacity=4), "flex-f", device="cpu")
    for name in ("n_fault_evicted", "n_degrade_evicted", "degraded"):
        assert int(getattr(res.metrics, name).sum()) == 0


def test_degrade_sheds_into_reclaim_pool_when_reclamation_on(full_trace):
    """The reference's slow case at 64 nodes: degrade-shed victims drop
    into the reclaim pool."""
    cfg = SimConfig(**FULL_BASE, reclamation=True, reclaim_pool=64,
                    faults=FaultConfig(degrade=True, qos_window=6,
                                       degrade_evict=16))
    res = port_only(full_trace, cfg, sched=crash_burst(
        FULL_S, FULL_N, 6, 0.5, 12, device="cpu"))
    m = res.metrics
    assert int(m.n_fault_evicted[-1]) > 0
    assert int(m.n_degrade_evicted[-1]) > 0 and int(m.degraded.sum()) > 0


def test_graceful_retains_more_than_naive(full_trace):
    """The reference's acceptance shape (tests/test_faults.py, slow) cut to
    64 nodes and 24 slots: graceful shedding keeps more running task-slots
    than evict-everything."""
    burst = crash_burst(FULL_S, FULL_N, 6, 0.4, 12, device="cpu")
    out = {}
    for name, fc in (("graceful", FaultConfig(**GRACEFUL)),
                     ("naive", FaultConfig(degrade=True, qos_window=8,
                                           degrade_evict=4096,
                                           degrade_spare_production=False))):
        res = port_only(full_trace, SimConfig(**FULL_BASE, retry_backoff=2,
                                              faults=fc), sched=burst)
        out[name] = analysis.fault_recovery(res, 0.99)
    assert out["graceful"]["n_degrade_evicted"] > 0
    assert (out["graceful"]["retained_task_slots"]
            > out["naive"]["retained_task_slots"])
