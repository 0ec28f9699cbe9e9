"""The serving engine's faults, brownout, live migration and drift guard:
the port against the JAX reference.

The same requests go through both engines with the stub decode, under
flex, reserve and flex-priority, in every admission mode.  Step by step,
the residents (with their progress, evictions, stall and migrations), the
queue order, every ``EngineStats`` counter, the breaker's state, timer and
trip statistic, and the migrate pass's penalty must be equal, and so must
the event streams: admissions, evictions (each tagged overflow or
fault) and migrations.  The fault draws are numpy's on both sides, so no
replay is needed.  The QoS, penalty and utilization series are equal bit
for bit, as in ``tests/test_torch_serving.py``.

The engine runs the guard eagerly, as the reference's engine does: its
confidence divides and its penalty scale rounds twice, where the jitted
simulator multiplies by a reciprocal and fuses; both forms are held bit
for bit against their reference.  The reference's engine tests in
``tests/test_faults.py``, ``test_migration.py`` and ``test_guard.py`` are
mirrored on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.faults import FaultConfig as JFaultConfig
from repro.guard import GuardConfig as JGuardConfig
from repro.guard import watchdog as j_wd
from repro.migration import MigrationConfig as JMigrationConfig
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.core.types import CLASS_PRODUCTION
from repro_torch.faults import FaultConfig
from repro_torch.guard import HALF_OPEN, GuardConfig
from repro_torch.guard import watchdog as wd
from repro_torch.migration import MigrationConfig
from repro_torch.serving import (ADMISSION_MODES, EngineConfig, Request,
                                 RequestStream, ServeEngine, StreamConfig)

torch.set_num_threads(1)

POLICIES = ["flex", "reserve", "flex-priority"]


def _workload(n, seed=1):
    """(rid, prompt, declared, true, src, priority) rows: three clients in
    four declare honestly, so usage-based admission overflows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        true = int(rng.integers(20, 60))
        over = float(rng.choice([1.0, 1.0, 1.0, 2.0]))
        rows.append((i, int(rng.integers(10, 40)), int(true * over), true,
                     int(rng.integers(0, 8)), int(rng.integers(0, 2))))
    return rows


_BURST = dict(burst_slot=8, burst_frac=0.5, crash_duration=6)
_MIGRATE = dict(bandwidth=8, pool_size=8, migrate_cost=3)
_TRIP = dict(window=4, trip_threshold=0.1, cooldown=4, probe_slots=3,
             probe_reclaim=2)

# name -> (requests, KV budget, estimator, FaultConfig, MigrationConfig,
# GuardConfig keywords; None = off).  4 replicas, 16 slots each.
SCENARIOS = {
    "zero_faults": (36, 300, "current", {}, None, None),
    "crash_burst": (32, 400, "current", _BURST, None, None),
    "storms": (32, 400, "ewma",
               dict(storm_rate=0.15, storm_slowdown=8.0, storm_duration=5),
               None, None),
    "brownout": (48, 400, "current",
                 dict(_BURST, crash_duration=10, degrade=True, qos_window=4,
                      degrade_threshold=0.95), None, None),
    "warn_no_migration": (32, 400, "current", dict(_BURST, warn_slots=4),
                          None, None),
    "migration_stall": (24, 400, "current", dict(_BURST, warn_slots=4),
                        _MIGRATE, None),
    "migrate_then_shed": (48, 350, "ewma", {},
                          dict(_MIGRATE, migrate_cost=1), None),
    "guard_half_open": (48, 400, "current", None, None, _TRIP),
    "guard_migration": (24, 400, "current", dict(_BURST, warn_slots=4),
                        dict(_MIGRATE, margin_scale=0.02),
                        dict(_TRIP, trip_threshold=0.3, guard_scale=2.0)),
}
STEPS = 60


def _configs(name, policy, mode):
    n, budget, est, f, m, g = SCENARIOS[name]
    kw = dict(n_replicas=4, kv_budget_tokens=budget,
              max_active_per_replica=16, admit_batch=16, policy=policy,
              admission_mode=mode, estimator=est)
    jkw, tkw = dict(kw), dict(kw)
    for key, jcls, tcls, val in (("faults", JFaultConfig, FaultConfig, f),
                                 ("migration", JMigrationConfig,
                                  MigrationConfig, m),
                                 ("guard", JGuardConfig, GuardConfig, g)):
        if val is not None:
            jkw[key], tkw[key] = jcls(**val), tcls(**val)
    return JEngineConfig(**jkw), EngineConfig(**tkw), _workload(n)


def _stats(eng):
    d = dataclasses.asdict(eng.stats)
    d.pop("admit_latency_s")              # wall clock
    return d


def trajectory(engine_cls, request_cls, cfg, rows, steps, **kw):
    """Run ``steps`` steps; return the event log and the per-step state."""
    eng = engine_cls(cfg, seed=2, **kw)
    log = []
    eng.on_admit = lambda r: log.append(
        (eng.stats.steps, "admit", r.rid, r.replica))
    eng.on_evict = lambda r: log.append(
        (eng.stats.steps, "evict", r.rid, eng.stats.evicted_events,
         eng.stats.fault_evictions))
    try_migrate = getattr(eng, "_try_migrate", None)

    def logged_migrate(cands, extra_off=None):
        moved = try_migrate(cands, extra_off)
        log.extend((eng.stats.steps, "migrate", r.rid, r.replica)
                   for r in moved)
        return moved

    if cfg.migration is not None:
        eng._try_migrate = logged_migrate
    for row in rows:
        eng.submit(request_cls(*row))
    states = []
    for _ in range(steps):
        eng.step()
        guard = ((eng._g_state, eng._g_timer, eng._g_err_q,
                  eng._guard_penalty()) if cfg.guard is not None else None)
        states.append((
            {i: [(r.rid, r.generated, r.evictions, r.stall, r.migrations,
                  r.done) for r in rs] for i, rs in eng.active.items()},
            [r.rid for r in eng.queue], _stats(eng), guard,
            list(eng.step_time_ema)))
    return eng, log, states


def assert_same_run(name, policy, mode):
    jcfg, tcfg, rows = _configs(name, policy, mode)
    je, jlog, jstates = trajectory(JServeEngine, JRequest, jcfg, rows, STEPS)
    te, tlog, tstates = trajectory(ServeEngine, Request, tcfg, rows, STEPS,
                                   device="cpu")
    assert tlog == jlog
    for step, (t, j) in enumerate(zip(tstates, jstates)):
        assert t == j, f"step {step}"
    assert te.stats.qos_series == je.stats.qos_series
    assert te.stats.penalty_series == je.stats.penalty_series
    assert te.stats.util_series == je.stats.util_series
    return je, jlog, jstates


@pytest.mark.parametrize("mode", ADMISSION_MODES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_faults_match_reference(name, policy, mode):
    je, log, states = assert_same_run(name, policy, mode)
    st = je.stats
    kinds = {e[1] for e in log}
    # each scenario's mechanism is at work in the reference's run
    if name == "crash_burst" or name == "warn_no_migration":
        assert st.fault_evictions > 0
    elif name == "storms":
        assert max(max(s[4]) / min(s[4]) for s in states) > 2.0
    elif name == "brownout":
        assert st.brownout_steps > 0 and st.brownout_deferred > 0
    elif name == "migration_stall":
        assert st.migrations > 0 and "migrate" in kinds
        assert any(r[3] > 0 for s in states for rs in s[0].values()
                   for r in rs)
    elif name == "migrate_then_shed" and policy != "reserve":
        assert st.migrations > 0 and st.evicted_events > 0
    elif name == "guard_half_open":
        seen = [s[3][0] for s in states]
        assert st.guard_trips >= 1 and HALF_OPEN in seen
        assert st.guard_deferred > 0
    elif name == "guard_migration":
        # the migrate pass's penalty is scaled up by the drift
        assert st.migrations > 0
        assert any(s[3][3] > p for s, p in zip(states, st.penalty_series))


@pytest.mark.parametrize("mode", ADMISSION_MODES)
def test_zero_faultconfig_bit_identical_to_none(mode):
    """An all-zero FaultConfig draws from its own stream every step and
    changes nothing."""
    _, tcfg, rows = _configs("zero_faults", "flex", mode)
    _, log0, states0 = trajectory(ServeEngine, Request,
                                  dataclasses.replace(tcfg, faults=None),
                                  rows, STEPS, device="cpu")
    _, log1, states1 = trajectory(ServeEngine, Request, tcfg, rows, STEPS,
                                  device="cpu")
    assert log0 == log1 and states0 == states1
    assert states1[-1][2]["evicted_events"] > 0


def test_fault_draws_every_step_follow_the_reference():
    """Crashes then storms, ``random(n)`` each, every step."""
    fc = FaultConfig(crash_rate=0.1, storm_rate=0.2)
    eng = ServeEngine(EngineConfig(n_replicas=5, faults=fc), seed=4,
                      device="cpu")
    rng = np.random.default_rng(5 * 0x5EED)
    for _ in range(6):
        eng.step()
        rng.random(5)
        rng.random(5)
    assert eng._fault_rng.random() == rng.random()


def test_migration_requires_faults():
    with pytest.raises(ValueError, match="migration requires"):
        ServeEngine(EngineConfig(n_replicas=2, migration=MigrationConfig()),
                    device="cpu")
    with pytest.raises(ValueError, match="migration requires"):
        JServeEngine(JEngineConfig(n_replicas=2,
                                   migration=JMigrationConfig()))


# ---------------------------------------------------------------------------
# the eager guard arithmetic, bit for bit
# ---------------------------------------------------------------------------

_GUARDS = [(0.15, 1.0), (0.07, 0.7), (0.3, 2.5), (0.118, 1.3)]


@pytest.mark.parametrize("thr,scale", _GUARDS)
def test_engine_confidence_and_scale_equal_eager_reference(thr, scale):
    g = GuardConfig(trip_threshold=thr, guard_scale=scale)
    jg = JGuardConfig(trip_threshold=thr, guard_scale=scale)
    rng = np.random.default_rng(int(thr * 1000))
    errs = np.concatenate([rng.random(10_000) * 2 * thr,
                           np.float32(thr) * (1 + rng.integers(
                               -4, 5, 64) * 2.0 ** -23)]).astype(np.float32)
    for e in errs:
        je = jnp.float32(e)                 # eager, as the engine calls it
        assert wd.confidence_eager(float(e), g) == np.float32(
            j_wd.confidence(je, jg))
        assert wd.penalty_scale_eager(float(e), g) == np.float32(
            j_wd.penalty_scale(je, jg))


@pytest.mark.parametrize("thr,scale", _GUARDS)
def test_simulator_confidence_and_scale_equal_jitted_reference(thr, scale):
    g = GuardConfig(trip_threshold=thr, guard_scale=scale)
    jg = JGuardConfig(trip_threshold=thr, guard_scale=scale)
    rng = np.random.default_rng(int(thr * 1000) + 1)
    errs = (rng.random(10_000) * 2 * thr).astype(np.float32)
    want_c = np.asarray(jax.jit(lambda e: j_wd.confidence(e, jg))(errs))
    want_s = np.asarray(jax.jit(lambda e: j_wd.penalty_scale(e, jg))(errs))
    t = torch.from_numpy(errs)
    assert np.array_equal(wd.confidence(t, g).numpy(), want_c)
    assert np.array_equal(wd.penalty_scale(t, g).numpy(), want_s)


def test_eager_and_jitted_forms_differ():
    """The two roundings are not the same function: the engine needs its
    own."""
    g = JGuardConfig(trip_threshold=0.07, guard_scale=0.7)
    errs = (np.random.default_rng(0).random(2000) * 0.07).astype(np.float32)
    jit = np.asarray(jax.jit(lambda e: j_wd.penalty_scale(e, g))(errs))
    eager = np.array([np.float32(j_wd.penalty_scale(jnp.float32(e), g))
                      for e in errs])
    assert (jit != eager).any()


@pytest.mark.parametrize("window", [4, 6, 16])
@pytest.mark.parametrize("q", [0.5, 0.75, 0.9, 0.95])
def test_engine_trip_statistic_equals_eager_reference(window, q):
    """Called on its own, ``jnp.quantile`` takes ``q`` at run time and XLA
    fuses the other product than inside the jitted scan; the simulator's
    form stays equal to the jitted reference."""
    rng = np.random.default_rng(window)
    jit = jax.jit(lambda w: j_wd.trip_statistic(w, q))
    for _ in range(200):
        win = (rng.random((window, 1))
               * rng.choice([0.02, 0.3])).astype(np.float32)
        t = torch.from_numpy(win)
        assert np.float32(wd.trip_statistic_eager(t, q)) == np.float32(
            j_wd.trip_statistic(jnp.asarray(win), q))
        assert np.float32(wd.trip_statistic(t, q)) == np.float32(
            jit(jnp.asarray(win)))


@pytest.mark.parametrize("n", [2, 4, 8, 33])
def test_engine_drift_sample_equals_eager_reference(n):
    """The engine's drift sample: eager ``jnp.mean`` multiplies by the
    rounded reciprocal, as the port's ``drift_sample``."""
    rng = np.random.default_rng(n)
    for _ in range(200):
        a = rng.random((n, 1)).astype(np.float32)
        b = rng.random((n, 1)).astype(np.float32)
        want = np.asarray(j_wd.drift_sample(jnp.asarray(a), jnp.asarray(b)))
        got = wd.drift_sample(torch.from_numpy(a), torch.from_numpy(b))
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the reference's engine tests, on the port
# ---------------------------------------------------------------------------

def _drive(cfg, stream_cfg, horizon, seed):
    eng = ServeEngine(cfg, seed=seed, device="cpu")
    stats = RequestStream(stream_cfg, horizon=horizon).drive(eng)
    return eng, stats


def test_engine_zero_faultconfig_bit_identical():
    runs = [_drive(EngineConfig(n_replicas=4, faults=f),
                   StreamConfig(mean_rate=12.0, seed=3), 48, 3)[1]
            for f in (None, FaultConfig())]
    assert _stats_dict(runs[0]) == _stats_dict(runs[1])


def _stats_dict(stats):
    d = dataclasses.asdict(stats)
    d.pop("admit_latency_s")
    return d


def test_engine_crash_burst_evicts_and_recovers():
    fc = FaultConfig(burst_slot=16, burst_frac=0.5, burst_duration=16)
    _, stats = _drive(EngineConfig(n_replicas=4, faults=fc),
                      StreamConfig(mean_rate=12.0, seed=3), 96, 3)
    assert stats.fault_evictions > 0
    assert stats.finished > 0


def test_engine_brownout_defers_batch_admits_production():
    fc = FaultConfig(burst_slot=10, burst_frac=0.75, burst_duration=40,
                     degrade=True, qos_window=6, degrade_threshold=0.9)
    _, stats = _drive(EngineConfig(n_replicas=4, faults=fc),
                      StreamConfig(mean_rate=20.0, seed=3), 96, 3)
    assert stats.brownout_steps > 0
    assert stats.brownout_deferred > 0
    assert stats.admitted > 0


def test_engine_storm_triggers_existing_mitigation():
    fc = FaultConfig(storm_rate=0.1, storm_slowdown=8.0, storm_duration=12)
    eng, _ = _drive(EngineConfig(n_replicas=4, faults=fc),
                    StreamConfig(mean_rate=10.0, seed=5), 64, 5)
    assert float(np.max(eng.step_time_ema)) > 2.0 * float(
        np.min(eng.step_time_ema))


def _requests(eng, n, **kw):
    rng = np.random.default_rng(7)
    for i in range(n):
        eng.submit(Request(rid=i, prompt_len=int(rng.integers(50, 200)),
                           max_tokens=kw.get("max_tokens", 100),
                           true_tokens=int(rng.integers(*kw.get(
                               "true", (30, 100)))),
                           **({"src": int(rng.integers(0, 8))}
                              if kw.get("src") else {})))


def test_engine_warn_slots_inert_without_migration():
    def drive(fc):
        eng = ServeEngine(EngineConfig(n_replicas=4, faults=fc), seed=3,
                          device="cpu")
        _requests(eng, 60)
        eng.run(48)
        return _stats_dict(eng.stats)

    fc = FaultConfig(burst_slot=10, burst_frac=0.5, burst_duration=12)
    assert drive(fc._replace(warn_slots=4)) == drive(fc)


def _engine_burst(migration, horizon=48, seed=0):
    fc = FaultConfig(burst_slot=10, burst_frac=0.25, burst_duration=15,
                     warn_slots=6)
    eng = ServeEngine(EngineConfig(n_replicas=8, kv_budget_tokens=8192,
                                   faults=fc, migration=migration),
                      seed=seed, device="cpu")
    _requests(eng, 80, max_tokens=120, true=(40, 120), src=True)
    eng.run(horizon)
    return eng


def test_engine_migration_rescues_announced_crash_victims():
    e0 = _engine_burst(None)
    e1 = _engine_burst(MigrationConfig(bandwidth=64, pool_size=128))
    assert e1.stats.migrations > 0
    assert e1.stats.fault_evictions < e0.stats.fault_evictions
    moved = [r for reqs in e1.active.values() for r in reqs
             if r.migrations > 0]
    assert e1.stats.finished >= e0.stats.finished or moved


def test_engine_migrated_request_pays_stall_not_restart():
    e1 = _engine_burst(MigrationConfig(bandwidth=64, pool_size=128,
                                       migrate_cost=3))
    assert e1.stats.migrations > 0
    for reqs in e1.active.values():
        for r in reqs:
            if r.migrations > 0 and r.evictions == 0:
                assert r.generated >= 0 and r.replica >= 0


def test_engine_inert_guard_bit_identical():
    inert = GuardConfig(trip_threshold=1e9, guard_scale=0.0)
    runs = [_drive(EngineConfig(n_replicas=4, estimator="ewma", guard=g),
                   StreamConfig(mean_rate=12.0, seed=3), 48, 3)[1]
            for g in (None, inert)]
    assert _stats_dict(runs[0]) == _stats_dict(runs[1])


def test_engine_guard_defers_batch_keeps_production():
    cfg = EngineConfig(
        n_replicas=4, estimator="ewma",
        guard=GuardConfig(window=6, trip_threshold=0.02, cooldown=6,
                          probe_slots=3, probe_reclaim=2))
    _, stats = _drive(cfg, StreamConfig(mean_rate=12.0, seed=3,
                                        shock_start=16, shock_len=12,
                                        shock_mult=3.0), 48, 3)
    assert stats.guard_trips >= 1
    assert stats.guard_open_steps > 0
    assert stats.guard_deferred > 0


def test_engine_guard_halfopen_trickle_bounded():
    eng = ServeEngine(EngineConfig(n_replicas=2, estimator="current",
                                   guard=GuardConfig(probe_reclaim=2)),
                      seed=0, device="cpu")
    eng.refresh_snapshots()
    eng._g_state = HALF_OPEN
    eng._g_timer = 3
    for i in range(6):
        eng.submit(Request(rid=i, prompt_len=16, max_tokens=16,
                           true_tokens=8))
    eng.submit(Request(rid=99, prompt_len=16, max_tokens=16, true_tokens=8,
                       priority=CLASS_PRODUCTION))
    eng.admit_pending()
    admitted = {r.rid for rs in eng.active.values() for r in rs}
    assert admitted == {0, 1, 99}
    assert eng.stats.guard_deferred == 4
