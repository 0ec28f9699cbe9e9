"""Live migration and proactive drain: the port against the JAX reference
(``tests/test_migration.py``'s simulator cases; the engine's migration is
held in ``tests/test_torch_engine_faults.py``).

The reference's small cases run on noise-free tasks, so the port is held
to the values their assertions pin.  The ``migrate`` policy's cap is held
bit for bit against the jitted reference, and a whole run with drains,
hot-node draining (``overload_threshold``) and a target margin at 64
nodes against the reference's under replayed noise, in both admission
modes, the port with ``use_kernel`` both ways.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api.policies import MigratePolicy as JMigratePolicy
from repro.api.admission import PolicyContext as JPolicyContext
from repro.core import SimConfig as JSimConfig
from repro.faults import FaultConfig as JFaultConfig
from repro.faults import injection as j_inject
from repro.migration import MigrationConfig as JMigrationConfig
from repro.traces import generate_calibrated as jax_generate
from repro_torch.api import Experiment, MigratePolicy
from repro_torch.api.admission import PolicyContext, TaskView
from repro_torch.convert import fault_schedule_from_numpy
from repro_torch.core import SimConfig, run
from repro_torch.core.numerics import fma
from repro_torch.core.types import FlexParams, NodeState
from repro_torch.faults import FaultConfig, FaultSchedule, crash_burst
from repro_torch.migration import MigrationConfig
from test_torch_faults import (FULL_BASE, FULL_N, FULL_S, assert_same,
                               assert_same_decisions, both_runs,
                               jax_taskset, port_only, port_taskset)

torch.set_num_threads(1)


def _pin_to_node0(sched: FaultSchedule) -> FaultSchedule:
    """Force slot-0 admissions onto node 0 by downing every other node."""
    node_up = sched.node_up.clone()
    node_up[0, 1:] = False
    return sched._replace(node_up=node_up)


def _small(arrival, request, duration=50):
    return port_taskset(jax_taskset(arrival, request, duration=duration))


def _drain_scenario(migration, *, warn_slots=3, duration=50, n_slots=16):
    ts = _small([0], [0.5], duration)
    cfg = SimConfig(n_nodes=2, n_slots=n_slots, arrivals_per_slot=4,
                    retry_capacity=4, faults=FaultConfig(),
                    migration=migration)
    sched = _pin_to_node0(crash_burst(n_slots, 2, slot=6, frac=0.5,
                                      duration=6, warn_slots=warn_slots,
                                      device="cpu"))
    return run(ts, cfg, "flex-f", device="cpu", fault_schedule=sched)


# ---------------------------------------------------------------------------
# parity: migration off, and the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_sim_drain_table_inert_without_migration(mode):
    jts = jax_generate(0, 8, 32, 1.3)
    cfg = SimConfig(n_nodes=8, n_slots=32, arrivals_per_slot=64,
                    retry_capacity=32, admission_mode=mode,
                    faults=FaultConfig())
    plain = crash_burst(32, 8, slot=10, frac=0.25, duration=8, device="cpu")
    warned = crash_burst(32, 8, slot=10, frac=0.25, duration=8,
                         warn_slots=4, device="cpu")
    assert_same_decisions(port_only(jts, cfg, sched=plain),
                          port_only(jts, cfg, sched=warned))


def test_experiment_warn_slots_inert_without_migration():
    """The drain table is derived from the sampled tables without a draw,
    so sampled runs are bit-identical across warn settings, seed by
    seed."""
    ts = port_taskset(jax_generate(1, 8, 24, 1.3))
    cfg = SimConfig(n_nodes=8, n_slots=24, arrivals_per_slot=64,
                    retry_capacity=32)
    res = [Experiment(ts, cfg._replace(faults=FaultConfig(
        crash_rate=0.02, warn_slots=w)), "flex-f", device="cpu").run(
            seeds=[0, 1]) for w in (0, 4)]
    assert_same_decisions(*res)
    assert int(res[0].metrics.n_fault_evicted[:, -1].sum()) > 0


def test_sim_migration_requires_faults():
    cfg = SimConfig(n_nodes=2, n_slots=8, arrivals_per_slot=4,
                    retry_capacity=4, migration=MigrationConfig())
    with pytest.raises(ValueError, match="migration requires fault"):
        run(_small([0], [0.3]), cfg, "flex-f", device="cpu")


def test_metrics_fields_zero_without_migration():
    res = run(_small([0], [0.3]), SimConfig(
        n_nodes=1, n_slots=4, arrivals_per_slot=4, retry_capacity=4),
        "flex-f", device="cpu")
    assert int(res.metrics.n_migrated.sum()) == 0
    assert int(res.metrics.n_migration_failed.sum()) == 0


@pytest.mark.parametrize("kwargs", [
    dict(bandwidth=-1), dict(migrate_cost=-1), dict(pool_size=0),
    dict(overload_threshold=-0.1), dict(margin_scale=-1.0),
])
def test_migrationconfig_rejects_degenerate(kwargs):
    with pytest.raises(ValueError):
        MigrationConfig(**kwargs)
    with pytest.raises(ValueError):
        MigrationConfig()._replace(**kwargs)


def test_migrationconfig_fields_match_reference():
    assert MigrationConfig._fields == JMigrationConfig._fields
    assert tuple(MigrationConfig()) == tuple(JMigrationConfig())


# ---------------------------------------------------------------------------
# the reference's small cases
# ---------------------------------------------------------------------------

def test_task_migrates_off_draining_node_keeping_progress():
    res = _drain_scenario(MigrationConfig(bandwidth=4, pool_size=8,
                                          migrate_cost=2))
    m = res.metrics
    assert int(m.n_migrated[-1]) == 1 and int(m.n_migration_failed[-1]) == 0
    assert int(m.n_fault_evicted[-1]) == 0
    assert int(res.placement[0]) == 1 and int(res.admit_slot[0]) == 0
    assert int(m.n_rejected[-1]) == 0


def test_migrate_cost_extends_runtime():
    base = _drain_scenario(None, duration=5)
    res = _drain_scenario(MigrationConfig(bandwidth=4, pool_size=8,
                                          migrate_cost=2), duration=5)
    assert int(res.metrics.n_migrated[-1]) == 1
    assert int(res.active_slots[0]) == int(base.active_slots[0]) + 2


def test_zero_bandwidth_falls_back_to_evict_and_retry():
    res = _drain_scenario(MigrationConfig(bandwidth=0, pool_size=8))
    m = res.metrics
    assert int(m.n_migrated[-1]) == 0 and int(m.n_fault_evicted[-1]) == 1
    assert int(res.placement[0]) == 1 and int(res.admit_slot[0]) > 6
    assert int(m.n_rejected[-1]) == 0


def test_pool_overflow_counts_failed_and_falls_back():
    cfg = SimConfig(n_nodes=2, n_slots=16, arrivals_per_slot=4,
                    retry_capacity=4, faults=FaultConfig(),
                    migration=MigrationConfig(bandwidth=0, pool_size=1))
    sched = _pin_to_node0(crash_burst(16, 2, slot=6, frac=0.5, duration=6,
                                      warn_slots=3, device="cpu"))
    res = run(_small([0, 0], [0.3, 0.3]), cfg, "flex-f", device="cpu",
              fault_schedule=sched)
    m = res.metrics
    assert int(m.n_migration_failed[-1]) == 1 and int(m.n_migrated[-1]) == 0
    assert (res.placement == 1).all()
    admit = sorted(res.admit_slot.tolist())
    assert admit[0] < 6 < admit[1]
    assert int(m.n_rejected[-1]) == 0


def test_migration_beats_graceful_on_crash_burst():
    jts = jax_generate(0, 8, 40, 1.2)
    cfg = SimConfig(n_nodes=8, n_slots=40, arrivals_per_slot=64,
                    retry_capacity=32, faults=FaultConfig())
    sched = crash_burst(40, 8, slot=15, frac=0.25, duration=10,
                        warn_slots=4, device="cpu")
    base = port_only(jts, cfg, sched=sched)
    mig = port_only(jts, cfg._replace(migration=MigrationConfig(
        bandwidth=16, pool_size=64)), sched=sched)
    assert int(mig.metrics.n_migrated[-1]) > 0
    assert (int(mig.metrics.n_fault_evicted[-1])
            < int(base.metrics.n_fault_evicted[-1]))
    assert int(mig.metrics.n_running.sum()) >= int(
        base.metrics.n_running.sum())


@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_migration_modes_agree(mode):
    jts = jax_generate(2, 8, 32, 1.2)
    cfg = SimConfig(n_nodes=8, n_slots=32, arrivals_per_slot=64,
                    retry_capacity=32, admission_mode=mode,
                    faults=FaultConfig(),
                    migration=MigrationConfig(bandwidth=8, pool_size=32))
    sched = crash_burst(32, 8, slot=12, frac=0.25, duration=8, warn_slots=4,
                        device="cpu")
    res = port_only(jts, cfg, sched=sched)
    ref = port_only(jts, cfg._replace(admission_mode="sequential"),
                    sched=sched)
    assert_same_decisions(res, ref)
    assert torch.equal(res.metrics.n_migrated, ref.metrics.n_migrated)


def test_retries_deferred_while_no_node_admits():
    cfg = SimConfig(n_nodes=1, n_slots=20, arrivals_per_slot=4,
                    retry_capacity=4, max_retries=3, faults=FaultConfig())
    res = run(_small([0], [0.5]), cfg, "flex-f", device="cpu",
              fault_schedule=crash_burst(20, 1, slot=2, frac=1.0,
                                         duration=10, device="cpu"))
    m = res.metrics
    assert int(m.n_fault_evicted[-1]) == 1 and int(m.n_rejected[-1]) == 0
    assert int(res.admit_slot[0]) == 12 and int(res.placement[0]) == 0


def test_retry_deferral_does_not_change_partial_outages():
    cfg = SimConfig(n_nodes=2, n_slots=16, arrivals_per_slot=4,
                    retry_capacity=4, max_retries=3, faults=FaultConfig())
    sched = _pin_to_node0(crash_burst(16, 2, slot=4, frac=0.5, duration=8,
                                      device="cpu"))
    res = run(_small([0, 0], [0.3, 0.3]), cfg, "flex-f", device="cpu",
              fault_schedule=sched)
    assert int(res.metrics.n_fault_evicted[-1]) == 2
    assert (res.placement == 1).all()
    assert int(res.admit_slot.max()) == 5


@pytest.mark.parametrize("estimator", ["quantile", "learned"])
def test_faults_compose_with_estimators_and_reclamation(estimator):
    ts = port_taskset(jax_generate(4, 8, 32, 1.4))
    cfg = SimConfig(n_nodes=8, n_slots=32, arrivals_per_slot=64,
                    retry_capacity=32, estimator=estimator, reclamation=True,
                    faults=FaultConfig(surge_rate=0.1, surge_frac=0.5,
                                       surge_mult=3.0))
    res = run(ts, cfg, "flex-f", device="cpu")
    q = res.metrics.qos
    assert torch.isfinite(q).all() and (q >= 0).all() and (q <= 1).all()
    assert int(res.metrics.n_rejected[-1]) >= 0
    # the zero config leaves the estimator run as it was
    base = cfg._replace(faults=None)
    a = run(ts, base, "flex-f", device="cpu", seed=1)
    b = run(ts, base._replace(faults=FaultConfig()), "flex-f", device="cpu",
            seed=1)
    assert_same_decisions(a, b)


# ---------------------------------------------------------------------------
# the migrate policy, and a whole run against the reference
# ---------------------------------------------------------------------------

def test_migrate_cap_rounds_as_the_jitted_reference():
    rng = np.random.default_rng(0)
    pens = np.concatenate([rng.uniform(0.5, 20.0, 4000),
                           np.linspace(1.0, 3.0, 2001)]).astype(np.float32)
    for margin in (0.0, 0.05, 0.1, 0.3):
        jpol, tpol = JMigratePolicy(margin_scale=margin), MigratePolicy(
            margin_scale=margin)
        want = np.asarray(jax.jit(jax.vmap(lambda p: jpol._cap(
            JPolicyContext(node=None, penalty=p, params=None))))(pens))
        got = tpol._cap(PolicyContext(node=None,
                                      penalty=torch.from_numpy(pens),
                                      params=None)).numpy()
        np.testing.assert_array_equal(got, want)


def test_migrate_kernel_inputs_equal_feasible_and_score():
    pol = MigratePolicy(margin_scale=0.1)
    gen = torch.Generator().manual_seed(0)
    u = lambda *shape: torch.rand(shape, generator=gen)
    params = FlexParams.default(device="cpu")
    # a third of the rows carry DRAIN_LOAD, as the pass's sources do
    drained = (u(40) < 0.3)[:, None] * 1e6
    node = NodeState(u(40, 2) * 0.5, u(40, 2) * 0.1 + drained, u(40, 2),
                     (u(40) * 8).int(), (u(40, 64) * 3).int())
    for penalty in (1.0, 1.7, 4.0):
        ctx = PolicyContext(node=node, penalty=torch.tensor(penalty),
                            params=params)
        for k in range(6):
            task = TaskView(u(2) * 0.3, torch.tensor(k * 7, dtype=torch.int32),
                            torch.tensor(k % 3, dtype=torch.int32))
            ki = pol.kernel_inputs(ctx, task)
            load = fma(ki.penalty, ki.est_usage, ki.reserved)
            feas = (load + task.request <= ki.cap).all(dim=-1)
            assert torch.equal(feas, pol.feasible(ctx, task))
            assert not feas[drained[:, 0] > 0].any()
            score = -fma(ki.w_load, load.max(dim=-1).values,
                         ki.w_src * ki.src_frac)
            assert torch.equal(score[feas], pol.score(ctx, task)[feas])


@pytest.fixture(scope="module")
def migration_trace():
    return jax_generate(2, FULL_N, FULL_S, 1.4)


@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_migration_run_matches_reference(migration_trace, mode):
    """Drains, hot nodes drained by their estimate and a target margin,
    with pool overflow, at 64 nodes."""
    jcfg = JSimConfig(**FULL_BASE, faults=JFaultConfig(warn_slots=3),
                      migration=JMigrationConfig(
                          bandwidth=12, pool_size=24, migrate_cost=2,
                          overload_threshold=0.6, margin_scale=0.05))
    sched = j_inject.crash_burst(FULL_S, FULL_N, slot=5, frac=0.3,
                                 duration=6, warn_slots=3)
    jres, truns = both_runs(migration_trace, jcfg, "flex-f", sched=sched,
                            use_kernel=(False, True), cache="migration",
                            admission_mode=mode)
    for tres in truns:
        assert_same(jres, tres, requested=False)
    m = truns[0].metrics
    assert int(m.n_migrated[-1]) > 0 and int(m.n_migration_failed[-1]) > 0
    # the port's schedule conversion keeps the drain table
    assert fault_schedule_from_numpy(sched, device="cpu").draining.any()
