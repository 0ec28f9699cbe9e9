"""A study's seeds and sweep points as one simulation with a run axis.

``Experiment.run(seeds=..., sweep=...)`` runs its P sweep points x S
seeds as B = P S runs of one slot loop (``core.simulator.simulate_runs``).
Here, on the CPU at small sizes:

  (a) the batched run against the port's own loop of single runs, every
      leaf bit for bit, under ``GeneratorNoise`` and ``ReplayNoise``: the
      four quickstart policies in both admission modes, the estimators,
      reclamation, and faults with migration, the guard, backoff and
      jitter;
  (b) the batched run against the reference's ``vmap``ped
      ``Experiment.run`` under replayed noise (the reference's sampled
      fault schedule and jitter table replayed per seed): placements,
      admit slots, ``n_rejected`` and the penalty exactly, usage to 1e-6;
  (c) runs whose wavefront queues finish in different rounds, and runs
      with an empty queue, against each run admitted alone;
  (d) the counters: decisions, queues, rounds and sweeps sum to the
      loop's, one queue-kernel launch serves every run's queue, and the
      launchers pass the run count to the kernels on "card" tensors with
      the library faked;
  (e) the run-axis plain versions of the four kernels, per run bit-equal
      to their unbatched plain versions and to the reference's oracles.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Experiment as JExperiment
from repro.api import admission as j_adm
from repro.api import get_policy as j_get_policy
from repro.core import SimConfig as JSimConfig
from repro.core.types import FlexParams as JFlexParams
from repro.core.types import NodeState as JNodeState
from repro.faults import FaultConfig as JFaultConfig
from repro.faults import injection as j_inject
from repro.guard import GuardConfig as JGuardConfig
from repro.kernels.flex_score.ref import pick_node_batch_ref as j_batch_ref
from repro.kernels.flex_score.ref import \
    pick_node_batch_topk_ref as j_topk_ref
from repro.kernels.flex_score.ref import pick_node_ref as j_pick_ref
from repro.migration import MigrationConfig as JMigrationConfig
from repro.traces import generate_calibrated as jax_generate
from repro_torch.api import Experiment, admission, get_policy
from repro_torch.api.policies import FlexFifoPolicy
from repro_torch.convert import (fault_schedule_from_numpy,
                                 noise_table_from_numpy, taskset_from_numpy)
from repro_torch.core import SimConfig
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from repro_torch.core.types import NUM_SRC_BUCKETS, FlexParams, NodeState
from repro_torch.estimators import CurrentEstimator, QuantileWindowEstimator
from repro_torch.estimators.base import EstimatorState
from repro_torch.estimators.learned import LearnedUsageEstimator, mlp_init
from repro_torch.faults import FaultConfig, sample_schedule
from repro_torch.guard import GuardConfig
from repro_torch.kernels.flex_score import flex_score as fs
from repro_torch.kernels.flex_score import ops
from repro_torch.kernels.flex_score.ref import (admit_queue_ref,
                                                pick_node_batch_ref,
                                                pick_node_batch_topk_ref,
                                                pick_node_ref)
from repro_torch.migration import MigrationConfig

torch.set_num_threads(1)

SMALL = dict(n_nodes=16, n_slots=12, arrivals_per_slot=64, retry_capacity=32)
# The loop comparisons run SMALL's first 6 slots: each case is 5 runs.
SHORT = dict(SMALL, n_slots=6)
SEEDS = [0, 1]
_FAULT_STREAM, _JITTER_STREAM = 0x7FFFFFFF, 0x7FFFFFFE


def _sweep(device="cpu"):
    return [FlexParams.default(device=device),
            FlexParams.default(alpha=0.95, w_src=0.5, theta=1.5,
                               device=device)]


def _jsweep():
    return [JFlexParams.default(),
            JFlexParams.default(alpha=0.95, w_src=0.5, theta=1.5)]


@pytest.fixture(scope="module")
def trace():
    jts = jax_generate(0, SMALL["n_nodes"], SMALL["n_slots"], 1.6)
    ts = taskset_from_numpy({k: np.asarray(v) for k, v in
                             jts._asdict().items()}, device="cpu")
    return jts, ts


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _leaves(res):
    yield from ((f, getattr(res, f)) for f in res._fields
                if f != "metrics")
    yield from ((f"metrics.{f}", getattr(res.metrics, f))
                for f in res.metrics._fields)


def _assert_rows_equal(batched, rows):
    """Every leaf of run (p, s) of ``batched`` (leaves (P, S, ...)) equals
    ``rows[p][s]``'s, dtype, shape and bits."""
    for p, row in enumerate(rows):
        for s, one in enumerate(row):
            for (name, got), (_, want) in zip(_leaves(batched),
                                              _leaves(one)):
                got = got[p, s]
                assert got.dtype == want.dtype, name
                assert got.shape == want.shape, name
                assert torch.equal(_bits(got), _bits(want)), \
                    f"run ({p}, {s}): {name}"


def _loop(exp, sweep):
    """The port's loop of single runs: one Experiment.run per pair."""
    return [[exp.run(seeds=s, sweep=[p]) for s in SEEDS] for p in sweep]


def _unwrap(res):
    """A run's (1, ...) leaves as its own."""
    return type(res)(*(type(x)(*(y[0] for y in x)) if hasattr(x, "_fields")
                       else x[0] for x in res))


def _check_batched(exp, sweep=None):
    sweep = sweep or _sweep()
    batched = exp.run(seeds=SEEDS, sweep=sweep)
    rows = [[_unwrap(r) for r in row] for row in _loop(exp, sweep)]
    _assert_rows_equal(batched, rows)
    assert int((batched.placement >= 0).sum()) > 0
    return batched


def _replay(ts, n_slots):
    tables = {s: np.random.default_rng(100 + s).standard_normal(
        (n_slots, ts.num_tasks)).astype(np.float32) for s in SEEDS}
    return lambda s: noise_table_from_numpy(tables[s], device="cpu")


def _generator(seed):
    return GeneratorNoise(seed, "cpu")


@dataclasses.dataclass(frozen=True)
class PickOnly(FlexFifoPolicy):
    """flex-f without the queue kernel's hook: one pick a decision step."""

    name = "pick-only"
    queue_kernel_rows = None


# ---------------------------------------------------------------------------
# (a) batched against the port's own loop
# ---------------------------------------------------------------------------

# The wavefront takes the batched kernels whatever use_kernel says.
POLICY_CASES = [(name, uk, mode) for mode in ("sequential", "wavefront")
                for name, uk in (("flex-f", True), ("flex-f", False),
                                 ("flex-l", True), ("flex-l", False),
                                 ("least-fit", False), ("oversub", False))
                if uk or mode == "sequential" or name in ("least-fit",
                                                          "oversub")]


@pytest.mark.parametrize("noise", ["generator", "replay"])
@pytest.mark.parametrize("name,use_kernel,mode", POLICY_CASES)
def test_policies_batched_equal_loop(trace, name, use_kernel, mode, noise):
    _, ts = trace
    cfg = SimConfig(**SHORT, use_kernel=use_kernel, admission_mode=mode)
    source = _generator if noise == "generator" else _replay(ts,
                                                             cfg.n_slots)
    res = _check_batched(Experiment(ts, cfg, name, device="cpu",
                                    noise=source))
    assert int(res.metrics.n_rejected[..., -1].max()) > 0   # contended


def _trained_learned():
    gen = torch.Generator().manual_seed(3)
    params = mlp_init(4, 6, generator=gen, device="cpu")
    params["w2"] = torch.randn((6, 1), generator=gen) * 0.1
    params["b2"] = torch.full((1,), 0.01)
    return LearnedUsageEstimator.from_params(params, 4, 6)


@dataclasses.dataclass(frozen=True)
class _PeakHold:
    """An estimator without a run axis: the simulator refreshes it run by
    run."""

    decay: float = 0.9

    def init_state(self, n_nodes, n_resources=2, *, device="cpu"):
        return EstimatorState(est=torch.zeros((n_nodes, n_resources),
                                              device=device))

    def refresh(self, state, node_usage, draw):
        return EstimatorState(est=torch.maximum(state.est * self.decay,
                                                node_usage))


ESTIMATORS = {
    "per-run": _PeakHold,
    "quantile": lambda: QuantileWindowEstimator(window=3, q=0.8),
    "ewma": lambda: "ewma",
    "learned": _trained_learned,
    "noisy-current": lambda: CurrentEstimator(noise_std=0.2),
}


# A noisy estimator draws a stream that replay does not hold: generator only.
ESTIMATOR_CASES = [(kind, noise) for kind in sorted(ESTIMATORS)
                   for noise in ("generator", "replay")
                   if (kind, noise) != ("noisy-current", "replay")]


@pytest.mark.parametrize("kind,noise", ESTIMATOR_CASES)
def test_estimators_batched_equal_loop(trace, kind, noise):
    _, ts = trace
    cfg = SimConfig(**SHORT, use_kernel=True)
    source = _generator if noise == "generator" else _replay(ts,
                                                             cfg.n_slots)
    _check_batched(Experiment(ts, cfg, "flex-f", device="cpu",
                              estimator=ESTIMATORS[kind](), noise=source))


@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_reclamation_batched_equal_loop(trace, mode):
    _, ts = trace
    cfg = SimConfig(**SHORT, use_kernel=True, admission_mode=mode,
                    reclamation=True, reclaim_pool=24, max_retries=1)
    res = _check_batched(Experiment(ts, cfg, "least-fit", device="cpu",
                                    noise=_generator))
    assert int(res.metrics.n_reclaimed[..., -1].sum()) > 0


class _ScheduleNoise(ReplayNoise):
    """Replayed demand and jitter, and a fault schedule of the test's."""

    def __init__(self, table, jitter, schedule):
        super().__init__(table, jitter)
        self.schedule = schedule

    def faults(self, fcfg, n_slots, n_nodes):
        return self.schedule


FAULT_RATES = dict(crash_rate=0.08, flap_rate=0.05, flap_capacity=0.5,
                   surge_rate=0.2, surge_mult=2.0, warn_slots=2,
                   crash_duration=3, degrade=True, qos_window=3,
                   degrade_evict=6)


def _fault_cfg(mode, **kw):
    return SimConfig(**SHORT, use_kernel=True, admission_mode=mode,
                     faults=FaultConfig(**FAULT_RATES),
                     migration=MigrationConfig(bandwidth=4, pool_size=8),
                     guard=GuardConfig(window=3, trip_threshold=0.05,
                                       cooldown=2, probe_slots=2,
                                       probe_reclaim=3),
                     reclamation=True, reclaim_pool=24, estimator="ewma",
                     retry_backoff=1, retry_jitter=2, **kw)


@pytest.mark.parametrize("noise", ["generator", "replay"])
@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_faults_batched_equal_loop(trace, mode, noise):
    _, ts = trace
    cfg = _fault_cfg(mode)
    if noise == "generator":
        source = _generator
    else:
        tables = _replay(ts, cfg.n_slots)

        def source(seed):
            gen = torch.Generator().manual_seed(7 + seed)
            sched = sample_schedule(cfg.faults, gen, cfg.n_slots,
                                    cfg.n_nodes)
            jitter = torch.randint(0, 3, (ts.num_tasks,), generator=gen,
                                   dtype=torch.int32)
            return _ScheduleNoise(tables(seed).table, jitter, sched)
    res = _check_batched(Experiment(ts, cfg, "flex-brownout", device="cpu",
                                    noise=source))
    m = res.metrics
    assert int(m.n_fault_evicted[..., -1].sum()) > 0
    assert int(m.n_migrated[..., -1].sum()) > 0
    assert (m.guard_tripped == 1).any()


# ---------------------------------------------------------------------------
# (b) batched against the reference's vmapped Experiment
# ---------------------------------------------------------------------------

def _jax_tables(n_slots, n_tasks):
    out = {}
    for s in SEEDS:
        key = jax.random.PRNGKey(s)
        out[s] = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key, t), (n_tasks,), jnp.float32))
            for t in range(n_slots)])
    return out


def _assert_matches_reference(jres, tres):
    for name in ("placement", "admit_slot"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    for name in ("n_rejected", "penalty"):
        np.testing.assert_array_equal(
            getattr(tres.metrics, name).numpy(),
            np.asarray(getattr(jres.metrics, name)), err_msg=name)
    np.testing.assert_allclose(tres.metrics.usage.numpy(),
                               np.asarray(jres.metrics.usage), rtol=1e-6,
                               atol=1e-6)


REFERENCE_CASES = {
    # name: (policy, reference config fields, the port's runs)
    "flex-f": ("flex-f", {}, [dict(use_kernel=True),
                              dict(use_kernel=False),
                              dict(admission_mode="wavefront")]),
    "flex-l": ("flex-l", dict(estimator="ewma"), [
        dict(use_kernel=True), dict(admission_mode="wavefront")]),
    "least-fit": ("least-fit", {}, [dict(),
                                    dict(admission_mode="wavefront")]),
    "oversub": ("oversub", {}, [dict()]),
    "faults": ("flex-f", dict(
        faults="rates", migration=dict(bandwidth=4, pool_size=8),
        guard=dict(window=3, trip_threshold=0.05, cooldown=2, probe_slots=2,
                   probe_reclaim=3),
        reclamation=True, reclaim_pool=24, estimator="quantile",
        retry_backoff=1, retry_jitter=2),
        [dict(use_kernel=True), dict(admission_mode="wavefront")]),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_batched_matches_reference_vmap(trace, case):
    jts, ts = trace
    policy, fields, port_runs = REFERENCE_CASES[case]
    jfields, tfields = dict(fields), dict(fields)
    if "faults" in fields:
        jfields["faults"] = JFaultConfig(**FAULT_RATES)
        tfields["faults"] = FaultConfig(**FAULT_RATES)
        jfields["migration"] = JMigrationConfig(**fields["migration"])
        tfields["migration"] = MigrationConfig(**fields["migration"])
        jfields["guard"] = JGuardConfig(**fields["guard"])
        tfields["guard"] = GuardConfig(**fields["guard"])
    jcfg = JSimConfig(**SMALL, **jfields)
    jres = JExperiment(jts, jcfg, policy).run(seeds=SEEDS, sweep=_jsweep())
    tables = _jax_tables(jcfg.n_slots, ts.num_tasks)

    def source(seed):
        key = jax.random.PRNGKey(seed)
        jitter = None
        if jcfg.retry_jitter:
            jitter = torch.from_numpy(np.asarray(j_inject.jitter_table(
                jax.random.fold_in(key, _JITTER_STREAM), ts.num_tasks,
                jcfg.retry_jitter)).astype(np.int32))
        table = torch.from_numpy(tables[seed])
        if jcfg.faults is None:
            return ReplayNoise(table, jitter)
        sched = j_inject.sample_schedule(
            jcfg.faults, jax.random.fold_in(key, _FAULT_STREAM),
            jcfg.n_slots, jcfg.n_nodes)
        return _ScheduleNoise(table, jitter,
                              fault_schedule_from_numpy(sched, device="cpu"))

    for kw in port_runs:
        cfg = SimConfig(**SMALL, **tfields)._replace(**kw)
        tres = Experiment(ts, cfg, policy, device="cpu", noise=source).run(
            seeds=SEEDS, sweep=_sweep())
        _assert_matches_reference(jres, tres)
    assert int((tres.placement >= 0).sum()) > 0


# ---------------------------------------------------------------------------
# (c) ragged queues: different rounds, empty queues
# ---------------------------------------------------------------------------

def _node(n, seed):
    rng = np.random.default_rng(seed)
    return NodeState(
        est_usage=torch.from_numpy((rng.random((n, 2)) * 0.6)
                                   .astype(np.float32)),
        reserved=torch.zeros((n, 2)),
        requested=torch.from_numpy((rng.random((n, 2)) * 0.5)
                                   .astype(np.float32)),
        n_tasks=torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)),
        src_count=torch.from_numpy(rng.integers(
            0, 2, (n, NUM_SRC_BUCKETS)).astype(np.int32)))


def _tasks(q, seed, dup=False):
    rng = np.random.default_rng(seed + 1)
    reqs = (rng.random((q, 2)) * 0.3).astype(np.float32)
    srcs = rng.integers(0, 6, q).astype(np.int32)
    if dup:   # few distinct rows: the score-bucket dedup applies
        reqs = reqs[rng.integers(0, 3, q)]
        srcs = srcs[:1].repeat(q)
    return (torch.from_numpy(reqs), torch.from_numpy(srcs),
            torch.from_numpy(rng.integers(0, 3, q).astype(np.int32)))


def _ragged(lens, n=24, dup=False):
    """Run b: its own node state and a queue of lens[b] tasks, padded to
    the longest with invalid entries."""
    q = max(lens)
    nodes, queues = [], []
    for b, length in enumerate(lens):
        nodes.append(_node(n, 10 + b))
        reqs, srcs, prios = _tasks(q, 20 + b, dup)
        queues.append((reqs, srcs, prios, torch.arange(q) < length))
    node = NodeState(*(torch.stack(x) for x in zip(*nodes)))
    queue = [torch.stack(x) for x in zip(*queues)]
    return nodes, queues, node, queue


RAGGED = [(0, 9, 40), (40, 0, 1), (17, 40, 3), (0, 0, 0)]


@pytest.mark.parametrize("lens", RAGGED)
@pytest.mark.parametrize("how", ["queue-kernel", "plain", "pick-kernel",
                                 "wavefront-8", "wavefront-0",
                                 "wavefront-dedup"])
def test_ragged_queues_equal_each_run_alone(lens, how):
    policy = {"plain": get_policy("least-fit"),
              "pick-kernel": PickOnly()}.get(how, get_policy("flex-f"))
    dup = how == "wavefront-dedup"
    nodes, queues, node, queue = _ragged(lens, dup=dup)
    sweep = _sweep()
    params = FlexParams(*(torch.stack(x) for x in zip(*[sweep[b % 2]
                                                       for b in range(3)])))
    penalty = torch.tensor([1.0, 1.3, 1.7])
    kw = dict(use_kernel=how != "plain",
              batch_mode=how.startswith("wavefront"),
              topk=0 if how == "wavefront-0" else 8,
              dedup_buckets=4 if dup else 0)
    admission.reset_decisions()
    got_node, got = admission.admit_queue(policy, node, *queue, penalty,
                                          params, lens=list(lens), **kw)
    counts = (admission.DECISIONS, admission.QUEUES, admission.ROUNDS,
              admission.SWEEPS, admission.DEDUP_SWEEPS)
    admission.reset_decisions()
    for b, length in enumerate(lens):
        one = FlexParams(*(x[b] for x in params))
        cut = [x[:length] for x in queues[b]]
        want_node, want = admission.admit_queue(policy, nodes[b], *cut,
                                                penalty[b], one, **kw)
        assert torch.equal(got[b, :length], want), (b, "placements")
        assert (got[b, length:] == -1).all(), (b, "padding")
        for field, a, w in zip(NodeState._fields, got_node, want_node):
            assert torch.equal(_bits(a[b]), _bits(w)), (b, field)
    assert counts[:4] == (admission.DECISIONS, admission.QUEUES,
                          admission.ROUNDS, admission.SWEEPS)
    if dup and max(lens) > 4:
        assert counts[4] > 0


def test_wavefront_runs_finish_in_different_rounds():
    nodes, queues, node, queue = _ragged((3, 40, 12))
    params = FlexParams(*(x.expand(3).clone()
                          for x in FlexParams.default(device="cpu")))
    penalty = torch.tensor([1.0, 2.5, 1.2])
    _, _, rounds, sweeps = admission.admit_queue_wavefront(
        get_policy("flex-f"), node, *queue, penalty, params, topk=2,
        dedup_buckets=0, with_rounds=True, lens=[3, 40, 12])
    alone = [admission.admit_queue_wavefront(
        get_policy("flex-f"), nodes[b], *(x[:n] for x in queues[b]),
        penalty[b], FlexParams.default(device="cpu"), topk=2,
        dedup_buckets=0, with_rounds=True)[2:]
        for b, n in enumerate((3, 40, 12))]
    assert [list(x) for x in zip(rounds, sweeps)] == [list(x) for x in alone]
    assert len(set(rounds)) > 1       # the runs finish in different rounds


# ---------------------------------------------------------------------------
# (d) counters and launches
# ---------------------------------------------------------------------------

COUNTERS = ("DECISIONS", "QUEUES", "ROUNDS", "SWEEPS")


@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_counters_sum_to_the_loop(trace, mode):
    _, ts = trace
    cfg = SimConfig(**SHORT, use_kernel=True, admission_mode=mode,
                    reclamation=True, reclaim_pool=24)
    exp = Experiment(ts, cfg, "flex-f", device="cpu", noise=_generator)
    admission.reset_decisions()
    exp.run(seeds=SEEDS, sweep=_sweep())
    batched = [getattr(admission, c) for c in COUNTERS]
    admission.reset_decisions()
    _loop(exp, _sweep())
    assert batched == [getattr(admission, c) for c in COUNTERS]
    assert batched[0] > 0 and (mode == "sequential" or batched[2] > 0)


def _counting(monkeypatch, name, plain):
    """ops.<name> replaced by its plain version, counting calls, with the
    dispatch sent to the card path."""
    calls = []

    def fake(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(ops, "_device_kind", lambda caller, est: "cuda")
    monkeypatch.setattr(ops, name, fake)
    return calls


def test_one_queue_kernel_launch_serves_every_run(trace, monkeypatch):
    _, ts = trace
    calls = _counting(monkeypatch, "flex_score_admit", admit_queue_ref)
    launched = lambda: [c for c in calls if c[5].shape[-2] > 0]
    cfg = SimConfig(**SHORT, use_kernel=True)
    exp = Experiment(ts, cfg, "flex-f", device="cpu", noise=_generator)
    admission.reset_decisions()
    res = exp.run(seeds=SEEDS, sweep=_sweep())
    batched, queues = launched(), admission.QUEUES
    assert 0 < len(batched) <= SHORT["n_slots"] < queues
    assert all(c[5].dim() == 3 and c[5].shape[0] == 4 for c in batched)
    calls.clear()
    admission.reset_decisions()
    loop = _loop(exp, _sweep())
    assert len(launched()) == admission.QUEUES == queues
    assert torch.equal(res.placement[1, 0], loop[1][0].placement[0])


def test_one_sweep_and_one_pick_launch_serve_every_run(trace, monkeypatch):
    _, ts = trace
    topk = _counting(monkeypatch, "flex_score_batch_topk",
                     lambda est, res, src, mat, k: pick_node_batch_topk_ref(
                         est, res, src, mat[..., :2], mat[..., 2],
                         mat[..., 4], mat[..., 5], mat[..., 3], k)[:2])
    cfg = SimConfig(**SHORT, admission_mode="wavefront")
    exp = Experiment(ts, cfg, "flex-f", device="cpu", noise=_generator)
    admission.reset_decisions()
    exp.run(seeds=SEEDS, sweep=_sweep())
    sweeps = admission.SWEEPS
    assert 0 < len(topk) < sweeps and all(c[0].shape[0] == 4 for c in topk)
    picks = _counting(monkeypatch, "flex_score_pick",
                      lambda est, res, src, vec: pick_node_ref(
                          est, res, src, vec[:, :2], vec[:, 2], vec[:, 4],
                          vec[:, 5], vec[:, 3])[:2])
    exp = Experiment(ts, SimConfig(**SHORT, use_kernel=True), PickOnly(),
                     device="cpu", noise=_generator)
    admission.reset_decisions()
    res = exp.run(seeds=SEEDS, sweep=_sweep())
    assert 0 < len(picks) < admission.DECISIONS
    assert all(c[0].shape[0] == 4 for c in picks)
    want = Experiment(ts, SimConfig(**SHORT), "flex-f", device="cpu",
                      noise=_generator).run(seeds=SEEDS, sweep=_sweep())
    assert torch.equal(res.placement, want.placement)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        consts = {"flex_score_admit_cluster": fs.ADMIT_CLUSTER,
                  "flex_score_admit_max_r": fs.ADMIT_MAX_R,
                  "flex_score_batch_max_r": 16,
                  "flex_score_batch_pass_slots": 32}
        if name in consts:
            return lambda: consts[name]
        if not name.startswith("flex_score"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fs._build, "load", lambda name: lib)
    monkeypatch.setattr(fs, "_ADMIT", {})
    monkeypatch.setattr(fs, "_BATCH", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream)
    fs.reset_launches()
    return lib


def _card(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)


@pytest.mark.parametrize("runs", [1, 3])
def test_launchers_pass_the_run_count(fake_lib, runs):
    n, q, r = 4000, 33, 2
    i32 = torch.int32
    est = _card(runs, n, r)
    placements = fs.flex_score_admit(
        est, _card(runs, n, r), _card(runs, n, r), _card(runs, n, dtype=i32),
        _card(runs, n, NUM_SRC_BUCKETS, dtype=i32), _card(runs, q, r + 4),
        _card(runs, q, dtype=i32), _card(runs, q, dtype=torch.bool))
    name, args = fake_lib.calls[-1]
    rows, on_chip, smem = fs.admit_plan(n, r)
    assert name == "flex_score_admit" and args[-1] == runs
    assert args[8:14] == (n, r, q, rows, int(on_chip), smem)
    assert placements.shape == (runs, q) and fs.QUEUE_LAUNCHES == 1

    idx, score = fs.flex_score_batch_pick(est, _card(runs, n, r),
                                          _card(runs, q, n),
                                          _card(runs, q, r + 4))
    name, args = fake_lib.calls[-1]
    chunk, splits, _ = fs.batch_plan(n, q, runs)
    assert args[4:8] == (n, r, q, chunk) and args[-1] == runs
    assert idx.shape == (runs, q) and fs.BATCH_LAUNCHES == 1
    assert fs.batch_plan(n, q * runs) == fs.batch_plan(n, q, runs)

    idx, score = fs.flex_score_batch_topk(est, _card(runs, n, r),
                                          _card(runs, q, n),
                                          _card(runs, q, r + 4), 8)
    name, args = fake_lib.calls[-1]
    assert args[4:9] == (n, r, q, 8, chunk) and args[-1] == runs
    assert idx.shape == (runs, q, 8) and fs.TOPK_LAUNCHES == 1

    idx, score = fs.flex_score_pick(est, _card(runs, n, r), _card(runs, n),
                                    _card(runs, r + 4))
    name, args = fake_lib.calls[-1]
    assert name == "flex_score_pick" and args[-1] == runs
    assert idx.shape == (runs,) and fs.LAUNCHES == 1
    assert len(fake_lib.calls) == 4


# ---------------------------------------------------------------------------
# (e) the run-axis plain versions
# ---------------------------------------------------------------------------

def _tables(runs, n, q, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.random(shape).astype(np.float32)
    est, res = f32(runs, n, 2) * 0.8, f32(runs, n, 2) * 0.1
    src = np.floor(f32(runs, q, n) * 4) / 4
    r = f32(runs, q, 2) * 0.3
    penalty = (1.0 + f32(runs, q)).astype(np.float32)
    cap = np.where(f32(runs, q) < 0.3, 0.6, 1.0).astype(np.float32)
    w_load = np.where(f32(runs, q) < 0.2, -1.0, 1.0).astype(np.float32)
    w_src = f32(runs, q)
    return est, res, src, r, penalty, w_load, w_src, cap


def _same(got, want):
    for a, w in zip(got, want):
        a, w = np.asarray(a), np.asarray(w)
        assert a.dtype == w.dtype and a.shape == w.shape
        if a.dtype == np.float32:
            a, w = a.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("n,q", [(5, 1), (64, 33)])
def test_run_axis_sweeps_equal_per_run_and_reference(n, q):
    runs = 3
    arrays = _tables(runs, n, q, n + q)
    t = [torch.from_numpy(x) for x in arrays]
    got = pick_node_batch_ref(*t)
    for b in range(runs):
        _same([x[b] for x in got],
              pick_node_batch_ref(*(x[b] for x in t)))
    _same(got, jax.jit(jax.vmap(j_batch_ref))(*arrays))
    for k in (1, 8):
        got = pick_node_batch_topk_ref(*t, k)
        for b in range(runs):
            _same([x[b] for x in got],
                  pick_node_batch_topk_ref(*(x[b] for x in t), k))
        want = jax.jit(jax.vmap(lambda *a: j_topk_ref(*a, k=k)))(*arrays)
        _same(got, want)


def test_run_axis_pick_equals_per_run_and_reference():
    runs, n = 4, 100
    est, res, src, r, penalty, w_load, w_src, cap = _tables(runs, n, 1, 5)
    args = (est, res, src[:, 0], r[:, 0], penalty[:, 0], w_load[:, 0],
            w_src[:, 0], cap[:, 0])
    t = [torch.from_numpy(x) for x in args]
    got = pick_node_ref(*t)
    for b in range(runs):
        _same([x[b] for x in got], pick_node_ref(*(x[b] for x in t)))
    _same(got, jax.jit(jax.vmap(j_pick_ref))(*args))


def test_run_axis_queue_equals_per_run_and_reference():
    runs, n, q = 3, 64, 33
    jpol = j_get_policy("flex-f")
    jp = jpol.prepare_params(JFlexParams.default())
    j_admit = jax.jit(lambda node, *xs: j_adm.admit_queue(
        jpol, node, *xs, jp, use_kernel=True, interpret=True))
    nodes, queues, node, queue = _ragged((q, 7, 0), n=n)
    tp = FlexParams.default(device="cpu")
    rows = [get_policy("flex-f").queue_kernel_rows(
        admission.PolicyContext(node=nodes[b], penalty=torch.tensor(1.25),
                                params=tp),
        admission.TaskView(*queues[b][:3])) for b in range(runs)]
    state = [x.clone() for x in node]
    got = admit_queue_ref(*state, torch.stack(rows), queue[1], queue[3])
    for b in range(runs):
        one = [x[b].clone() for x in node]
        want = admit_queue_ref(*one, rows[b], queue[1][b], queue[3][b])
        assert torch.equal(got[b], want)
        for a, w in zip(state, one):
            assert torch.equal(_bits(a[b]), _bits(w))
        j_node, j_pl = j_admit(
            JNodeState(*(jnp.asarray(x[b].numpy()) for x in node)),
            *(np.asarray(x[b]) for x in queue), np.float32(1.25))
        _same([got[b]], [j_pl])
        _same([x[b] for x in state], list(j_node))


def _fma_round_to_odd(a, b, c):
    """The float32 ``a * b + c`` rounded once, by another route: the
    float64 sum made round-to-odd through its bit view (an inexact sum
    with an even last bit moves one ulp toward its error), then rounded
    to nearest, which is the correctly rounded result."""
    a, b, c = (x.double() for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def test_fma_under_vmap_rounds_as_outside():
    """``fma`` (its midpoint test), outside ``vmap`` and under it, equals
    round-to-odd through the bit view bit for bit: random bit patterns,
    magnitudes from 1e-40 to 1e30, exact cancellation, and products that
    land exactly halfway between two float32 values."""
    from repro_torch.core.numerics import fma

    gen = torch.Generator().manual_seed(0)
    n = 1 << 18

    def bits():
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                             dtype=torch.int64).to(torch.int32).view(
            torch.float32)

    odd = lambda: (torch.randint(0, 500, (n,), generator=gen) * 2 + 1)
    halfway = [((1 + odd() * 2.0 ** -12).float(),
                (1 + odd() * 2.0 ** -12).float())]
    cases = [(bits(), bits(), bits())]
    for scale in (1e-40, 1e-3, 1.0, 1e30):
        a = (torch.randn(n, generator=gen) * scale).float()
        b = torch.randn(n, generator=gen)
        cases += [(a, b, (torch.randn(n, generator=gen) * scale).float()),
                  (a, b, -(a * b))]
    for a, b in halfway:
        p = a.double() * b.double()
        assert ((p.float().double() - p).abs() == 2.0 ** -24).all()
        for c in (0.0, 2.0 ** -60, -2.0 ** -60):
            cases += [(a, b, torch.full((n,), c)), (-a, b,
                                                    torch.full((n,), c))]
    # 0-d tensors and Python floats beside dimensioned tensors, on the
    # halfway products, which only a float64 product keeps
    a, b = halfway[0]
    c = torch.full((n,), 2.0 ** -60)
    for x, y, z in ((a[3], b, c), (a, b[3], c), (float(a[3]), b, c),
                    (a, float(b[3]), c), (a[3], b[3], c), (a, b, 2.0 ** -60),
                    (a, b, c[3]), (float(a[3]), float(b[3]), -c)):
        want = _fma_round_to_odd(*(torch.as_tensor(v, dtype=torch.float32)
                                   .expand(n) for v in (x, y, z)))
        assert torch.equal(fma(x, y, z).expand(n).view(torch.int32),
                           want.view(torch.int32))
    mapped = torch.func.vmap(fma)
    for a, b, c in cases:
        want = _fma_round_to_odd(a, b, c)
        for got in (fma(a, b, c), mapped(a.view(64, -1), b.view(64, -1),
                                          c.view(64, -1)).flatten()):
            same = got.view(torch.int32) == want.view(torch.int32)
            assert (same | (want.isnan() & got.isnan())).all()
