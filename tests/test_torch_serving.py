"""The port's serving engine and request stream against the JAX reference.

The same requests go through both engines with the stub decode, in every
admission mode, for flex, reserve and two registry policies.  Residents,
queue order, counters, admission and eviction order must be exactly
equal step by step.  The QoS, penalty and utilization series are equal
bit for bit: QoS and utilization are the same float64 host arithmetic on
both sides, and the penalty update's only fused-looking expression, ``p +
beta * (p - 1)``, rounds once whether fused or not at the default beta of
1.  The engine invariants of ``tests/test_serving_engine.py`` are
mirrored on the port.  ``RequestStream`` and ``arrival_counts`` are numpy
on both sides and must be bit-identical.
"""
import numpy as np
import pytest
import torch

from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.stream import RequestStream as JRequestStream
from repro.serving.stream import StreamConfig as JStreamConfig
from repro.traces.generator import arrival_counts as j_arrival_counts
from repro_torch.serving import (ADMISSION_MODES, AdmissionPolicy,
                                 EngineConfig, Request, RequestStream,
                                 ServeEngine, StreamConfig,
                                 resolve_engine_policy)
from repro_torch.traces import ARRIVAL_PATTERNS, arrival_counts

torch.set_num_threads(1)

POLICIES = ["flex", "reserve", "flex-priority", "best-fit-usage"]


def _workload(n, seed):
    """(rid, prompt, declared, true, src, priority) rows: three clients in
    four declare honestly, so usage-based admission overflows, evicts and
    drives the penalty up."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        true = int(rng.integers(20, 60))
        over = float(rng.choice([1.0, 1.0, 1.0, 2.0]))
        rows.append((i, int(rng.integers(10, 40)), int(true * over), true,
                     int(rng.integers(0, 8)), int(rng.integers(0, 2))))
    return rows


_PARITY = dict(n_replicas=3, kv_budget_tokens=300, max_active_per_replica=6,
               admit_batch=16)


def _trajectory(engine_cls, request_cls, cfg, rows, steps, **kw):
    eng = engine_cls(cfg, **kw)
    log = []
    eng.on_admit = lambda r: log.append(("admit", r.rid, r.replica))
    eng.on_evict = lambda r: log.append(("evict", r.rid))
    for row in rows:
        eng.submit(request_cls(*row))
    states = []
    for _ in range(steps):
        eng.step()
        states.append((
            {i: [(r.rid, r.generated, r.evictions) for r in rs]
             for i, rs in eng.active.items()},
            [r.rid for r in eng.queue],
            eng.stats.admitted, eng.stats.finished,
            eng.stats.evicted_events, eng.stats.tokens_generated,
            eng.stats.decisions))
    return eng.stats, log, states


@pytest.mark.parametrize("mode", ADMISSION_MODES)
@pytest.mark.parametrize("policy", POLICIES)
def test_engine_matches_reference(policy, mode):
    kw = dict(_PARITY, policy=policy, admission_mode=mode)
    rows = _workload(36, seed=POLICIES.index(policy))
    js, jlog, jstates = _trajectory(JServeEngine, JRequest,
                                    JEngineConfig(**kw), rows, 50)
    ts, tlog, tstates = _trajectory(ServeEngine, Request, EngineConfig(**kw),
                                    rows, 50, device="cpu")
    assert tlog == jlog                  # admission and eviction order
    for step, (t, j) in enumerate(zip(tstates, jstates)):
        assert t == j, f"step {step}"
    assert ts.qos_series == js.qos_series
    assert ts.penalty_series == js.penalty_series
    assert ts.util_series == js.util_series
    assert js.finished > 0


def test_engine_with_quantile_estimator_matches_reference():
    """The engine judges replicas by the sliding-window quantile of their
    measured usage; step for step as the reference."""
    kw = dict(_PARITY, policy="flex", estimator="quantile")
    rows = _workload(36, seed=5)
    js, jlog, jstates = _trajectory(JServeEngine, JRequest,
                                    JEngineConfig(**kw), rows, 50)
    ts, tlog, tstates = _trajectory(ServeEngine, Request, EngineConfig(**kw),
                                    rows, 50, device="cpu")
    assert tlog == jlog
    for step, (t, j) in enumerate(zip(tstates, jstates)):
        assert t == j, f"step {step}"
    assert ts.qos_series == js.qos_series
    assert ts.penalty_series == js.penalty_series
    assert ts.util_series == js.util_series
    assert js.finished > 0 and js.evicted_events > 0


@pytest.mark.parametrize("policy", ["flex", "flex-priority",
                                    "best-fit-usage"])
def test_parity_workload_evicts(policy):
    """The parity workload makes usage-based policies evict, and the
    penalty controller raise P above its initial 1.5."""
    eng = ServeEngine(EngineConfig(**_PARITY, policy=policy), device="cpu")
    for row in _workload(36, seed=POLICIES.index(policy)):
        eng.submit(Request(*row))
    stats = eng.run(50)
    assert stats.evicted_events > 0
    assert max(stats.penalty_series) > 1.5


@pytest.mark.parametrize("pattern", ARRIVAL_PATTERNS)
def test_arrival_counts_bit_identical(pattern):
    a = arrival_counts(3, 200, 4.5, pattern, diurnal_period=50)
    b = j_arrival_counts(3, 200, 4.5, pattern, diurnal_period=50)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_arrival_counts_unknown_pattern():
    with pytest.raises(ValueError, match="unknown arrival pattern"):
        arrival_counts(0, 10, 1.0, "bursty")


@pytest.mark.parametrize("pattern", ARRIVAL_PATTERNS)
def test_request_stream_bit_identical(pattern):
    kw = dict(pattern=pattern, mean_rate=3.0, shock_start=5, shock_len=4,
              shock_mult=3.0, seed=7)
    ts, js = (RequestStream(StreamConfig(**kw), horizon=40),
              JRequestStream(JStreamConfig(**kw), horizon=40))
    assert np.array_equal(ts.counts, js.counts)
    fields = ("rid", "prompt_len", "max_tokens", "true_tokens", "src",
              "priority")
    for t in range(42):
        got = [tuple(getattr(r, f) for f in fields) for r in ts.step(t)]
        want = [tuple(getattr(r, f) for f in fields) for r in js.step(t)]
        assert got == want
    assert ts.submitted == js.submitted


def test_stream_drives_engine_like_reference():
    scfg = dict(pattern="burst", mean_rate=2.0, prompt_mean=12,
                max_tokens_mean=24, seed=1)
    ecfg = dict(n_replicas=2, kv_budget_tokens=256, max_active_per_replica=4)
    ts = RequestStream(StreamConfig(**scfg), horizon=30).drive(
        ServeEngine(EngineConfig(**ecfg), device="cpu"))
    js = JRequestStream(JStreamConfig(**scfg), horizon=30).drive(
        JServeEngine(JEngineConfig(**ecfg)))
    assert (ts.admitted, ts.finished, ts.evicted_events) == \
        (js.admitted, js.finished, js.evicted_events)
    assert ts.penalty_series == js.penalty_series


# ---------------------------------------------------------------------------
# the invariants of tests/test_serving_engine.py, on the port
# ---------------------------------------------------------------------------

def _reqs(n, over=3.0, true=20, prompt=20):
    return [Request(rid=i, prompt_len=prompt, max_tokens=int(true * over),
                    true_tokens=true) for i in range(n)]


def _engine(policy, **kw):
    return ServeEngine(EngineConfig(n_replicas=2, kv_budget_tokens=400,
                                    policy=policy, max_active_per_replica=32,
                                    **kw), device="cpu")


def _overflow_engine():
    eng = ServeEngine(EngineConfig(n_replicas=1, kv_budget_tokens=300,
                                   policy="flex", max_active_per_replica=16),
                      device="cpu")
    for r in _reqs(12, over=1.0, true=60, prompt=40):
        eng.submit(r)
    return eng


def test_flex_admits_more_than_reserve():
    concurrent = {}
    for pol in (AdmissionPolicy.RESERVE, AdmissionPolicy.FLEX):
        eng = _engine(pol)
        for r in _reqs(64, true=30):
            eng.submit(r)
        peak = 0
        for _ in range(8):
            eng.step()
            peak = max(peak, sum(len(v) for v in eng.active.values()))
        concurrent[pol] = peak
    assert concurrent[AdmissionPolicy.FLEX] > \
        concurrent[AdmissionPolicy.RESERVE]


def test_reserve_never_evicts():
    eng = _engine(AdmissionPolicy.RESERVE)
    for r in _reqs(64):
        eng.submit(r)
    stats = eng.run(200)
    assert stats.evicted_events == 0
    assert stats.finished == 64


def test_straggler_avoidance():
    eng = _engine(AdmissionPolicy.FLEX)
    eng.step_time_ema = np.asarray([1.0, 10.0])   # replica 1 is slow
    for r in _reqs(8):
        eng.submit(r)
    eng.step()
    assert len(eng.active[0]) > len(eng.active[1])


def test_eviction_order_newest_admission_first():
    admit_order, evict_log = [], []
    eng = _overflow_engine()
    eng.on_admit = lambda r: admit_order.append(r.rid)
    eng.on_evict = lambda r: evict_log.append(
        (r.rid, [q.rid for q in eng.active[0]]))
    eng.run(60)
    assert evict_log
    seniority = {rid: k for k, rid in enumerate(admit_order)}
    for rid, residents_after in evict_log:
        assert all(seniority[q] <= seniority[rid] for q in residents_after)


def test_evicted_requests_requeue_fifo_stable():
    eng = _overflow_engine()
    evicted = []
    eng.on_evict = lambda r: evicted.append(r.rid)
    seen = False
    for _ in range(60):
        evicted.clear()
        head_before = [r.rid for r in eng.queue]
        eng.step()
        if evicted:
            seen = True
            victims = [r for r in eng.queue if r.rid in set(evicted)]
            assert all(r.generated == 0 and r.replica == -1 and not r.done
                       for r in victims)
            rids = [r.rid for r in eng.queue]
            assert rids[:len(evicted)] == sorted(evicted)
            assert rids[len(evicted):] == head_before
    assert seen


def test_eviction_counters_monotone_and_no_done_resident():
    eng = _overflow_engine()
    per_req_max, last = {}, 0
    for _ in range(60):
        eng.step()
        assert eng.stats.evicted_events >= last
        last = eng.stats.evicted_events
        for i, reqs in eng.active.items():
            for r in reqs:
                assert not r.done and r.replica == i
        for r in eng.queue:
            assert not r.done and r.replica == -1
        for reqs in list(eng.active.values()) + [list(eng.queue)]:
            for r in reqs:
                assert r.evictions >= per_req_max.get(r.rid, 0)
                per_req_max[r.rid] = r.evictions
    assert last > 0 and last == sum(per_req_max.values())


def test_policy_resolution_and_errors():
    assert resolve_engine_policy("flex").name == "flex-f"
    assert resolve_engine_policy(AdmissionPolicy.FLEX).name == "flex-f"
    assert resolve_engine_policy("reserve").name == "least-fit"
    assert resolve_engine_policy("flex-priority").name == "flex-priority"
    with pytest.raises(KeyError, match="registered"):
        ServeEngine(EngineConfig(n_replicas=2, policy="flex-typo"),
                    device="cpu")
    with pytest.raises(ValueError, match="admission_mode"):
        ServeEngine(EngineConfig(n_replicas=2, admission_mode="batchy"),
                    device="cpu")
