"""The port's core modules against the JAX reference.

Same numpy inputs through both.  The JAX side runs jitted, as the
simulator runs it (XLA fuses multiply-adds under jit, and the port
rounds at the same places).  Allocation, QoS, penalty and estimator
outputs must be bit-equal; the trace generator must give bit-identical
task sets for an equal seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocation as j_alloc
from repro.core import estimator as j_est
from repro.core import penalty as j_pen
from repro.core import qos as j_qos
from repro.core.simulator import build_arrival_table as j_table
from repro.core.types import ControllerState as JCtrl
from repro.core.types import FlexParams as JParams
from repro.traces import generator as j_gen
from repro_torch.convert import (node_state_from_numpy,
                                 noise_table_from_numpy, params_from_numpy,
                                 taskset_from_numpy)
from repro_torch.core import allocation, estimator, penalty, qos
from repro_torch.core.noise import GeneratorNoise, ReplayNoise
from repro_torch.core.numerics import fma, sqrt
from repro_torch.core.simulator import build_arrival_table
from repro_torch.core.types import ControllerState, FlexParams, NodeState
from repro_torch.estimators import get_estimator, list_estimators
from repro_torch.traces import generator

T_, N_ = 200, 12

# The tensors here are tiny: one intra-op thread is fastest, and keeps
# PyTorch's pool from contending with XLA's in the same process.
torch.set_num_threads(1)


def _eq(torch_out, jax_out):
    np.testing.assert_array_equal(torch_out.numpy(), np.asarray(jax_out))


def _alloc_inputs(case, seed=0):
    """Demand/request scales hitting allocation.py's three cases."""
    rng = np.random.default_rng(seed)
    scale = {"fits": (0.05, 0.15), "requests_fit": (0.2, 0.1),
             "oversubscribed": (0.3, 0.2)}[case]
    demand = (rng.random((T_, 2)) * scale[0]).astype(np.float32)
    request = (rng.random((T_, 2)) * scale[1] + 0.01).astype(np.float32)
    placement = rng.integers(-1, N_, T_).astype(np.int32)
    active = (placement >= 0) & (rng.random(T_) < 0.9)
    return demand, request, placement, active


@pytest.mark.parametrize("case", ["fits", "requests_fit", "oversubscribed"])
def test_wfs_allocate_matches(case):
    demand, request, placement, active = _alloc_inputs(case)
    jf = jax.jit(j_alloc.wfs_allocate, static_argnames=("num_nodes", "iters"))
    ja, ju = jf(demand, request, placement, active, num_nodes=N_)
    ta, tu = allocation.wfs_allocate(*map(torch.from_numpy, (
        demand, request, placement, active)), N_)
    _eq(ta, ja)
    _eq(tu, ju)
    sums = {}
    for name, x in (("d", demand), ("r", request)):
        sums[name] = np.zeros((N_, 2))
        np.add.at(sums[name], placement[active], x[active])
    d_over, r_over = sums["d"] > 1.0, sums["r"] > 1.0
    if case == "fits":
        assert not d_over.any()
    elif case == "requests_fit":
        assert (d_over & ~r_over).any()
    else:
        assert (d_over & r_over).any()


@pytest.mark.parametrize("iters", [1, 4])
def test_waterfill_matches(iters):
    rng = np.random.default_rng(iters)
    cap = (rng.random((N_, 2)) * 0.8 + 0.2).astype(np.float32)
    w = rng.random(T_).astype(np.float32)
    caps = (rng.random((T_, 2)) * 0.3).astype(np.float32)
    seg = rng.integers(0, N_, T_).astype(np.int32)
    mask = (rng.random(T_) < 0.8).astype(np.float32)
    jf = jax.jit(j_alloc.waterfill, static_argnames=("num_nodes", "iters"))
    want = jf(cap, w, caps, seg, mask, num_nodes=N_, iters=iters)
    got = allocation.waterfill(*map(torch.from_numpy, (cap, w, caps, seg,
                                                       mask)), N_, iters)
    _eq(got, want)


def test_segment_sum_matches_segment_sum():
    rng = np.random.default_rng(3)
    data = rng.random((5000, 2)).astype(np.float32)
    seg = rng.integers(0, 7, 5000).astype(np.int32)
    want = jax.jit(lambda d, s: jax.ops.segment_sum(d, s, 7))(data, seg)
    _eq(allocation.segment_sum(torch.from_numpy(data),
                               torch.from_numpy(seg), 7), want)
    assert not torch.are_deterministic_algorithms_enabled()


def test_task_and_cluster_qos_match():
    rng = np.random.default_rng(4)
    alloc = rng.random((T_, 2)).astype(np.float32)
    demand = (alloc + rng.normal(0, 1e-3, (T_, 2))).astype(np.float32)
    request = rng.random((T_, 2)).astype(np.float32)
    active = rng.random(T_) < 0.7
    jq = jax.jit(j_qos.task_qos)(alloc, demand, request)
    tq = qos.task_qos(*map(torch.from_numpy, (alloc, demand, request)))
    _eq(tq, jq)
    ta = torch.from_numpy(active)
    _eq(qos.cluster_qos(tq, ta), jax.jit(j_qos.cluster_qos)(jq, active))
    _eq(qos.cluster_qos(tq, torch.zeros_like(ta)),
        j_qos.cluster_qos(jq, np.zeros_like(active)))
    _eq(qos.violation_fraction(torch.from_numpy(alloc[:, 0]), 0.5),
        j_qos.violation_fraction(alloc[:, 0], 0.5))


@pytest.mark.parametrize("series", [
    [1.0, 1.0, 1.0, 1.0],
    [1.0, 0.9, 0.95, 1.0, 1.0, 1.0, 1.0],
    [1.0, 0.9, 1.0, 0.8, 1.0, 1.0],
    [0.5, 0.5, 0.5],
    [1.0, 0.97, 1.0, 1.0],
])
@pytest.mark.parametrize("consecutive", [1, 3])
def test_recovery_slots_match(series, consecutive):
    s = np.float32(series)
    want = j_qos.recovery_slots(s, 0.99, consecutive=consecutive)
    got = qos.recovery_slots(torch.from_numpy(s), 0.99,
                             consecutive=consecutive)
    assert got.dtype == torch.int32
    assert int(got) == int(want)


@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_update_penalty_matches(beta):
    rng = np.random.default_rng(5)
    jp = JParams.default(beta=beta)
    tp = params_from_numpy({k: np.asarray(v) for k, v in
                            jp._asdict().items()}, device="cpu")
    jstep = jax.jit(j_pen.update_penalty)
    for _ in range(200):
        p = np.float32(1.0 + 3 * rng.random())
        prev = np.float32(rng.random())
        q = np.float32(rng.choice([rng.random(), 0.995, 1.0]))
        want = jstep(JCtrl(jnp.float32(p), jnp.float32(prev)), q, jp)
        got = penalty.update_penalty(
            ControllerState(torch.tensor(p), torch.tensor(prev)),
            torch.tensor(q), tp)
        _eq(got.penalty, want.penalty)
        _eq(got.prev_qos, want.prev_qos)


def test_controller_init_matches():
    jp = JParams.default()
    tp = FlexParams.default(device="cpu")
    for a, b in zip(tp, jp):
        _eq(a, b)
    _eq(ControllerState.init(tp).penalty, JCtrl.init(jp).penalty)


@pytest.mark.parametrize("decay", [0.7, 0.0, 0.9])
def test_ewma_matches(decay):
    rng = np.random.default_rng(6)
    prev = rng.random((N_, 2)).astype(np.float32)
    meas = rng.random((N_, 2)).astype(np.float32)
    want = jax.jit(functools.partial(j_est.ewma, decay=decay))(prev, meas)
    _eq(estimator.ewma(torch.from_numpy(prev), torch.from_numpy(meas),
                       decay), want)
    est = get_estimator("ewma")
    st = est.init_state(N_, device="cpu")._replace(est=torch.from_numpy(prev))
    if decay == 0.7:
        _eq(est.refresh(st, torch.from_numpy(meas), None).est, want)


def test_current_estimator_matches():
    rng = np.random.default_rng(7)
    usage = rng.random((N_, 2)).astype(np.float32)
    _eq(estimator.current_usage(torch.from_numpy(usage)),
        j_est.current_usage(usage))
    est = get_estimator("current")
    st = est.refresh(est.init_state(N_, device="cpu"),
                     torch.from_numpy(usage), None)
    _eq(st.est, usage)
    assert list_estimators() == ["current", "ewma"]


def test_noisy_current_estimator_uses_the_draw():
    draw = lambda shape: torch.full(tuple(shape), 0.5)
    got = estimator.current_usage(torch.ones(3, 2), draw, noise_std=0.2)
    assert torch.allclose(got, torch.full((3, 2), 1.1))


def test_replay_noise_serves_rows_and_refuses_estimator_noise():
    table = np.random.default_rng(0).standard_normal((4, 9)).astype(
        np.float32)
    src = noise_table_from_numpy(table, device="cpu")
    assert isinstance(src, ReplayNoise)
    _eq(src.demand(2, 9), table[2])
    with pytest.raises(ValueError):
        src.demand(4, 9)
    with pytest.raises(ValueError):
        src.demand(0, 8)
    with pytest.raises(ValueError, match="noisy estimator"):
        src.estimate(0, (3, 2))


def test_generator_noise_is_seeded_and_f32():
    a = GeneratorNoise(3, "cpu")
    b = GeneratorNoise(3, "cpu")
    x, y = a.demand(0, 100), b.demand(0, 100)
    assert x.dtype == torch.float32 and torch.equal(x, y)
    assert not torch.equal(a.demand(1, 100), x)
    assert a.estimate(1, (4, 2)).shape == (4, 2)


@pytest.mark.parametrize("seed,n_nodes,n_slots,load", [
    (0, 16, 12, 1.6), (3, 40, 20, 1.0), (7, 8, 96, 2.0)])
def test_generate_calibrated_bit_identical(seed, n_nodes, n_slots, load):
    want = j_gen.generate_calibrated(seed, n_nodes, n_slots, load)
    got = generator.generate_calibrated(seed, n_nodes, n_slots, load,
                                        device="cpu")
    assert got.num_tasks == want.num_tasks
    for name in want._fields:
        t, j = getattr(got, name), np.asarray(getattr(want, name))
        assert t.dtype == {np.dtype(np.float32): torch.float32,
                           np.dtype(np.int32): torch.int32}[j.dtype], name
        _eq(t, j)
    assert (generator.n_tasks_for_offered_load(n_nodes, n_slots, load)
            == j_gen.n_tasks_for_offered_load(n_nodes, n_slots, load))


def test_generate_taskset_bit_identical():
    want = j_gen.generate_taskset(11, 300, 24)
    got = generator.generate_taskset(11, 300, 24, device="cpu")
    for name in want._fields:
        _eq(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("width", [4, 64])
def test_build_arrival_table_matches(width):
    arrival = np.random.default_rng(1).integers(0, 10, 120).astype(np.int32)
    np.testing.assert_array_equal(build_arrival_table(arrival, 10, width),
                                  j_table(arrival, 10, width))


def test_convert_pins_dtypes():
    arrays = dict(
        est_usage=np.ones((3, 2)), reserved=np.zeros((3, 2)),
        requested=np.zeros((3, 2), np.float64),
        n_tasks=np.arange(3, dtype=np.int64),
        src_count=np.zeros((3, 64), np.int64))
    node = node_state_from_numpy(arrays, device="cpu")
    assert isinstance(node, NodeState)
    assert node.est_usage.dtype == torch.float32
    assert node.n_tasks.dtype == torch.int32
    with pytest.raises(TypeError):
        node_state_from_numpy({**arrays, "n_tasks": np.ones(3)},
                              device="cpu")
    with pytest.raises(KeyError):
        taskset_from_numpy({"arrival": np.zeros(3, np.int32)}, device="cpu")


def test_fma_rounds_once():
    # 1 + 2^-24 is not a float32; (1 + 2^-12)^2 - 1 rounded twice loses
    # the 2^-24 term, rounded once keeps it.
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    twice = a * a - 1.0
    once = fma(a, a, -1.0)
    assert float(once[0]) == 2.0 ** -11 + 2.0 ** -24
    assert float(twice[0]) != float(once[0])
    rng = np.random.default_rng(8)
    x, y, z = (rng.random(10000).astype(np.float32) for _ in range(3))
    want = jax.jit(lambda a, b, c: a * b + c)(x, y, z)
    _eq(fma(*map(torch.from_numpy, (x, y, z))), want)


def test_sqrt_correctly_rounded():
    x = np.random.default_rng(9).random(20000).astype(np.float32)
    _eq(sqrt(torch.from_numpy(x)), jax.jit(jnp.sqrt)(x))
