"""Retry semantics, exponential backoff and jitter: the port against the
JAX reference (``tests/test_retries.py``'s simulator cases).

The reference's small cases run on noise-free tasks, so the port is held
to the values their assertions pin; the jittered ones replay the
reference's jitter table (its run key's jitter stream).  ``backoff_delay``
is held bit for bit against the jitted reference, and whole runs with
backoff and jitter at 64 nodes against the reference's under replayed
noise and jitter, in both admission modes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimConfig as JSimConfig
from repro.core.simulator import _JITTER_STREAM
from repro.faults import injection as j_inject
from repro.traces import generate_calibrated as jax_generate
from repro_torch.convert import noise_table_from_numpy
from repro_torch.core import SimConfig, run
from repro_torch.faults import backoff_delay, jitter_table
from test_torch_faults import (FULL_BASE, FULL_N, FULL_S, assert_same,
                               both_runs, jax_taskset, port_taskset)

torch.set_num_threads(1)


def _taskset(arrival, request, duration=None, mean_usage=None):
    """The reference file's noise-free tasks (demand == mean_usage)."""
    mean_frac = 0.1 if mean_usage is None else 0.5
    return port_taskset(jax_taskset(
        arrival, request, duration=50 if duration is None else duration,
        mean_frac=mean_frac, mean_usage=mean_usage))


def _run(ts, cfg, policy="flex-f", jitter=None):
    if jitter is None:
        return run(ts, cfg, policy, device="cpu")
    table = np.zeros((cfg.n_slots, ts.num_tasks), np.float32)
    return run(ts, cfg, policy, device="cpu",
               noise=noise_table_from_numpy(table, jitter=jitter,
                                            device="cpu"))


def _drop_slot(res):
    rejected = res.metrics.n_rejected.numpy()
    assert rejected[-1] == 1
    return int(np.argmax(rejected > 0))


def _reference_jitter(n_tasks, jitter, seed=0):
    return np.asarray(j_inject.jitter_table(
        jax.random.fold_in(jax.random.PRNGKey(seed), _JITTER_STREAM),
        n_tasks, jitter))


# ---------------------------------------------------------------------------
# functions, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backoff,cap", [(0, 64), (1, 64), (2, 64), (3, 5),
                                         (7, 1000), (1, 8191)])
def test_backoff_delay_matches_reference(backoff, cap):
    attempts = np.arange(-2, 60, dtype=np.int32)
    want = np.asarray(jax.jit(lambda a: j_inject.backoff_delay(
        a, backoff, cap))(jnp.asarray(attempts)))
    got = backoff_delay(torch.from_numpy(attempts), backoff, cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_backoff_delay_past_two_to_the_twelfth():
    """The jitted reference's exp2 is XLA's polynomial, which misses some
    powers of two from 2**13 on; the port's is exact.  Delays agree up to
    attempt 13 and, past it, differ by under 1e-4 of themselves: only in
    delays of 8192 slots or more, beyond any horizon a study runs, and
    never under a cap below 8192."""
    attempts = np.arange(1, 40, dtype=np.int32)
    want = np.asarray(jax.jit(lambda a: j_inject.backoff_delay(
        a, 1, 2 ** 31 - 1))(jnp.asarray(attempts))).astype(np.int64)
    got = backoff_delay(torch.from_numpy(attempts), 1,
                        2 ** 31 - 1).numpy().astype(np.int64)
    np.testing.assert_array_equal(got[:13], want[:13])
    np.testing.assert_array_equal(got, 2 ** np.minimum(attempts - 1, 30))
    diff = got != want
    assert diff.any() and (got[diff] >= 8192).all()
    assert (np.abs(got - want)[diff] <= 1e-4 * got[diff]).all()


def test_jitter_table_range_and_zero():
    gen = torch.Generator().manual_seed(0)
    assert not jitter_table(gen, 50, 0).any()
    tab = jitter_table(gen, 5000, 3)
    assert tab.dtype == torch.int32
    assert set(tab.unique().tolist()) == {0, 1, 2, 3}


def test_defaults_match_reference():
    for name in ("max_retries", "retry_backoff", "retry_backoff_cap",
                 "retry_jitter"):
        assert getattr(SimConfig(), name) == getattr(JSimConfig(), name)


# ---------------------------------------------------------------------------
# the reference's small cases (tests/test_retries.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_retries", [3, 5])
def test_dropped_exactly_after_retries_exhausted(max_retries):
    cfg = SimConfig(n_nodes=1, n_slots=10, arrivals_per_slot=4,
                    retry_capacity=4, max_retries=max_retries)
    res = _run(_taskset([0], [1.5]), cfg)
    expected = (np.arange(cfg.n_slots) >= max_retries).astype(np.int32)
    np.testing.assert_array_equal(res.metrics.n_rejected.numpy(), expected)
    assert int(res.placement[0]) == -1


def test_rejected_counts_overflow_and_exhausted():
    cfg = SimConfig(n_nodes=1, n_slots=8, arrivals_per_slot=8,
                    retry_capacity=2, max_retries=3)
    res = _run(_taskset([0, 0, 0, 0], [1.5] * 4), cfg)
    rejected = res.metrics.n_rejected.numpy()
    assert rejected[0] == 2 and rejected[cfg.max_retries - 1] == 2
    assert rejected[cfg.max_retries] == 4 and rejected[-1] == 4
    assert (res.placement == -1).all()


def test_retry_queue_is_fifo_stable_across_failures():
    cfg = SimConfig(n_nodes=1, n_slots=10, arrivals_per_slot=8,
                    retry_capacity=8, max_retries=2)
    res = _run(_taskset([0, 0, 0, 0], [0.6, 0.6, 1.5, 0.6],
                        mean_usage=[0.05, 0.05, 0.0, 0.05]), cfg)
    assert res.admit_slot[[0, 1, 3]].tolist() == [0, 1, 2]
    assert int(res.placement[2]) == -1
    assert int(res.metrics.n_rejected[-1]) == 1


def test_lrf_queue_order_applies_to_retries():
    cfg = SimConfig(n_nodes=1, n_slots=10, arrivals_per_slot=8,
                    retry_capacity=8, max_retries=8)
    res = _run(_taskset([0, 0, 0], [0.7, 0.8, 0.9],
                        mean_usage=[0.02, 0.02, 0.02]), cfg, "flex-l")
    assert res.admit_slot.tolist() == [2, 1, 0]


@pytest.mark.parametrize("backoff,cap,max_retries,n_slots,drop", [
    (0, 64, 3, 12, 3),      # the legacy cadence with backoff compiled in
    (1, 64, 3, 14, 10),     # attempts at 0, 2, 5, 10
    (1, 2, 3, 12, 8),       # delays 1, 2, 2: attempts at 0, 2, 5, 8
    (4, 64, 1, 10, 5),      # deferral uses no attempt
])
def test_backoff_schedule_exact(backoff, cap, max_retries, n_slots, drop):
    cfg = SimConfig(n_nodes=1, n_slots=n_slots, arrivals_per_slot=4,
                    retry_capacity=4, max_retries=max_retries,
                    retry_backoff=backoff, retry_backoff_cap=cap)
    assert _drop_slot(_run(_taskset([0], [1.5]), cfg)) == drop


def test_jitter_exponential_schedule_exact():
    jitter = 3
    tab = _reference_jitter(1, jitter)
    j = int(tab[0])
    cfg = SimConfig(n_nodes=1, n_slots=14 + 3 * jitter, arrivals_per_slot=4,
                    retry_capacity=4, max_retries=3, retry_backoff=1,
                    retry_jitter=jitter)
    res = _run(_taskset([0], [1.5]), cfg, jitter=tab)
    assert _drop_slot(res) == 10 + 3 * j


def test_jitter_desynchronizes_tasks():
    jitter = 4
    tab = _reference_jitter(2, jitter)
    cfg = SimConfig(n_nodes=1, n_slots=14 + 3 * jitter, arrivals_per_slot=4,
                    retry_capacity=4, max_retries=3, retry_backoff=1,
                    retry_jitter=jitter)
    res = _run(_taskset([0, 0], [1.5, 1.5]), cfg, jitter=tab)
    rejected = res.metrics.n_rejected.numpy()
    assert rejected[-1] == 2
    for t in range(2):
        drop = 10 + 3 * int(tab[t])
        assert rejected[drop] > rejected[drop - 1] or tab[0] == tab[1]


def test_backoff_deferred_task_admits_at_next_attempt():
    ts = _taskset([0, 0], [0.9, 0.8], duration=[50, 50],
                  mean_usage=[0.05, 0.05])
    base = SimConfig(n_nodes=1, n_slots=16, arrivals_per_slot=4,
                     retry_capacity=4, max_retries=8)
    res0 = _run(ts, base)
    res2 = _run(ts, base._replace(retry_backoff=2))
    assert res0.admit_slot.tolist() == [0, 1]
    assert res2.admit_slot.tolist() == [0, 3]
    assert int(res2.metrics.n_rejected[-1]) == 0


def test_generator_jitter_runs_are_repeatable():
    ts = _taskset([0, 0, 0], [1.5, 1.5, 1.5])
    cfg = SimConfig(n_nodes=1, n_slots=30, arrivals_per_slot=4,
                    retry_capacity=4, max_retries=3, retry_backoff=1,
                    retry_jitter=4)
    a = run(ts, cfg, "flex-f", seed=5, device="cpu")
    b = run(ts, cfg, "flex-f", seed=5, device="cpu")
    assert torch.equal(a.metrics.n_rejected, b.metrics.n_rejected)


# ---------------------------------------------------------------------------
# whole runs at 64 nodes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def retry_trace():
    return jax_generate(1, FULL_N, FULL_S, 1.6)


@pytest.mark.parametrize("mode", ["sequential", "wavefront"])
def test_backoff_and_jitter_runs_match_reference(retry_trace, mode):
    """Backoff and jitter without faults (the full-stack cases of
    test_torch_faults.py run them under faults for all three policies)."""
    jcfg = JSimConfig(**FULL_BASE, retry_backoff=2, retry_backoff_cap=8,
                      retry_jitter=3, max_retries=4)
    jres, truns = both_runs(retry_trace, jcfg, "flex-brownout", seed=1,
                            use_kernel=(False, True), cache="retries",
                            admission_mode=mode)
    for tres in truns:
        assert_same(jres, tres)
    assert int(truns[0].metrics.n_rejected[-1]) > 0
