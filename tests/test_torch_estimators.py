"""The port's load estimators against the JAX reference.

The same usage sequences (numpy, seeded) go through each reference
estimator, its ``refresh`` jitted as the simulator runs it, and through
the port's.  ``current``, ``ewma``, ``quantile`` and an untrained
``learned`` must be bit-equal; a ``learned`` estimator with random
parameters is held to atol 1e-6 per refresh, because the MLP's tanh and
small products round differently in XLA and PyTorch.  The rest mirrors
the estimator tests of ``tests/test_estimators.py``: the registry, ewma(0)
is current, noise never negative, the stateless adapter, and the learned
estimator's train, checkpoint and reload round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimConfig as JSimConfig
from repro.core import run as jax_run
from repro.estimators import CurrentEstimator as JCurrent
from repro.estimators import EwmaEstimator as JEwma
from repro.estimators import LearnedUsageEstimator as JLearned
from repro.estimators import QuantileWindowEstimator as JQuantile
from repro.estimators import mlp_init as j_mlp_init
from repro.estimators import ring_chronological as j_ring_chronological
from repro.estimators import ring_push as j_ring_push
from repro.traces import generate_calibrated as jax_generate
from repro_torch.convert import (learned_params, noise_table_from_numpy,
                                 taskset_from_numpy)
from repro_torch.core import SimConfig, estimator, run
from repro_torch.estimators import (CurrentEstimator, EwmaEstimator,
                                    LearnedUsageEstimator,
                                    QuantileWindowEstimator,
                                    StatelessAdapter, UsagePredictor,
                                    as_stateful, get_estimator,
                                    list_estimators, mlp_apply,
                                    resolve_estimator, ring_chronological,
                                    ring_push,
                                    train_usage_predictor)

torch.set_num_threads(1)

CFG = dict(n_nodes=60, n_slots=32, arrivals_per_slot=256, retry_capacity=64)


def _usage_seq(n_steps, n_nodes=5, n_res=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n_steps, n_nodes, n_res)).astype(np.float32)


def _drive(est, seq, draw=None):
    """The port's estimate after each refresh, (S, N, R)."""
    state = est.init_state(seq.shape[1], seq.shape[2], device="cpu")
    out = []
    for t in range(seq.shape[0]):
        state = est.refresh(state, torch.from_numpy(seq[t]), draw)
        out.append(state.est)
    return torch.stack(out).numpy()


def _drive_ref(est, seq):
    """The reference's estimates, each refresh jitted."""
    refresh = jax.jit(est.refresh)
    state = est.init_state(seq.shape[1], seq.shape[2])
    key = jax.random.PRNGKey(0)
    out = []
    for t in range(seq.shape[0]):
        state = refresh(state, jnp.asarray(seq[t]),
                        jax.random.fold_in(key, t))
        out.append(np.asarray(state.est))
    return np.stack(out)


# ---------------------------------------------------------------- registry

def test_builtins_registered():
    assert list_estimators() == ["current", "ewma", "learned", "quantile"]


@pytest.mark.parametrize("name", ["current", "ewma", "quantile", "learned"])
def test_get_estimator_roundtrip(name):
    est = get_estimator(name)
    assert hasattr(est, "init_state") and hasattr(est, "refresh")
    hash(est)


def test_unknown_name_raises():
    with pytest.raises(KeyError, match="unknown estimator"):
        get_estimator("no-such-estimator")


def test_noise_only_for_current():
    assert isinstance(resolve_estimator("current", 0.3), CurrentEstimator)
    with pytest.raises(ValueError, match="est_noise_std"):
        resolve_estimator("quantile", 0.3)


# ---------------------------------------------------------------- built-ins

def test_ewma_zero_decay_is_current():
    seq = _usage_seq(6)
    np.testing.assert_array_equal(_drive(EwmaEstimator(decay=0.0), seq),
                                  _drive(CurrentEstimator(), seq))


def test_current_noise_never_negative():
    seq = _usage_seq(32)
    gen = torch.Generator().manual_seed(0)
    draw = lambda shape: torch.randn(tuple(shape), generator=gen)
    est = _drive(CurrentEstimator(noise_std=3.0), seq, draw)
    assert est.min() >= 0.0
    assert np.std(est - seq) > 0.0


class _LegacyEwma:
    """A stateless estimator of the legacy convention."""

    def refresh(self, prev_est, node_usage, draw):
        return estimator.ewma(prev_est, node_usage, 0.7)


def test_stateless_adapter_matches_builtin():
    seq = _usage_seq(7)
    adapted = as_stateful(_LegacyEwma())
    assert isinstance(adapted, StatelessAdapter)
    np.testing.assert_array_equal(_drive(adapted, seq),
                                  _drive(EwmaEstimator(decay=0.7), seq))
    assert resolve_estimator(adapted) is adapted
    with pytest.raises(TypeError, match="not an estimator"):
        as_stateful(object())


@pytest.mark.parametrize("port,ref", [
    (CurrentEstimator(), JCurrent()),
    (EwmaEstimator(decay=0.7), JEwma(decay=0.7)),
    (EwmaEstimator(decay=0.3), JEwma(decay=0.3)),
])
def test_memoryless_estimators_match(port, ref):
    seq = _usage_seq(9, n_nodes=40, seed=3)
    np.testing.assert_array_equal(_drive(port, seq), _drive_ref(ref, seq))


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("window", [1, 5, 12])
def test_quantile_matches_reference(window, q):
    """Bit for bit, over enough slots to wrap the ring twice."""
    seq = _usage_seq(2 * window + 3, n_nodes=64, seed=window)
    got = _drive(QuantileWindowEstimator(window=window, q=q), seq)
    want = _drive_ref(JQuantile(window=window, q=q), seq)
    np.testing.assert_array_equal(got, want)


def test_quantile_matches_numpy_oracle():
    window, q = 4, 0.9
    seq = _usage_seq(9)
    got = _drive(QuantileWindowEstimator(window=window, q=q), seq)
    for t in range(len(seq)):
        hist = [seq[0]] * max(window - 1 - t, 0) + list(
            seq[max(t - window + 1, 0):t + 1])
        want = np.quantile(np.stack(hist), q, axis=0).astype(np.float32)
        np.testing.assert_allclose(got[t], want, atol=1e-6)


def test_quantile_refresh_keeps_a_host_counter():
    """The slot counter is a Python int: a refresh reads nothing back from
    the device."""
    est = QuantileWindowEstimator(window=3)
    state = est.init_state(4, device="cpu")
    for t in range(5):
        state = est.refresh(state, torch.rand(4, 2), None)
    buffer, t = state.aux
    assert t == 5 and isinstance(t, int)
    assert buffer.shape == (3, 4, 2)


@pytest.mark.parametrize("window", [1, 4])
def test_ring_buffer_matches_reference(window):
    rng = np.random.default_rng(window)
    buf = rng.random((window, 6, 2)).astype(np.float32)
    push = jax.jit(j_ring_push)
    chrono = jax.jit(j_ring_chronological)
    for t in range(2 * window + 2):
        usage = rng.random((6, 2)).astype(np.float32)
        want = np.array(push(buf, jnp.int32(t), usage))
        got = ring_push(torch.from_numpy(buf), t, torch.from_numpy(usage))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            ring_chronological(got, t).numpy(),
            np.asarray(chrono(want, jnp.int32(t))))
        buf = want


def test_ring_push_leaves_its_input():
    buf = torch.zeros(3, 2, 2)
    out = ring_push(buf, 1, torch.ones(2, 2))
    assert buf.sum() == 0 and out[1].sum() == 4


# ------------------------------------------------------------------ learned

def test_untrained_learned_is_current():
    seq = _usage_seq(8)
    np.testing.assert_array_equal(
        _drive(LearnedUsageEstimator.untrained(window=4), seq),
        _drive(CurrentEstimator(), seq))
    np.testing.assert_array_equal(_drive(get_estimator("learned"), seq),
                                  _drive(CurrentEstimator(), seq))


def _random_ref_params(window, hidden, seed):
    """The reference's init, with a nonzero head and biases drawn from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in
         j_mlp_init(jax.random.PRNGKey(seed), window, hidden).items()}
    p["b1"] = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    p["w2"] = (0.3 * rng.standard_normal((hidden, 1))).astype(np.float32)
    p["b2"] = (0.05 * rng.standard_normal(1)).astype(np.float32)
    return p


@pytest.mark.parametrize("window,hidden", [(4, 3), (12, 8)])
def test_learned_with_reference_params_matches(window, hidden):
    p = _random_ref_params(window, hidden, seed=window)
    seq = _usage_seq(2 * window + 2, n_nodes=32, seed=window)
    got = _drive(LearnedUsageEstimator.from_params(
        learned_params(p, device="cpu"), window, hidden), seq)
    want = _drive_ref(JLearned.from_params(
        {k: jnp.asarray(v) for k, v in p.items()}, window, hidden), seq)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got > 0).any() and (got < 1).any()


def test_usage_predictor_module_is_mlp_apply():
    module = UsagePredictor(5, 3, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    with torch.no_grad():
        module.w2.copy_(torch.full((3, 1), 0.2))
    x = torch.rand(7, 2, 5)
    params = {k: v.detach() for k, v in module.named_parameters()}
    assert torch.equal(module(x).detach(), mlp_apply(params, x))
    assert sorted(params) == ["b1", "b2", "w1", "w2"]


def test_learned_trains_checkpoints_reloads(tmp_path):
    """The reference's slow round trip, on the port: train, checkpoint,
    reload, and run through the simulator's reclamation pass."""
    jts = jax_generate(0, CFG["n_nodes"], CFG["n_slots"], 1.5)
    ts = taskset_from_numpy({k: np.asarray(v)
                             for k, v in jts._asdict().items()},
                            device="cpu")
    params, losses = train_usage_predictor(
        ts, window=6, hidden=4, n_slots=CFG["n_slots"], steps=40,
        batch_size=256, seed=0, ckpt_dir=str(tmp_path), device="cpu")
    assert len(losses) == 40 and losses[-1] < losses[0]

    est = LearnedUsageEstimator.from_checkpoint(str(tmp_path))
    assert est.window == 6 and est.hidden == 4
    seq = _usage_seq(8)
    np.testing.assert_array_equal(
        _drive(est, seq),
        _drive(LearnedUsageEstimator.from_params(params, 6, 4), seq))

    res = run(ts, SimConfig(**CFG, reclamation=True, reclaim_pool=128),
              "least-fit", estimator=est, device="cpu")
    assert torch.isfinite(res.metrics.usage).all()
    assert int((res.placement >= 0).sum()) > 0


def test_learned_from_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        LearnedUsageEstimator.from_checkpoint(str(tmp_path))


def test_learned_estimator_in_the_simulator_matches_reference():
    """An untrained ``learned`` estimator through both simulators: the
    decisions of ``current``, bit for bit."""
    small = dict(n_nodes=16, n_slots=10, arrivals_per_slot=64,
                 retry_capacity=32)
    jts = jax_generate(0, small["n_nodes"], small["n_slots"], 1.6)
    ts = taskset_from_numpy({k: np.asarray(v)
                             for k, v in jts._asdict().items()},
                            device="cpu")
    key = jax.random.PRNGKey(0)
    table = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, s), (ts.num_tasks,), jnp.float32))
        for s in range(small["n_slots"])])
    jres = jax_run(jts, JSimConfig(**small, estimator="learned",
                                   record_node_usage=True), "flex-f")
    tres = run(ts, SimConfig(**small, estimator="learned",
                             record_node_usage=True), "flex-f",
               device="cpu", noise=noise_table_from_numpy(table,
                                                          device="cpu"))
    for name in ("placement", "admit_slot"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)))
    np.testing.assert_array_equal(tres.metrics.node_est.numpy(),
                                  np.asarray(jres.metrics.node_est))
