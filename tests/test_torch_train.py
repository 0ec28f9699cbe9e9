"""The port's trainer (``repro_torch.train``) and the learned estimator's
training against the JAX reference.

The reference runs jitted, as it runs.  Under the reference's own draws
(the series' white noise, the first layer's initial weights, the batch
indices), ``make_dataset`` must be bit-equal; the schedule within one
ulp; AdamW's parameters and moments within rtol 1e-5 over 20 steps; a
whole ``train_usage_predictor`` run within rtol 1e-4 per step's loss and
atol 1e-5 in the final parameters (tanh and the small products round
differently in XLA and PyTorch, and the differences grow over the run).
A checkpoint written by either package restores in the other.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.api  # noqa: F401  (first: the reference's import order)
from repro.estimators import LearnedUsageEstimator as JLearned
from repro.estimators import make_dataset as j_make_dataset
from repro.estimators import mlp_init as j_mlp_init
from repro.estimators import train_usage_predictor as j_train
from repro.estimators.learned import UsagePredictorModel as JModel
from repro.traces import generate_calibrated as jax_generate
from repro.train import checkpoint as j_ckpt
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as j_adamw_init
from repro.train.optimizer import adamw_update as j_adamw_update
from repro.train.optimizer import global_norm as j_global_norm
from repro.train.optimizer import schedule as j_schedule
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.convert import learned_params, taskset_from_numpy
from repro_torch.core.types import TaskSet
from repro_torch.estimators import LearnedUsageEstimator, make_dataset
from repro_torch.estimators.learned import UsagePredictorModel
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                               make_train_step)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import global_norm, schedule

torch.set_num_threads(1)

N_SLOTS, WINDOW, HIDDEN = 32, 6, 4


@pytest.fixture(scope="module")
def trace():
    jts = jax_generate(0, 60, N_SLOTS, 1.5)
    ts = taskset_from_numpy({k: np.asarray(v)
                             for k, v in jts._asdict().items()},
                            device="cpu")
    return jts, ts


def _white(k_data, n_tasks, n_slots):
    """The standard normals the reference's ``make_dataset`` draws: one
    per (task, slot), from split(split(k_data, n)[task], n_slots)."""
    draw = jax.vmap(lambda kt: jax.vmap(lambda k: jax.random.normal(k, ()))(
        jax.random.split(kt, n_slots)))
    return np.array(jax.jit(draw)(jax.random.split(k_data, n_tasks)))


def _n_tasks(ts, max_tasks=512):
    return min(int(ts.num_tasks), max_tasks)


# ------------------------------------------------------------------ dataset

@pytest.mark.parametrize("window,max_tasks", [(6, 512), (12, 40)])
def test_make_dataset_matches_reference(trace, window, max_tasks):
    jts, ts = trace
    k_data = jax.random.PRNGKey(7)
    want = j_make_dataset(jts, N_SLOTS, window, k_data, max_tasks=max_tasks)
    white = _white(k_data, _n_tasks(ts, max_tasks), N_SLOTS)
    got = make_dataset(ts, N_SLOTS, window, torch.from_numpy(white),
                       max_tasks=max_tasks)
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))


def test_make_dataset_pairs_as_the_reference():
    """The reference orders x (task, time, resource) and y (task,
    resource, time); the port keeps its pairs.  One task, no AR memory,
    mean 0 and std (1, 10): the series is white for CPU and 10 x white
    for memory."""
    n_slots, window = 5, 3
    one = lambda *v: torch.tensor([v], dtype=torch.float32)
    ts = TaskSet(arrival=torch.zeros(1, dtype=torch.int32),
                 duration=torch.ones(1, dtype=torch.int32),
                 request=one(0.1, 0.1), mean_usage=one(0.0, 0.0),
                 std_usage=one(1.0, 10.0), peak_usage=one(100.0, 100.0),
                 ar_rho=torch.zeros(1), priority=torch.zeros(
                     1, dtype=torch.int32),
                 src=torch.zeros(1, dtype=torch.int32))
    white = torch.arange(1.0, n_slots + 1)[None, :]
    data = make_dataset(ts, n_slots, window, white)
    assert data["x"].tolist() == [[1, 2, 3], [10, 20, 30],
                                  [2, 3, 4], [20, 30, 40]]
    # the aligned targets would be [4, 40, 5, 50]
    assert data["y"].tolist() == [4, 5, 40, 50]


def test_make_dataset_checks_the_noise_table(trace):
    _, ts = trace
    with pytest.raises(ValueError, match="white noise"):
        make_dataset(ts, N_SLOTS, WINDOW, torch.zeros(3, N_SLOTS))


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("cfg", [
    dict(lr=3e-3, warmup_steps=2, total_steps=40, weight_decay=0.0),
    dict(lr=3e-3, warmup_steps=10, total_steps=200, weight_decay=0.0),
])
def test_schedule_matches_reference(cfg):
    steps = np.arange(0, cfg["total_steps"] + 3, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: j_schedule(JAdamWConfig(**cfg), s)))(steps))
    got = schedule(AdamWConfig(**cfg), torch.from_numpy(steps)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32))
    assert ulps.max() <= 1


def _random_tree(rng):
    return {"w1": rng.standard_normal((6, 4)).astype(np.float32),
            "b1": rng.standard_normal(4).astype(np.float32),
            "w2": rng.standard_normal((4, 1)).astype(np.float32),
            "b2": rng.standard_normal(1).astype(np.float32)}


def test_global_norm_matches_reference():
    tree = _random_tree(np.random.default_rng(0))
    want = np.asarray(jax.jit(j_global_norm)(tree))
    got = global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_update_matches_reference(clip_norm):
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, weight_decay=0.1,
              clip_norm=clip_norm)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp = _random_tree(rng)
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    jstate, tstate = j_adamw_init(jp), adamw_init(tp)
    update = jax.jit(lambda g, s, p: j_adamw_update(jcfg, g, s, p))
    for _ in range(20):
        grads = {k: v * 3 for k, v in _random_tree(rng).items()}
        jp, jstate, jnorm = update(grads, jstate, jp)
        tp, tstate, tnorm = adamw_update(
            tcfg, {k: torch.from_numpy(v) for k, v in grads.items()},
            tstate, tp)
        np.testing.assert_allclose(tnorm.numpy(), np.asarray(jnorm),
                                   rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 20
    for k in jp:
        for got, want in ((tp[k], jp[k]), (tstate.mu[k], jstate.mu[k]),
                          (tstate.nu[k], jstate.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("accum_steps", [1, 4])
def test_train_step_matches_reference(accum_steps):
    rng = np.random.default_rng(2)
    x = rng.random((64, WINDOW)).astype(np.float32)
    y = rng.random(64).astype(np.float32)
    p = {k: np.asarray(v) for k, v in
         j_mlp_init(jax.random.PRNGKey(3), WINDOW, HIDDEN).items()}
    cfg = dict(lr=3e-3, warmup_steps=2, total_steps=10, weight_decay=0.0)
    jstep = jax.jit(j_make_train_step(JModel(WINDOW, HIDDEN),
                                      JAdamWConfig(**cfg), accum_steps))
    tstep = make_train_step(UsagePredictorModel(WINDOW, HIDDEN),
                            AdamWConfig(**cfg), accum_steps)
    jp, jstate = p, j_adamw_init(p)
    tp = learned_params(p, device="cpu")
    tstate = adamw_init(tp)
    for _ in range(5):
        jp, jstate, jm = jstep(jp, jstate, {"x": x, "y": y})
        tp, tstate, tm = tstep(tp, tstate, {"x": torch.from_numpy(x),
                                            "y": torch.from_numpy(y)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


# ----------------------------------------------------------------- training

def test_train_usage_predictor_matches_reference(trace):
    """40 steps at window 6, hidden 4, batch 256, under the reference's
    draws for the data, the initial weights and the batch indices."""
    jts, ts = trace
    steps, batch, seed = 40, 256, 0
    j_params, j_losses = j_train(jts, window=WINDOW, hidden=HIDDEN,
                                 n_slots=N_SLOTS, steps=steps,
                                 batch_size=batch, seed=seed)

    key = jax.random.PRNGKey(seed)
    k_data, k_init, k_batch = jax.random.split(key, 3)
    white = _white(k_data, _n_tasks(ts), N_SLOTS)
    init = {k: np.asarray(v)
            for k, v in j_mlp_init(k_init, WINDOW, HIDDEN).items()}
    n_examples = _n_tasks(ts) * (N_SLOTS - WINDOW) * 2
    draw = jax.jit(lambda s: jax.random.randint(
        jax.random.fold_in(k_batch, s), (batch,), 0, n_examples))

    def batch_index(step):
        return torch.from_numpy(np.asarray(draw(step)).astype(np.int64))

    params, losses = train_usage_predictor_port(
        ts, steps=steps, batch=batch, white=white, init=init,
        batch_index=batch_index)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    for k in j_params:
        np.testing.assert_allclose(params[k].numpy(),
                                   np.asarray(j_params[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def train_usage_predictor_port(ts, *, steps, batch, white, init,
                               batch_index):
    from repro_torch.estimators import train_usage_predictor
    return train_usage_predictor(
        ts, window=WINDOW, hidden=HIDDEN, n_slots=N_SLOTS, steps=steps,
        batch_size=batch, device="cpu",
        params=learned_params(init, device="cpu"),
        white=torch.from_numpy(white), batch_index=batch_index)


def test_train_usage_predictor_defaults_repeat(trace):
    """One seed, one generator: two runs give the same parameters."""
    from repro_torch.estimators import train_usage_predictor
    _, ts = trace
    kw = dict(window=WINDOW, hidden=HIDDEN, n_slots=N_SLOTS, steps=5,
              batch_size=64, seed=3, device="cpu")
    a, la = train_usage_predictor(ts, **kw)
    b, lb = train_usage_predictor(ts, **kw)
    assert la == lb
    for k in a:
        assert torch.equal(a[k], b[k])


# -------------------------------------------------------------- checkpoints

def _params(seed, window=WINDOW, hidden=HIDDEN):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((window, hidden)).astype(np.float32),
            "b1": rng.standard_normal(hidden).astype(np.float32),
            "w2": rng.standard_normal((hidden, 1)).astype(np.float32),
            "b2": rng.standard_normal(1).astype(np.float32)}


def _estimates(est, seed=0):
    """The port's estimates of a random usage sequence (6 slots)."""
    usage = np.random.default_rng(seed).random((6, 9, 2)).astype(np.float32)
    state = est.init_state(9, device="cpu")
    out = []
    for t in range(6):
        state = est.refresh(state, torch.from_numpy(usage[t]), None)
        out.append(state.est)
    return torch.stack(out)


def test_reference_checkpoint_restores_in_port(tmp_path):
    p = _params(0)
    j_ckpt.save(tmp_path, 40, {k: jnp.asarray(v) for k, v in p.items()},
                extra={"window": WINDOW, "hidden": HIDDEN})
    like = learned_params(_params(1), device="cpu")
    got, meta = ckpt.restore(tmp_path, 40, like)
    for k, v in p.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert ckpt.latest_step(tmp_path) == 40 and meta["n_leaves"] == 4
    est = LearnedUsageEstimator.from_checkpoint(str(tmp_path))
    assert (est.window, est.hidden) == (WINDOW, HIDDEN)
    assert torch.equal(_estimates(est), _estimates(
        LearnedUsageEstimator.from_params(learned_params(p, device="cpu"),
                                          WINDOW, HIDDEN)))


def test_port_checkpoint_restores_in_reference(tmp_path):
    p = _params(2)
    ckpt.save(tmp_path, 7, learned_params(p, device="cpu"),
              extra={"window": WINDOW, "hidden": HIDDEN})
    like = {k: jnp.zeros(v.shape, jnp.float32) for k, v in p.items()}
    got, meta = j_ckpt.restore(tmp_path, 7, like)
    for k, v in p.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    assert meta["treedef"] == str(jax.tree_util.tree_structure(like))
    j_est = JLearned.from_checkpoint(str(tmp_path))
    want = JLearned.from_params({k: jnp.asarray(v) for k, v in p.items()},
                                WINDOW, HIDDEN)
    usage = np.random.default_rng(3).random((9, 2)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    sa, sb = j_est.init_state(9), want.init_state(9)
    for _ in range(4):
        sa = j_est.refresh(sa, usage, key)
        sb = want.refresh(sb, usage, key)
        np.testing.assert_array_equal(np.asarray(sa.est), np.asarray(sb.est))


def test_checkpoint_metadata_matches_reference_layout(tmp_path):
    p = _params(4)
    ckpt.save(tmp_path / "port", 3, learned_params(p, device="cpu"),
              extra={"x": 1})
    j_ckpt.save(tmp_path / "ref", 3,
                {k: jnp.asarray(v) for k, v in p.items()}, extra={"x": 1})
    a, b = (json.loads((tmp_path / d / "step_00000003" / "metadata.json")
                       .read_text()) for d in ("port", "ref"))
    assert a == b
    for i in range(4):
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "step_00000003" / f"arr_{i}.npy"),
            np.load(tmp_path / "ref" / "step_00000003" / f"arr_{i}.npy"))


def test_nested_and_bfloat16_leaves_round_trip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)},
            "e": [torch.zeros(1), None]}
    ckpt.save(tmp_path, 1, tree)
    got, _ = ckpt.restore(tmp_path, 1, tree)
    assert got["b"]["d"].dtype == torch.bfloat16
    for x, y in ((got["a"], tree["a"]), (got["b"]["c"], tree["b"]["c"]),
                 (got["b"]["d"], tree["b"]["d"]), (got["e"][0],
                                                   tree["e"][0])):
        assert torch.equal(x, y)
    assert got["e"][1] is None
    # the reference reads the same files, bfloat16 through ml_dtypes
    like = {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(5, jnp.int32),
                                         "d": jnp.zeros(2, jnp.bfloat16)},
            "e": [jnp.zeros(1), None]}
    ref, _ = j_ckpt.restore(tmp_path, 1, like)
    assert ref["b"]["d"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        np.asarray(ref["b"]["d"]).astype(np.float32), [1.5, -2.25])


def test_reference_bfloat16_leaf_restores_in_port(tmp_path):
    j_ckpt.save(tmp_path, 2, {"w": jnp.asarray([0.5, 3.0], jnp.bfloat16)})
    got, _ = ckpt.restore(tmp_path, 2, {"w": torch.zeros(2)})
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].float().tolist() == [0.5, 3.0]


def test_latest_and_retention(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, tree, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.all_steps(tmp_path) == [4, 5]
    assert ckpt.all_steps(tmp_path / "missing") == []
    assert ckpt.latest_step(tmp_path / "missing") is None


def test_staging_and_half_written_checkpoints_ignored(tmp_path):
    tree = {"a": torch.zeros(2)}
    ckpt.save(tmp_path, 1, tree)
    staging = tmp_path / "step_00000003.tmp.12345"
    staging.mkdir()
    (staging / "metadata.json").write_text("{}")
    broken = tmp_path / "step_00000002"
    broken.mkdir()
    (broken / "arr_0.npy").write_bytes(b"garbage")
    assert ckpt.latest_step(tmp_path) == 1
    assert not any(p.name.startswith("step_00000001.tmp")
                   for p in tmp_path.iterdir())


def test_restore_rejects_a_mismatch(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, 1, {"a": torch.zeros(2), "b": torch.zeros(4)})
