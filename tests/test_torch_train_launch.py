"""The port's trainer (``repro_torch.launch.train``) on the CPU.

Mirrors tests/test_train_integration.py (the loss falls; gradient
accumulation is equivalent) and tests/test_checkpoint.py's
``test_resume_is_bit_exact``, and holds the training path as a whole
against the reference: the reference's ``train`` writes a checkpoint,
the port's ``train(..., resume=True, device="cpu")`` continues from it
and follows the reference's own continuing run, and the port's
checkpoint restores in the reference.  Those runs are in float32 (both
packages' smoke configs with ``dtype="float32"``, put in place of
``get_smoke_config`` in both trainers), so the losses are held to rtol
1e-4 a step, the standard the trained ``learned`` estimator meets;
weights restored across the two packages are bit-equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as j_train_mod
import repro_torch.launch.train as t_train_mod
from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.train import checkpoint as j_ckpt
from repro.train.optimizer import adamw_init as j_adamw_init
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_to_numpy
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.train import (AdamWConfig, adamw_init, make_train_step,
                               optimizer_view, synthetic_batch)

torch.set_num_threads(2)


def test_loss_decreases():
    _, _, losses = train("mamba2-370m", smoke=True, steps=40, batch=4,
                         seq=64, ckpt_dir=None, resume=False,
                         log_every=1000, lr=3e-3, device="cpu")
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])


def test_grad_accum_equivalent():
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              dtype="float32")
    model = build_model(cfg, remat=False)
    batch = synthetic_batch(cfg, 4, 32, 0, 0, device="cpu")
    ocfg = AdamWConfig(lr=1e-3)
    out = []
    for accum in (1, 2):
        params = model.init(torch.Generator().manual_seed(0))
        step = make_train_step(model, ocfg, accum_steps=accum)
        params, _, _ = step(params, adamw_init(optimizer_view(params)),
                            batch)
        out.append(optimizer_view(params))
    for k in out[0]:
        np.testing.assert_allclose(out[0][k].numpy(), out[1][k].numpy(),
                                   rtol=2e-3, atol=2e-5)


def test_resume_is_bit_exact(tmp_path):
    """train 6 steps straight == train 3, 'crash', resume 3 more."""
    kw = dict(arch="stablelm-3b", smoke=True, batch=2, seq=32,
              ckpt_every=3, log_every=100, device="cpu")
    p_full, _, _ = train(steps=6, ckpt_dir=str(tmp_path / "a"),
                         resume=False, **kw)
    train(steps=3, ckpt_dir=str(tmp_path / "b"), resume=False, **kw)
    p_res, _, _ = train(steps=6, ckpt_dir=str(tmp_path / "b"), resume=True,
                        **kw)
    for x, y in zip(p_full.parameters(), p_res.parameters()):
        assert torch.equal(x, y)


def test_mesh_raises(monkeypatch):
    # every family trains under a mesh (test_torch_elastic,
    # test_torch_sharded_train); an unknown family still raises, from
    # build_model, before the mesh is touched (a string here)
    monkeypatch.setattr(t_train_mod, "get_smoke_config", lambda a: (
        dataclasses.replace(get_smoke_config(a), family="rnn")))
    with pytest.raises(ValueError, match="unknown model family 'rnn'"):
        train("mixtral-8x7b", smoke=True, steps=1, batch=1, seq=8,
              ckpt_dir=None, resume=False, mesh="1x1", device="cpu")


@pytest.fixture
def f32_smoke(monkeypatch):
    """Both trainers' smoke configs in float32."""
    monkeypatch.setattr(j_train_mod, "get_smoke_config", lambda a: (
        dataclasses.replace(j_smoke(a), dtype="float32")))
    monkeypatch.setattr(t_train_mod, "get_smoke_config", lambda a: (
        dataclasses.replace(get_smoke_config(a), dtype="float32")))


def test_port_resumes_the_references_checkpoint(tmp_path, f32_smoke):
    """The training path as a whole: the reference trains mamba2's smoke
    config 3 steps and checkpoints; the port resumes to step 6 and
    follows the reference's own run from the same checkpoint; the port's
    step-6 checkpoint restores in the reference, bit for bit, and the
    reference trains on from it."""
    kw = dict(arch="mamba2-370m", smoke=True, batch=2, seq=32,
              ckpt_every=3, log_every=100)
    j_train_mod.train(steps=3, ckpt_dir=str(tmp_path / "ref"),
                      resume=False, **kw)
    for d in ("port", "cont"):
        (tmp_path / d).mkdir()
        for f in (tmp_path / "ref" / "step_00000003").iterdir():
            (tmp_path / d / "step_00000003").mkdir(exist_ok=True)
            (tmp_path / d / "step_00000003" / f.name).write_bytes(
                f.read_bytes())
    _, _, want = j_train_mod.train(steps=6, ckpt_dir=str(tmp_path / "cont"),
                                   resume=True, **kw)
    params, _, got = train(steps=6, ckpt_dir=str(tmp_path / "port"),
                           resume=True, device="cpu", **kw)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)

    cfg = dataclasses.replace(j_smoke("mamba2-370m"), dtype="float32")
    p_abs = jax.eval_shape(j_build(cfg).init, jax.random.PRNGKey(0))
    opt_abs = jax.eval_shape(j_adamw_init, p_abs)
    (j_params, j_opt), meta = j_ckpt.restore(tmp_path / "port", 6,
                                             (p_abs, opt_abs))
    assert meta["extra"]["data_index"] == 6
    assert int(j_opt.step) == 6
    mine = model_params_to_numpy(cfg, params)
    flat_j = jax.tree_util.tree_flatten_with_path(j_params)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    _, _, more = j_train_mod.train(steps=7, ckpt_dir=str(tmp_path / "port"),
                                   resume=True, **kw)
    assert len(more) == 1 and np.isfinite(more[0])
