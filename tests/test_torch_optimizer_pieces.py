"""The AdamW update in pieces and with the old state donated.

``train.optimizer.adamw_update`` updates each leaf piece by piece, in
pieces of ``PIECE`` elements (its float64 ``fma`` temporaries would
otherwise take tens of GiB at stablelm-3b's widths; a small leaf is one
piece), and with ``donate`` writes the new moments into the old state's
tensors (as the reference's jitted step donates them).  Any piece size
must give the bits of one piece a leaf, since every operation is
element-wise, and match the JAX reference's ``adamw_update``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import AdamWState as JAdamWState
from repro.train.optimizer import adamw_update as j_adamw_update

from repro_torch.train import optimizer as opt
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_init, adamw_update)

CFG = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


def _tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a/w": (3, 37, 11), "b": (29,), "c/w": (64, 5)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    params["d/w"] = torch.from_numpy(rng.standard_normal(
        (9, 13)).astype(np.float32)).to(torch.bfloat16)
    grads = {k: torch.from_numpy(rng.standard_normal(
        tuple(p.shape)).astype(np.float32)).to(p.dtype)
        for k, p in params.items()}
    return params, grads


def _state(params, seed):
    """A state a few steps in: moments that are not zero."""
    rng = np.random.default_rng(seed)
    st = adamw_init(params)
    mu = {k: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32)) * 0.1 for k, t in st.mu.items()}
    nu = {k: torch.from_numpy(rng.random(tuple(t.shape)).astype(
        np.float32)) * 0.01 for k, t in st.nu.items()}
    return AdamWState(step=torch.tensor(3, dtype=torch.int32), mu=mu, nu=nu)


def _copy(state):
    return AdamWState(step=state.step.clone(),
                      mu={k: v.clone() for k, v in state.mu.items()},
                      nu={k: v.clone() for k, v in state.nu.items()})


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("piece", [1, 7, 64, 1000])
@pytest.mark.parametrize("donate", [False, True])
def test_pieces_and_donation_give_the_whole_leaf_bits(monkeypatch, piece,
                                                      donate):
    params, grads = _tree(0)
    state = _state(params, 1)
    want_p, want_s, want_n = adamw_update(CFG, grads, _copy(state), params)
    monkeypatch.setattr(opt, "PIECE", piece)
    old = _copy(state)
    got_p, got_s, got_n = adamw_update(CFG, grads, old, params,
                                       donate=donate)
    assert torch.equal(got_n, want_n) and torch.equal(got_s.step,
                                                      want_s.step)
    _same(got_p, want_p)
    _same(got_s.mu, want_s.mu)
    _same(got_s.nu, want_s.nu)
    for k in params:   # donated: the old state's tensors hold the new
        held = got_s.mu[k] is old.mu[k] and got_s.nu[k] is old.nu[k]
        assert held == donate, k


def test_donation_leaves_params_and_grads_alone():
    params, grads = _tree(2)
    state = _state(params, 3)
    before = ({k: v.clone() for k, v in params.items()},
              {k: v.clone() for k, v in grads.items()})
    adamw_update(CFG, grads, state, params, donate=True)
    _same(params, before[0])
    _same(grads, before[1])


def _jax(tree):
    """A tree of tensors as JAX arrays of the same dtype, on copies: JAX
    may alias a numpy buffer, which a donated update then overwrites."""
    return {k: jnp.asarray(v.float().numpy().copy()).astype(
        jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)
        for k, v in tree.items()}


@pytest.mark.parametrize("piece", [1, 7, 64, 1000])
@pytest.mark.parametrize("donate", [False, True])
def test_pieces_and_donation_match_the_reference(monkeypatch, piece,
                                                 donate):
    """Pieced and donated, three steps, against the jitted JAX update:
    each leaf within a relative 1e-5, and within 1e-5 of its largest
    magnitude where an element is near zero (``p - lr * delta`` cancels
    there, and XLA's fused float32 differs from ``fma`` in the last
    bits)."""
    params, grads = _tree(4)
    state = _state(params, 5)
    jstate = JAdamWState(step=jnp.asarray(state.step), mu=_jax(state.mu),
                         nu=_jax(state.nu))
    jparams = _jax(params)
    update = jax.jit(lambda g, s, p: j_adamw_update(
        JAdamWConfig(**CFG._asdict()), g, s, p))
    monkeypatch.setattr(opt, "PIECE", piece)
    for i in range(3):
        step_grads = {k: g * (i + 1) for k, g in grads.items()}
        jparams, jstate, jnorm = update(_jax(step_grads), jstate, jparams)
        params, state, norm = adamw_update(CFG, step_grads, state, params,
                                           donate=donate)
        np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm),
                                   rtol=1e-6)
    assert int(state.step) == int(jstate.step)
    for k in params:
        for got, want in ((params[k], jparams[k]), (state.mu[k],
                                                     jstate.mu[k]),
                          (state.nu[k], jstate.nu[k])):
            assert got.dtype == (torch.bfloat16 if want.dtype ==
                                 jnp.bfloat16 else torch.float32), k
            want = np.asarray(want.astype(jnp.float32))
            np.testing.assert_allclose(
                got.float().numpy(), want, rtol=1e-5,
                atol=1e-5 * float(np.abs(want).max()), err_msg=k)
