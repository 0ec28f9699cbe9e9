"""The port's ``loss`` and its gradients against the JAX reference.

For the smoke configs of all six families, in float32, with the
reference's ``init`` weights carried across by ``model_params_from_numpy``
and the same ``synthetic_batch`` (bit-identical in both packages): the
loss, its ``ce`` and ``aux``, and every gradient leaf against
``jax.jit(jax.value_and_grad(model.loss, has_aux=True))``.  The port's
gradients come in the reference's tree layout (``train_step.
value_and_grad``: ``layers`` stacked by ``convert.model_tree``).
Tolerances: the loss and its metrics within rtol 1e-5; each gradient leaf
within 1e-4 of its own largest magnitude (float32 sums in other orders:
XLA fuses and reorders; measured within 3e-6).  ``_xent`` against the
reference's with masked labels and the vocab padding at -1e30, rtol
1e-6.  The flag ``no_kernels``, the card's raises and the flash call's
route under grad use CPU tensors that report themselves as CUDA ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.models.model import _xent as j_xent
from repro.train.data import synthetic_batch as j_batch
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (model_params_from_numpy,
                                 model_params_to_numpy, model_tree)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import build_model, kernels_allowed, no_kernels
from repro_torch.models import layers as L
from repro_torch.models.model import _xent
from repro_torch.train.data import synthetic_batch
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(1)

FAMILIES = ["stablelm-3b", "mixtral-8x7b", "mamba2-370m", "zamba2-7b",
            "whisper-medium", "llava-next-mistral-7b"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def _configs(arch):
    return (dataclasses.replace(j_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _both(arch, batch, seq, remat=False):
    """The reference's and the port's loss, metrics and gradients on the
    same weights and batch."""
    jc, tc = _configs(arch)
    jm, tm = j_build(jc, remat=remat), build_model(tc, remat=remat)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = model_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    jb = j_batch(jc, batch, seq, 0, 0)
    tb = synthetic_batch(tc, batch, seq, 0, 0, device="cpu")
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    return (jl, jmet, jg), value_and_grad(tm, tp, tb)


def _assert_matches(ref, port):
    (jl, jmet, jg), (loss, met, grads) = ref, port
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    leaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(leaves) == len(grads)
    for path, leaf in leaves:
        key = "/".join(p.key for p in path)
        want = np.asarray(leaf)
        got = grads[key].numpy()
        assert got.shape == want.shape, key
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= GRAD_REL * scale, key


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    ref, port = _both(arch, 2, 24)
    _assert_matches(ref, port)


def test_loss_with_remat_matches_reference():
    """Per-layer recomputation (the hybrid's shared block inside the
    recomputed body) changes no number."""
    ref, port = _both("zamba2-7b", 2, 24, remat=True)
    _assert_matches(ref, port)


def test_mamba2_at_odd_length():
    """At odd S the reference's ssd_chunked halves its chunk to 1; the
    port's CPU path keeps that split."""
    ref, port = _both("mamba2-370m", 2, 23)
    _assert_matches(ref, port)


def test_xent_matches_reference():
    rng = np.random.default_rng(4)
    B, S, V, Vp = 3, 7, 50, 64
    logits = rng.standard_normal((B, S, Vp)).astype(np.float32) * 3
    logits[..., V:] = -1e30                    # the vocab padding
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -1                         # masked positions
    mask = (labels >= 0).astype(np.float32)
    lbl = np.maximum(labels, 0)
    want = j_xent(jnp.asarray(logits), jnp.asarray(lbl), jnp.asarray(mask))
    got = _xent(torch.from_numpy(logits), torch.from_numpy(lbl),
                torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    # every position masked: the denominator is 1, the loss 0
    zero = np.zeros_like(mask)
    got = _xent(torch.from_numpy(logits), torch.from_numpy(lbl),
                torch.from_numpy(zero))
    assert float(got[0]) == 0.0 and float(got[1]) == 0.0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "whisper-medium"])
def test_model_params_to_numpy_inverts_from_numpy(arch):
    jc, tc = _configs(arch)
    tree = jax.tree.map(np.asarray, j_build(jc).init(jax.random.PRNGKey(1)))
    back = model_params_to_numpy(tc, model_params_from_numpy(tc, tree,
                                                             device="cpu"))
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_t, flat_b):
        np.testing.assert_array_equal(a, b)
    # model_tree keeps tensors: a stacked leaf leads with the layer count
    module = model_params_from_numpy(tc, tree, device="cpu")
    assert model_tree(module)["layers"]["ln1"]["w"].shape[0] == tc.n_layers


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


def test_no_kernels_flag_and_card_raises():
    assert kernels_allowed()
    with no_kernels():
        assert not kernels_allowed()
        with no_kernels():
            assert not kernels_allowed()
        assert not kernels_allowed()
        # a CPU tensor takes the plain version whatever the flag
        q = torch.randn(1, 8, 2, 16)
        out = L.chunked_attention(q, q[:, :, :1], q[:, :, :1])
        assert out.shape == q.shape
        card = q.as_subclass(_OnCard)
        with pytest.raises(RuntimeError, match="no_kernels"):
            L.chunked_attention(card, card[:, :, :1], card[:, :, :1])
        from repro_torch.models import ssm as SSM
        _, tc = _configs("mamba2-370m")
        p = SSM.ssm_init(tc, torch.Generator().manual_seed(0))
        x = torch.randn(1, 8, tc.d_model).as_subclass(_OnCard)
        with pytest.raises(RuntimeError, match="no_kernels"):
            SSM.ssm_apply(tc, p, x)
    assert kernels_allowed()


def test_flash_under_grad_on_the_card_takes_the_function(monkeypatch):
    """The call that raised before the backward kernel existed now goes
    through ``FlashAttention``, whose backward is that kernel."""
    seen = []

    def apply(*args):
        seen.append(args)
        return "out", "lse"

    monkeypatch.setattr(flash_ops.FlashAttention, "apply", apply)
    q = torch.randn(1, 8, 2, 16).as_subclass(_OnCard).requires_grad_()
    assert flash_attention(q, q, q) == "out"
    assert len(seen) == 1 and seen[0][3:] == (True, 0)
