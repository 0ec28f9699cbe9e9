"""The port's MoE layer and the moe family against the JAX reference.

Routing must be exactly equal: the chosen experts, which (token, choice)
pairs are kept, their capacity positions and the capacity; the gates and
the auxiliary loss agree to 1e-6 (softmax and the renormalizing sum
round in another order).  Top-k ties go to the lower expert index on
both sides.  Group sizes cover odd T (one-token groups, cap = 2), even T
and powers of two.  Both dispatch forms agree with the reference to
1e-5 in float32, and in bfloat16 on the same inputs to the dense model
tests' cache tolerance (``tests/test_torch_models.py``); the mixtral-8x7b
and llama4-scout smoke models' prefill and decode logits and caches to
1e-4 in float32, and a bfloat16 mixtral prefill to the dense tests'
tolerances at every token whose expert choices were no near tie (bf16
rounds the two sides' activations differently, and a near tie of the
router can then go either way).  Weights are the
reference's ``model.init``, carried across by ``model_params_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.models import init_cache as j_init_cache
from repro.models import moe as JMOE
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import build_model, init_cache
from repro_torch.models import moe as MOE

torch.set_num_threads(1)

MOE_ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e"]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.15, 0.07)}


def _err(a, b):
    return float(np.max(np.abs(a.float().numpy() - np.asarray(b,
                                                               np.float32))))


def _layer(arch, seed=0):
    """A smoke config in f32 and one MoE layer's parameters on both
    sides."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    jp = JMOE.moe_init(jcfg, jax.random.PRNGKey(seed), jcfg.d_model,
                       jcfg.d_ff)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("n,want", [(1, 1), (7, 1), (1329, 1), (30, 2),
                                    (12, 4), (2048, 2048), (4096, 4096),
                                    (8192, 4096), (6144, 2048)])
def test_group_size(n, want):
    assert MOE._group_size(n) == JMOE._group_size(n) == want


def _route_both(cfg, jcfg, jp, tp, xt):
    jr = JMOE._route(jcfg, jp, jnp.asarray(xt))
    tr = MOE._route(cfg, tp, torch.from_numpy(xt))
    return jr, tr


def _assert_same_route(jr, tr):
    jg, ji, jk, jpos, jcap, jaux = jr
    tg, ti, tk, tpos, tcap, taux = tr
    assert tcap == jcap
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    assert tpos.dtype == torch.int32 and tk.dtype == torch.bool
    assert _err(tg, jg) <= 1e-6
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("t", [1, 7, 37, 64, 96, 128, 1329])
def test_route_matches_reference(arch, t):
    cfg, jcfg, jp, tp = _layer(arch)
    g = MOE._group_size(t)
    xt = np.random.default_rng(t).standard_normal(
        (t // g, g, cfg.d_model)).astype(np.float32)
    jr, tr = _route_both(cfg, jcfg, jp, tp, xt)
    _assert_same_route(jr, tr)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_ties_go_to_the_lower_index(arch):
    """Identical router columns tie every probability: top-k must take
    the lowest indices, as ``lax.top_k`` does."""
    cfg, jcfg, jp, tp = _layer(arch)
    router = np.asarray(jp["router"]).copy()
    router[:, :] = router[:, :1]                    # all experts tie
    router[:, 3] += 0.5                             # but one
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    rng = np.random.default_rng(0)
    xt = np.abs(rng.standard_normal((1, 32, cfg.d_model))).astype(np.float32)
    jr, tr = _route_both(cfg, jcfg, jp, tp, xt)
    _assert_same_route(jr, tr)
    idx = tr[1].numpy()
    assert set(np.unique(idx[..., 0])) <= {0, 3}
    if cfg.top_k == 2:
        assert set(np.unique(idx[..., 1])) <= {0, 1}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_crafted_ties_in_tokens(arch):
    """Tokens that are exact copies route identically, and compete for
    the same capacity slots in order."""
    cfg, jcfg, jp, tp = _layer(arch)
    rng = np.random.default_rng(3)
    base = rng.standard_normal((4, cfg.d_model)).astype(np.float32)
    xt = np.repeat(base, 16, axis=0)[None]          # (1, 64, D)
    jr, tr = _route_both(cfg, jcfg, jp, tp, xt)
    _assert_same_route(jr, tr)
    assert not bool(tr[2].all())                    # over capacity


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("b,s", [(1, 37), (2, 32), (1, 64), (3, 5)])
@pytest.mark.parametrize("form", ["einsum", "scatter"])
def test_moe_apply_matches_reference(arch, b, s, form):
    cfg, jcfg, jp, tp = _layer(arch, seed=b * s)
    x = np.random.default_rng(s).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jfn, tfn = {"einsum": (JMOE.moe_apply_einsum, MOE.moe_apply_einsum),
                "scatter": (JMOE.moe_apply, MOE.moe_apply)}[form]
    jy, jaux = jax.jit(lambda p, x: jfn(jcfg, p, x))(jp, jnp.asarray(x))
    ty, taux = tfn(cfg, tp, torch.from_numpy(x))
    assert ty.shape == (b, s, cfg.d_model) and ty.dtype == torch.float32
    assert _err(ty, jy) <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_two_forms_agree(arch):
    cfg, _, _, tp = _layer(arch, seed=5)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32))
    y1, a1 = MOE.moe_apply_einsum(cfg, tp, x)
    y2, a2 = MOE.moe_apply(cfg, tp, x)
    assert float((y1 - y2).abs().max()) <= 1e-5 and float(a1) == float(a2)


def _both(arch, dtype):
    jcfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jm = j_build(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, jm, jp, tcfg, tm, tp = _both(arch, "float32")
    tol_logits, tol_cache = TOL["float32"]
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 29)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, tcfg.vocab_padded)
    assert _err(tl, jl) < tol_logits
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert _err(tc[key], jc[key]) < tol_cache
    jcache, tcache = j_init_cache(jcfg, 2, 24), init_cache(tcfg, 2, 24,
                                                           device="cpu")
    decode = jax.jit(jm.decode)
    for t in range(20):                 # past the smoke window of 16
        tok = toks[:, t:t + 1]
        jl, jcache = decode(jp, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(tok))
        assert _err(tl, jl) < tol_logits, t
    for key in ("k", "v"):
        assert _err(tcache[key], jcache[key]) < tol_cache


@pytest.mark.parametrize("form", ["einsum", "scatter"])
def test_moe_apply_bf16_matches_reference(form):
    """bf16 on the same bf16 inputs: the routing sees equal inputs, and
    the outputs differ by where each framework rounds to bf16."""
    cfg, jcfg, jp, tp = _layer("mixtral-8x7b", seed=3)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cast = {k: v if k == "router" else v.astype(jnp.bfloat16)
            for k, v in jp.items()}
    jp, tp = cast, {k: (v if k == "router" else v.to(torch.bfloat16))
                    for k, v in tp.items()}
    x = np.random.default_rng(3).standard_normal((2, 40, cfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    jfn, tfn = {"einsum": (JMOE.moe_apply_einsum, MOE.moe_apply_einsum),
                "scatter": (JMOE.moe_apply, MOE.moe_apply)}[form]
    jy, _ = jax.jit(lambda p, x: jfn(jcfg, p, x))(jp, jx)
    ty, _ = tfn(cfg, tp, tx)
    assert ty.dtype == torch.bfloat16
    assert _err(ty, jy) < TOL["bfloat16"][1]


NEAR_TIE = 0.01


def test_bf16_prefill_matches_reference(monkeypatch):
    """A bf16 model: the two sides' activations differ by a rounding step,
    so an expert choice on a near tie of the router (the k-th and
    (k+1)-th probabilities within NEAR_TIE) can go either way and move
    that token's output by a whole expert's.  Layer 0's cache (no expert
    before it) and the last logits hold everywhere; the later layers'
    caches at every token none of whose choices was a near tie."""
    jcfg, jm, jp, tcfg, tm, tp = _both("mixtral-8x7b", "bfloat16")
    tol_logits, tol_cache = TOL["bfloat16"]
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 29)).astype(np.int32)
    gaps = []
    route = MOE._route

    def recording(cfg, p, xt):
        probs = torch.sort(torch.softmax(xt.float() @ p["router"], dim=-1),
                           dim=-1, descending=True).values
        gaps.append((probs[..., cfg.top_k - 1]
                     - probs[..., cfg.top_k]).reshape(toks.shape))
        return route(cfg, p, xt)

    monkeypatch.setattr(MOE, "_route", recording)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    clear = (torch.stack(gaps) >= NEAR_TIE).all(dim=0).numpy()
    assert len(gaps) == tcfg.n_layers and clear.sum() >= 0.75 * clear.size
    assert tl.dtype == torch.bfloat16
    assert _err(tl, jl) < tol_logits
    for key in ("k", "v"):
        err = np.abs(tc[key].float().numpy() - np.asarray(jc[key],
                                                          np.float32))
        assert err[0].max() < tol_cache
        assert err[1:].max(axis=(0, 3, 4))[clear].max() < tol_cache


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_conversion(arch):
    jcfg, jm, jp, tcfg, tm, tp = _both(arch, "bfloat16")
    moe = tp.layers[1].moe
    want = {"router", "wg", "wu", "wd"} | (
        {"shared"} if tcfg.moe_shared_expert else set())
    assert {n for n, _ in moe.named_children()} | {
        n for n, _ in moe.named_parameters(recurse=False)} == want
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].dtype == torch.bfloat16
    assert tuple(moe["wd"].shape) == (tcfg.n_experts, tcfg.d_ff,
                                      tcfg.d_model)
    for name in ("router", "wg", "wu", "wd"):
        ref = np.asarray(jp["layers"]["moe"][name][1], np.float32)
        assert np.array_equal(moe[name].float().numpy(), ref)
    if tcfg.moe_shared_expert:
        ref = np.asarray(jp["layers"]["moe"]["shared"]["wd"][1], np.float32)
        assert np.array_equal(moe["shared"]["wd"].float().numpy(), ref)
    assert not any(p.requires_grad for p in tp.parameters())
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_port_init_shapes(arch):
    """The port's own random init has the reference's leaves and shapes."""
    jcfg, jm, jp, tcfg, tm, tp = _both(arch, "float32")
    own = tm.init(torch.Generator().manual_seed(0))
    shapes = {n: tuple(p.shape) for n, p in own.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in tp.named_parameters()}


def test_full_width_mixtral():
    cfg = get_config("mixtral-8x7b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff, cfg.n_experts,
            cfg.top_k, cfg.window) == ("moe", 32, 4096, 32, 8, 128, 14336,
                                       8, 2, 4096)


def test_odd_length_prefill_runs_every_expert():
    """An odd prompt length gives one-token groups, cap = 2: with top-2
    over 8 experts, 8 slots a token are computed for 2 routed."""
    cfg = get_config("mixtral-8x7b")
    g = MOE._group_size(1329)
    k, E = cfg.top_k, cfg.n_experts
    cap = min(max(8 * ((int(np.ceil(k * g / E * cfg.capacity_factor))
                        + 7) // 8), 8), g * k)
    assert (g, cap, 1329 * E * cap, 1329 * k) == (1, 2, 21264, 2658)
