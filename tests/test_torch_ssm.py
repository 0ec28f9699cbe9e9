"""The port's Mamba2 block and the ssm / hybrid models against the JAX
reference.

Weights come from the reference's ``init`` (carried across by
``model_params_from_numpy``), inputs from numpy.  Float32 holds to 1e-4
(sum order inside matrix products, the chunked scan and softmax); the
bfloat16 case holds logits to 0.15 and caches to 0.07, as the dense
models' bf16 case does, because the two frameworks round bf16 at
different places (``x @ w`` outputs, the conv, P before P.V).  The jitted
reference models are built once per (arch, dtype) and shared.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import build_model as j_build
from repro.models import init_cache as j_init_cache
from repro.models import ssm as JSSM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import build_model, init_cache
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM

torch.set_num_threads(1)

ARCHS = ["mamba2-370m", "zamba2-7b"]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.15, 0.07)}


def _err(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        a, np.float32)
    return float(np.max(np.abs(a - np.asarray(b, np.float32))))


def _leaves(cache):
    """name -> tensor or array, the hybrid's shared pair as two leaves."""
    out = {}
    for key, v in cache.items():
        if isinstance(v, tuple):
            out.update({f"{key}.{i}": x for i, x in enumerate(v)})
        else:
            out[key] = v
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    jcfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    jm = j_build(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, jax.jit(jm.prefill), jax.jit(jm.decode), jp


def _both(arch, dtype):
    jcfg, jprefill, jdecode, jp = _reference(arch, dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jcfg, jprefill, jdecode, jp, tcfg, build_model(tcfg), tp


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def _block(arch="mamba2-370m", S=37):
    cfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    jp = JSSM.ssm_init(cfg, jax.random.PRNGKey(1))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    return cfg, jp, tp, x


@pytest.mark.parametrize("S", [37, 64])
def test_ssm_apply_matches_reference(S):
    cfg, jp, tp, x = _block(S=S)
    got = SSM.ssm_apply(cfg, tp, torch.from_numpy(x))
    assert _err(got, JSSM.ssm_apply(cfg, jp, jnp.asarray(x))) < 1e-4
    got, cache = SSM.ssm_apply(cfg, tp, torch.from_numpy(x), with_cache=True)
    want, jcache = JSSM.ssm_apply(cfg, jp, jnp.asarray(x), with_cache=True)
    assert _err(got, want) < 1e-4
    assert tuple(cache.conv.shape) == jcache.conv.shape
    assert _err(cache.conv, jcache.conv) < 1e-4
    assert _err(cache.state, jcache.state) < 1e-4


def test_ssm_decode_matches_reference():
    cfg, jp, tp, x = _block(S=5)
    jcache = JSSM.ssm_cache_init(cfg, 2, jnp.float32)
    tcache = SSM.ssm_cache_init(cfg, 2, torch.float32, device="cpu")
    for t in range(5):
        xt = x[:, t:t + 1]
        want, jcache = JSSM.ssm_decode(cfg, jp, jnp.asarray(xt), jcache)
        got, tcache = SSM.ssm_decode(cfg, tp, torch.from_numpy(xt), tcache)
        assert _err(got, want) < 1e-4, t
        assert _err(tcache.conv, jcache.conv) < 1e-4
        assert _err(tcache.state, jcache.state) < 1e-4


def test_softplus_is_the_reference_one():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.9, 20.5, 40.0], np.float32)
    got = SSM.softplus(torch.from_numpy(x))
    assert _err(got, jax.nn.softplus(jnp.asarray(x))) < 1e-6


def test_ssm_init_distributions():
    cfg = get_config("mamba2-370m")
    p = SSM.ssm_init(cfg, torch.Generator().manual_seed(0))
    d_inner, n, heads, conv_dim = SSM.ssm_dims(cfg)
    assert tuple(p["wxbc"].shape) == (cfg.d_model, conv_dim)
    assert p["wz"].dtype == torch.bfloat16 and p["A_log"].dtype == \
        torch.float32
    dt = SSM.softplus(p["dt_bias"])               # dt ~ U[1e-3, 1e-1]
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1
    A = torch.exp(p["A_log"])                     # A ~ U[1, 16]
    assert float(A.min()) >= 1.0 and float(A.max()) <= 16.0
    assert float(A.std()) > 2.0
    std = float(p["wz"].float().std())
    assert abs(std * math.sqrt(cfg.d_model) - 1.0) < 0.01


def test_card_tensors_take_the_kernel(monkeypatch):
    """On a CUDA tensor ssm_apply calls the kernel's adapter, with the
    state exactly when the cache asks for it, and never ssd_chunked."""
    cfg, jp, tp, x = _block(S=37)
    want, want_cache = SSM.ssm_apply(cfg, tp, torch.from_numpy(x),
                                     with_cache=True)
    plain, calls = SSM.ssd_chunked, []

    def fake_scan(*args, return_state=False):
        x, B, C, dt, A_log, chunk = (
            a.as_subclass(torch.Tensor) if isinstance(a, torch.Tensor)
            else a for a in args)
        calls.append((tuple(x.shape), chunk, return_state))
        y, st = plain(x, B, C, dt, A_log, chunk)
        return (y, st) if return_state else y

    def no_plain(*args):
        raise AssertionError("ssd_chunked ran on a card tensor")

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    monkeypatch.setattr(SSM, "ssd_scan", fake_scan)
    monkeypatch.setattr(SSM, "ssd_chunked", no_plain)
    xc = torch.from_numpy(x).as_subclass(OnCard)
    SSM.ssm_apply(cfg, tp, xc)
    got, cache = SSM.ssm_apply(cfg, tp, xc, with_cache=True)
    assert calls == [((2, 37, 16, 16), 16, False),
                     ((2, 37, 16, 16), 16, True)]
    assert torch.equal(got.as_subclass(torch.Tensor), want)
    assert torch.equal(cache.state, want_cache.state)


# ---------------------------------------------------------------------------
# the ssm and hybrid models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("zamba2-7b", "bfloat16")])
def test_prefill_and_decode_match_reference(arch, dtype):
    jcfg, jprefill, jdecode, jp, tcfg, tm, tp = _both(arch, dtype)
    tol_logits, tol_cache = TOL[dtype]
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 29)).astype(np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == getattr(torch, dtype) and tl.shape == (
        2, tcfg.vocab_padded)
    assert _err(tl, jl) < tol_logits
    want = _leaves(jc)
    got = _leaves(tc)
    assert set(got) == set(want) == (
        {"len", "conv", "state"} | ({"shared.0", "shared.1"}
                                    if arch == "zamba2-7b" else set()))
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert got[key].dtype == getattr(torch, str(want[key].dtype)), key
        assert _err(got[key], want[key]) < tol_cache, key

    # six decode steps from the prefill's cache, padded to max_seq as the
    # serving backend pads it; the shared K/V positions clamp past Smax
    jcache, tcache = j_init_cache(jcfg, 2, 33), init_cache(tcfg, 2, 33,
                                                           device="cpu")
    for key in ("conv", "state"):
        jcache[key] = jc[key]
        tcache[key].copy_(tc[key])
    if arch == "zamba2-7b":
        jcache["shared"] = tuple(
            d.at[:, :, :29].set(s) for s, d in zip(jc["shared"],
                                                   jcache["shared"]))
        for s, d in zip(tc["shared"], tcache["shared"]):
            d[:, :, :29] = s
    jcache["len"] = jc["len"]
    tcache["len"] = tc["len"].clone()
    for t in range(6):
        tok = toks[:, t:t + 1]
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(tok))
        assert _err(tl, jl) < tol_logits, t
    assert int(tcache["len"]) == int(jcache["len"]) == 35
    want, got = _leaves(jcache), _leaves(tcache)
    for key in want:
        assert _err(got[key], want[key]) < tol_cache, key


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_is_the_longer_prefill(arch):
    """prefill(S) + decode(token S) == prefill(S + 1): reads the final
    state and the conv tail."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (1, 21),
                         generator=torch.Generator().manual_seed(2))
    _, c = model.prefill(params, {"tokens": toks[:, :20]})
    cache = init_cache(cfg, 1, 24, device="cpu")
    cache["conv"].copy_(c["conv"])
    cache["state"].copy_(c["state"])
    if cfg.family == "hybrid":
        for s, d in zip(c["shared"], cache["shared"]):
            d[:, :, :20] = s
    cache["len"] = c["len"]
    got, _ = model.decode(params, cache, toks[:, 20:21])
    want, _ = model.prefill(params, {"tokens": toks})
    assert float((got - want).abs().max()) < 1e-4


def test_hybrid_shares_one_attention_block():
    cfg = get_smoke_config("zamba2-7b")
    assert M._shared_idx(cfg) == ([-1, 0, -1, 1], 2)
    assert M.n_shared_invocations(cfg) == 2
    assert M.n_shared_invocations(get_smoke_config("mamba2-370m")) == 0
    full = get_config("zamba2-7b")
    assert M.n_shared_invocations(full) == 9
    specs = M.cache_specs(full, 8, 2560)
    assert specs["state"] == ((81, 8, 112, 64, 64), torch.float32)
    assert specs["shared"][0] == ((9, 8, 2560, 32, 112), torch.bfloat16)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert set(params.shared_block.attn.keys()) == {"wq", "wk", "wv", "wo"}
    assert set(params.layers[0].ssm.keys()) == set(
        JSSM.ssm_init(cfg, jax.random.PRNGKey(0)))
