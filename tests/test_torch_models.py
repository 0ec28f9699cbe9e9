"""The port's model layers and dense models against the JAX reference.

Inputs and weights are made with numpy (weights by the reference's
``model.init``, carried across by ``model_params_from_numpy``) and fed to
both packages.  Float32 cases hold to 1e-4 (sum order inside matrix
products and softmax); the bfloat16 case holds logits to 0.15 and caches
to 0.07, because the two frameworks round bf16 at different places
(``x @ w`` outputs, the scaled query, P before P.V) and a logit of order
4 carries a bf16 ulp of 1/32.
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
from repro.models import layers as JL
from repro_torch.configs import (ARCH_IDS, get_config, get_smoke_config,
                                 shrink)
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import build_model, init_cache
from repro_torch.models import layers as L

torch.set_num_threads(1)

DENSE = ["stablelm-3b", "chatglm3-6b", "minitron-4b", "granite-34b"]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.15, 0.07)}


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _err(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else _np(a)
    return float(np.max(np.abs(a - _np(b))))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _qkv(b, sq, sk, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_chunked_attention_chunk_loop(causal, window):
    """Sq above one query chunk takes the online-softmax loop."""
    q, k, v = _qkv(2, 64, 64, 4, 2, 32, seed=1)
    kw = dict(causal=causal, window=window, q_chunk=16, kv_chunk=16)
    got = L.chunked_attention(_t(q), _t(k), _t(v), **kw)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("sq,q_offset,window", [(37, 0, 0), (8, 5, 0),
                                                (20, 0, 6)])
def test_naive_and_short_chunked_attention(sq, q_offset, window):
    q, k, v = _qkv(1, sq, sq + q_offset, 4, 1, 32, seed=sq)
    for fn, jfn in ((L.naive_attention, JL.naive_attention),
                    (L.chunked_attention, JL.chunked_attention)):
        got = fn(_t(q), _t(k), _t(v), window=window, q_offset=q_offset)
        want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   window=window, q_offset=q_offset)
        assert _err(got, want) < 1e-5


@pytest.mark.parametrize("cache_len,window", [(0, 0), (9, 0), (15, 4)])
def test_decode_attention(cache_len, window):
    q, k, v = _qkv(3, 1, 16, 4, 2, 32, seed=cache_len)
    got = L.decode_attention(_t(q), _t(k), _t(v),
                             torch.tensor(cache_len, dtype=torch.int32),
                             window=window)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(cache_len),
                               window=window)
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("frac", [0.25, 0.5, 1.0])
def test_rope(frac):
    x = np.random.default_rng(0).standard_normal((2, 11, 3, 80)).astype(
        np.float32)
    pos = np.arange(5, 16)
    got = L.rope(_t(x), torch.from_numpy(pos), 10000.0, frac)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, frac)
    assert _err(got, want) < 1e-5


def test_norms_and_mlps():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    assert _err(L.rmsnorm(_t(x), _t(w)),
                JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))) < 1e-5
    assert _err(L.layernorm(_t(x), _t(w), _t(b)),
                JL.layernorm(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(b))) < 1e-5
    for act in ("swiglu", "gelu", "relu2"):
        cfg = dataclasses.replace(j_smoke("stablelm-3b"), act=act,
                                  dtype="float32")
        p = jax.tree.map(np.asarray,
                         JL.mlp_init(cfg, jax.random.PRNGKey(0), 64, 96))
        got = L.mlp_apply(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
        want = JL.mlp_apply(cfg, p, jnp.asarray(x))
        assert _err(got, want) < 1e-4, act


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one, so the card's
    dispatch of ``chunked_attention`` can be checked without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("sq", [37, 2048])
def test_chunked_attention_on_card_takes_the_kernel_or_raises(sq):
    q, k, v = (_t(x).as_subclass(_OnCard)
               for x in _qkv(1, sq, sq, 2, 1, 32, seed=sq))
    # q_offset: the kernel has none, and no plain version stands in.
    with pytest.raises(ValueError, match="query offset"):
        L.chunked_attention(q, k, v, q_offset=3)
    # q_offset 0, at any length: the kernel's wrapper, which refuses the
    # output buffer that lies on the CPU, not the plain version.
    with pytest.raises(ValueError, match="flash_attention_bhsd: out must "
                                         "be on one CUDA device"):
        L.chunked_attention(q, k, v)


# ---------------------------------------------------------------------------
# dense models
# ---------------------------------------------------------------------------

def _both(arch, dtype):
    jcfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jm = j_build(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in DENSE]
                         + [("stablelm-3b", "bfloat16")])
def test_prefill_and_decode_match_reference(arch, dtype):
    jcfg, jm, jp, tcfg, tm, tp = _both(arch, dtype)
    tol_logits, tol_cache = TOL[dtype]
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 29)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == getattr(torch, dtype) and tl.shape == (
        2, tcfg.vocab_padded)
    assert _err(tl, jl) < tol_logits
    assert int(tc["len"]) == int(jc["len"]) == 29
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert _err(tc[key], jc[key]) < tol_cache

    # decode past max_seq: the write position clamps as the reference's
    # dynamic_update_slice clamps it
    jcache, tcache = j_init_cache(jcfg, 2, 6), init_cache(tcfg, 2, 6,
                                                          device="cpu")
    decode = jax.jit(jm.decode)
    for t in range(9):
        tok = toks[:, t:t + 1]
        jl, jcache = decode(jp, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode(tp, tcache, torch.from_numpy(tok))
        assert _err(tl, jl) < tol_logits, t
    assert int(tcache["len"]) == int(jcache["len"]) == 9
    for key in ("k", "v"):
        assert _err(tcache[key], jcache[key]) < tol_cache


def test_padded_vocab_is_masked():
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                               vocab_size=500, dtype="float32")
    tm = build_model(tcfg)
    gen = torch.Generator().manual_seed(0)
    logits, _ = tm.prefill(tm.init(gen),
                           {"tokens": torch.zeros((1, 3), dtype=torch.int32)})
    assert tcfg.vocab_padded == 512
    assert bool((logits[:, 500:] == -1e30).all())
    assert bool(torch.isfinite(logits[:, :500]).all())


def test_prefill_decode_consistency():
    """logits(prefill(prompt)) == logits(decode steps over the prompt)."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (1, 8),
                         generator=torch.Generator().manual_seed(2))
    logits_p, _ = model.prefill(params, {"tokens": toks})
    cache = init_cache(cfg, 1, 12, device="cpu")
    for t in range(8):
        lg, cache = model.decode(params, cache, toks[:, t:t + 1])
    assert float((lg - logits_p).abs().max()) < 2e-3


def test_params_keep_dtype_and_names():
    jcfg, jm, jp, tcfg, tm, tp = _both("granite-34b", "bfloat16")
    assert tp.tok_emb.dtype == torch.bfloat16
    assert tp.layers[0].ln1["w"].dtype == torch.float32
    assert set(tp.layers[0].mlp.keys()) == {"w1", "w2"}
    assert len(tp.layers) == tcfg.n_layers
    assert not any(p.requires_grad for p in tp.parameters())
    # bf16 -> float32 -> bf16 is exact
    want = np.asarray(jp["layers"]["attn"]["wq"][1], np.float32)
    assert np.array_equal(tp.layers[1].attn["wq"].float().numpy(), want)


def test_full_width_config_is_the_reference_one():
    cfg = get_config("stablelm-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_padded) == (
        32, 2560, 32, 32, 80, 6912, 50432)
    assert shrink(cfg) == get_smoke_config("stablelm-3b")
    from repro.configs import get_config as j_config
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            j_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_builds_prefills_and_decodes(arch):
    """Each of the ten configs' smoke size: random weights, a prefill of
    ``synthetic_batch``'s inputs and one decode step, finite logits of
    the padded vocab, and caches of the reference's leaves and shapes."""
    from repro.models import cache_specs as j_cache_specs
    from repro_torch.models import cache_specs
    from repro_torch.train import synthetic_batch

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, 2, 12, 0, 0, device="cpu")
    del batch["labels"]
    logits, cache = model.prefill(params, batch)
    assert logits.shape == (2, cfg.vocab_padded)
    assert bool(torch.isfinite(logits.float()).all())
    assert int(cache["len"]) == 12 + (cfg.n_patches if cfg.family == "vlm"
                                      else 0)
    specs = cache_specs(cfg, 2, 20)
    want = j_cache_specs(j_smoke(arch), 2, 20)
    assert set(specs) == set(want)
    for key, spec in want.items():
        for s, w in zip(specs[key] if isinstance(spec, tuple) else
                        (specs[key],), spec if isinstance(spec, tuple)
                        else (spec,)):
            assert s[0] == w.shape, key
    c2 = init_cache(cfg, 2, 20, device="cpu")
    if cfg.family == "encdec":
        c2["xk"], c2["xv"] = cache["xk"], cache["xv"]
    lg, c2 = model.decode(params, c2, batch["tokens"][:, :1])
    assert lg.shape == (2, cfg.vocab_padded)
    assert int(c2["len"]) == 1
    assert bool(torch.isfinite(lg.float()).all())


@pytest.mark.parametrize("arch,missing", [("whisper-medium", "frames"),
                                          ("llava-next-mistral-7b",
                                           "patches")])
def test_serving_backend_admission_raises_like_the_reference(arch, missing):
    """The reference's backend prefills a request from its tokens alone,
    so a whisper or llava admission raises KeyError for the missing input
    there; the port's backend does exactly the same."""
    from repro.launch import serve as j_serve
    from repro.serving.engine import Request as JRequest
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Request

    backends = ((j_serve.RealModelBackend(arch, 1, 2, max_seq=32),
                 JRequest(rid=0, prompt_len=5, max_tokens=8, true_tokens=4,
                          replica=0)),
                (serve.RealModelBackend(arch, 1, 2, max_seq=32,
                                        device="cpu"),
                 Request(rid=0, prompt_len=5, max_tokens=8, true_tokens=4,
                         replica=0)))
    for backend, req in backends:
        with pytest.raises(KeyError, match=missing):
            backend.on_admit(req)
