"""The encoder-decoder (whisper) and VLM (llava) families against the JAX
reference.

Weights come from the reference's ``model.init`` and are carried across
by ``model_params_from_numpy``; inputs come from ``synthetic_batch``,
whose tokens, frames and patches are bit-identical in the two packages.
Prefill logits and every cache leaf (``k``, ``v``, the encdec's ``xk``,
``xv``, and ``len``), then 9 decode steps into a 6-position cache (the
write position clamps at its end as the reference's
``dynamic_update_slice`` clamps it), are held to the jitted reference:
1e-4 in float32 (sum order), and in bfloat16 logits to 0.15 and caches
to 0.07 (the two frameworks round bf16 at different places; a logit of
order 4 carries a bf16 ulp of 1/32).
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
from repro_torch.configs import get_smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import EncDec, build_model, init_cache
from repro_torch.models import layers as L
from repro_torch.train import synthetic_batch

torch.set_num_threads(1)

FAMILIES = ["whisper-medium", "llava-next-mistral-7b"]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.15, 0.07)}
B, T = 2, 29


def _err(a, b):
    return float(np.max(np.abs(a.float().numpy() - np.asarray(b, np.float32))))


def _both(arch, dtype):
    jcfg = dataclasses.replace(j_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jm = j_build(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


def _inputs(cfg, seq=T, index=0):
    """The port's batch without labels, and the same arrays for JAX."""
    batch = synthetic_batch(cfg, B, seq, 0, index, device="cpu")
    del batch["labels"]
    return batch, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _cache_keys(cfg):
    return ("k", "v", "xk", "xv") if cfg.family == "encdec" else ("k", "v")


@pytest.mark.parametrize("arch,dtype", [(a, d) for a in FAMILIES
                                        for d in TOL])
def test_prefill_and_decode_match_reference(arch, dtype):
    jcfg, jm, jp, tcfg, tm, tp = _both(arch, dtype)
    tol_logits, tol_cache = TOL[dtype]
    tb, jb = _inputs(tcfg)
    jl, jc = jax.jit(jm.prefill)(jp, jb)
    tl, tc = tm.prefill(tp, tb)
    assert tl.dtype == getattr(torch, dtype)
    assert tl.shape == (B, tcfg.vocab_padded)
    assert _err(tl, jl) < tol_logits
    assert int(tc["len"]) == int(jc["len"])
    assert tc["len"].dtype == torch.int32
    assert set(tc) == set(jc)
    for key in _cache_keys(tcfg):
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert _err(tc[key], jc[key]) < tol_cache, key

    # 9 decode steps into a 6-position cache, the encdec's cross K/V taken
    # from the prefill
    jcache, tcache = j_init_cache(jcfg, B, 6), init_cache(tcfg, B, 6,
                                                          device="cpu")
    assert set(tcache) == set(jcache)
    if tcfg.family == "encdec":
        jcache["xk"], jcache["xv"] = jc["xk"], jc["xv"]
        tcache["xk"], tcache["xv"] = tc["xk"], tc["xv"]
    toks = tb["tokens"]
    decode = jax.jit(jm.decode)
    for t in range(9):
        tok = toks[:, t:t + 1]
        jl, jcache = decode(jp, jcache, jnp.asarray(tok.numpy()))
        tl, tcache = tm.decode(tp, tcache, tok)
        assert _err(tl, jl) < tol_logits, t
    assert int(tcache["len"]) == int(jcache["len"]) == 9
    for key in _cache_keys(tcfg):
        assert _err(tcache[key], jcache[key]) < tol_cache, key


def test_vlm_cache_counts_the_patches():
    jcfg, jm, jp, tcfg, tm, tp = _both("llava-next-mistral-7b", "float32")
    tb, _ = _inputs(tcfg, seq=11)
    _, cache = tm.prefill(tp, tb)
    assert int(cache["len"]) == tcfg.n_patches + 11 == 19
    assert cache["k"].shape == (tcfg.n_layers, B, 19, tcfg.n_kv_heads,
                                tcfg.head_dim_)


def test_vlm_patches_change_the_logits():
    """The patches are read: other patches give other logits."""
    _, _, _, tcfg, tm, tp = _both("llava-next-mistral-7b", "float32")
    tb, _ = _inputs(tcfg, seq=7)
    a, _ = tm.prefill(tp, tb)
    b, _ = tm.prefill(tp, dict(tb, patches=tb["patches"] * 2.0))
    assert float((a - b).abs().max()) > 1e-3


def test_encdec_decoder_position_clamps_like_the_reference():
    """From len 32766, decode reads dec_pos_emb at 32766, then its last
    row (32767) twice, as ``dynamic_slice_in_dim`` clamps; the K/V write
    clamps to the cache's last position."""
    jcfg, jm, jp, tcfg, tm, tp = _both("whisper-medium", "float32")
    tb, jb = _inputs(tcfg)
    _, jc = jax.jit(jm.prefill)(jp, jb)
    _, tc = tm.prefill(tp, tb)
    jcache = j_init_cache(jcfg, B, 6, filled=32766)
    tcache = init_cache(tcfg, B, 6, filled=32766, device="cpu")
    jcache["xk"], jcache["xv"] = jc["xk"], jc["xv"]
    tcache["xk"], tcache["xv"] = tc["xk"], tc["xv"]
    decode = jax.jit(jm.decode)
    for t in range(3):
        tok = tb["tokens"][:, t:t + 1]
        jl, jcache = decode(jp, jcache, jnp.asarray(tok.numpy()))
        tl, tcache = tm.decode(tp, tcache, tok)
        assert _err(tl, jl) < 1e-4, t
    assert int(tcache["len"]) == 32769
    for key in ("k", "v"):
        assert _err(tcache[key], jcache[key]) < 1e-4


def test_encdec_prefill_decode_consistency():
    """logits(prefill(prompt)) == logits(decode steps over the prompt),
    the cross K/V from a length-1 prefill of the same frames (as
    tests/test_models_smoke.py holds the reference)."""
    cfg = dataclasses.replace(get_smoke_config("whisper-medium"),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    batch, _ = _inputs(cfg, seq=8)
    batch = {k: v[:1] for k, v in batch.items()}
    logits_p, _ = model.prefill(params, batch)
    cache = init_cache(cfg, 1, 12, device="cpu")
    _, c1 = model.prefill(params, dict(batch, tokens=batch["tokens"][:, :1]))
    cache["xk"], cache["xv"] = c1["xk"], c1["xv"]
    for t in range(8):
        lg, cache = model.decode(params, cache, batch["tokens"][:, t:t + 1])
    assert float((lg - logits_p).abs().max()) < 2e-3


def test_encdec_cross_attention_is_unmasked_at_sq_ne_sk(monkeypatch):
    """Each decoder layer's cross attention reaches chunked_attention
    with Sq = T queries against all enc_seq frames, causal=False; the
    encoder's self attention is unmasked at S = enc_seq."""
    cfg = dataclasses.replace(get_smoke_config("whisper-medium"),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    calls = []
    chunked = L.chunked_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal", True),
                      kw.get("window", 0)))
        return chunked(q, k, v, **kw)

    monkeypatch.setattr(L, "chunked_attention", spy)
    batch, _ = _inputs(cfg, seq=5)
    model.prefill(params, batch)
    E = cfg.enc_seq
    assert calls == ([(E, E, False, 0)] * cfg.n_enc_layers
                     + [(5, 5, True, 0), (5, E, False, 0)] * cfg.n_layers)


def test_encdec_params_keep_names_and_dtypes():
    jcfg, jm, jp, tcfg, tm, tp = _both("whisper-medium", "bfloat16")
    assert isinstance(tp, EncDec)
    assert len(tp.enc_layers) == tcfg.n_enc_layers
    assert len(tp.layers) == tcfg.n_layers
    assert set(dict(tp.layers[0].named_children())) == {
        "ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    assert set(tp.enc_layers[0].mlp.keys()) == {"w1", "w2"}
    assert tp.dec_pos_emb.shape == (32768, tcfg.d_model)
    assert tp.enc_pos_emb.shape == (tcfg.enc_seq, tcfg.d_model)
    assert tp.tok_emb.dtype == torch.bfloat16
    assert tp.enc_ln_f["b"].dtype == torch.float32
    assert not any(p.requires_grad for p in tp.parameters())
    want = np.asarray(jp["layers"]["xattn"]["wk"][1], np.float32)
    assert np.array_equal(tp.layers[1].xattn["wk"].float().numpy(), want)
    # a random init on the port's side has the same parameter shapes
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert {n: p.shape for n, p in fresh.named_parameters()} == {
        n: p.shape for n, p in tp.named_parameters()}
