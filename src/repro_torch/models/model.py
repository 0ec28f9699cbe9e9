"""Model builder (port of ``repro.models.model``): the dense, moe, ssm
and hybrid families.

``build_model(cfg)`` returns a :class:`Model` with

  init(generator)                 -> params (an :class:`LM` module)
  prefill(params, batch)          -> (last-position logits, cache)
  decode(params, cache, tokens)   -> (logits, cache)

Parameters keep the reference's names and layouts (``x @ w`` weights of
shape (d_in, d_out), float32 norm weights); the layer stack is a loop
over per-layer modules instead of a ``lax.scan`` over stacked leaves, and
a Python ``if`` takes the place of the hybrid's ``lax.cond``.  The cache
keeps the reference's layout and a 0-d int32 ``len``: ``k``, ``v`` of
shape (L, B, Smax, KV, hd) (dense); ``conv`` (L, B, W-1, conv_dim),
``state`` (L, B, H, P, N) float32 and, for the hybrid, ``shared``, a
(k, v) pair of (n_inv, B, Smax, KV, hd) for the shared attention block's
invocations.  ``decode`` writes into the cache tensors in place (the
reference returns new arrays) and returns a new dict around them; like
the reference's ``dynamic_update_slice`` it clamps the K/V write
position to Smax - 1.

A moe layer's ``moe`` group holds the router, the experts' weights and,
for llama4-scout, a nested ``shared`` MLP group; prefill and decode both
run the one-hot einsum dispatch (``moe.moe_apply_einsum``), as the
reference's serving does.  The encdec and vlm families raise
NotImplementedError; they, ``loss`` and training are a later slice
(ROADMAP queue 1 item 7).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Batch = Dict[str, torch.Tensor]

PORTED = ("dense", "moe", "ssm", "hybrid")
MAMBA = ("ssm", "hybrid")            # the families with Mamba2 layers
_LATER = {
    "encdec": "ROADMAP queue 1 item 7 (the encoder-decoder stack)",
    "vlm": "ROADMAP queue 1 item 7 (the VLM patch front end)",
}


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; "
            f"{_LATER.get(cfg.family, 'ROADMAP queue 1 item 7')} brings it")


class _Group(nn.Module):
    """A parameter group with nested groups (the moe group's ``shared``),
    read with ``[]`` as a ParameterDict is."""

    def __init__(self, tree):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, _params(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)


def _params(tree):
    if any(isinstance(leaf, dict) for leaf in tree.values()):
        return _Group(tree)
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Block(nn.Module):
    """One layer's parameter groups, by the reference's names: ln1, attn,
    ln2, mlp (a transformer layer or the hybrid's shared block), ln1,
    attn, ln2, moe (an MoE layer), or ln1, ssm (a Mamba2 layer)."""

    def __init__(self, tree: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for name, group in tree.items():
            setattr(self, name, _params(group))


class LM(nn.Module):
    """Embedding, per-layer blocks, the hybrid's shared block, final norm
    and LM head."""

    def __init__(self, tok_emb: torch.Tensor, layers, ln_f, lm_head=None,
                 shared_block=None):
        super().__init__()
        self.tok_emb = nn.Parameter(tok_emb, requires_grad=False)
        self.layers = nn.ModuleList(Block(t) for t in layers)
        self.ln_f = _params(ln_f)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))
        self.shared_block = (None if shared_block is None
                             else Block(shared_block))


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[torch.Generator], LM]
    prefill: Callable[[LM, Batch], Tuple[torch.Tensor, Dict]]
    decode: Callable[[LM, Dict, torch.Tensor], Tuple[torch.Tensor, Dict]]


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def _attn_init(cfg: ModelConfig, gen: torch.Generator):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = getattr(torch, cfg.dtype)
    return {"wq": L.dense_init(gen, d, H * hd, dt),
            "wk": L.dense_init(gen, d, KV * hd, dt),
            "wv": L.dense_init(gen, d, KV * hd, dt),
            "wo": L.dense_init(gen, H * hd, d, dt)}


def _qkv(cfg, p, x):
    B, S = x.shape[:2]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    return q, k, v


def _attn_full(cfg, p, x):
    """Full-sequence causal self attention.  Returns (out, (k, v))."""
    q, k, v = _qkv(cfg, p, x)
    if cfg.rope_frac > 0:
        pos = torch.arange(x.shape[1], device=x.device)
        q = L.rope(q, pos, cfg.rope_theta, cfg.rope_frac)
        k = L.rope(k, pos, cfg.rope_theta, cfg.rope_frac)
    o = L.chunked_attention(q, k, v, causal=True, window=cfg.window)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"], (k, v)


def _attn_decode(cfg, p, x, k_cache, v_cache, pos):
    """Single-token attention; writes the token's K/V into the caches in
    place at ``min(pos, Smax - 1)``.  Returns (out, k_cache, v_cache)."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    k = (x @ p["wk"]).reshape(B, 1, KV, hd)
    v = (x @ p["wv"]).reshape(B, 1, KV, hd)
    if cfg.rope_frac > 0:
        pp = pos.reshape(1)
        q = L.rope(q, pp, cfg.rope_theta, cfg.rope_frac)
        k = L.rope(k, pp, cfg.rope_theta, cfg.rope_frac)
    at = torch.clamp(pos, max=k_cache.shape[1] - 1).reshape(1).long()
    k_cache.index_copy_(1, at, k.to(k_cache.dtype))
    v_cache.index_copy_(1, at, v.to(v_cache.dtype))
    o = L.decode_attention(q, k_cache, v_cache, pos, window=cfg.window)
    return o.reshape(B, -1) @ p["wo"], k_cache, v_cache


# ---------------------------------------------------------------------------
# per-layer blocks (full-sequence + decode variants)
# ---------------------------------------------------------------------------

def _layer_init(cfg: ModelConfig, gen: torch.Generator):
    if cfg.family in MAMBA:
        return {"ln1": L.norm_init(cfg, cfg.d_model, gen.device),
                "ssm": SSM.ssm_init(cfg, gen)}
    p = {"ln1": L.norm_init(cfg, cfg.d_model, gen.device),
         "attn": _attn_init(cfg, gen),
         "ln2": L.norm_init(cfg, cfg.d_model, gen.device)}
    if cfg.family == "moe":
        p["moe"] = MOE.moe_init(cfg, gen, cfg.d_model, cfg.d_ff)
    else:
        p["mlp"] = L.mlp_init(cfg, gen, cfg.d_model, cfg.d_ff)
    return p


def _ffn(cfg, lp: Block, x):
    """The layer's MLP, or its MoE in the einsum dispatch form."""
    if cfg.family == "moe":
        return MOE.moe_apply_einsum(cfg, lp.moe, x)[0]
    return L.mlp_apply(cfg, lp.mlp, x)


def _block_full(cfg, lp: Block, h):
    """Transformer block, full sequence.  Returns (h, (k, v))."""
    y, kv = _attn_full(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1))
    h = h + y
    return h + _ffn(cfg, lp, L.apply_norm(cfg, h, lp.ln2)), kv


def _block_decode(cfg, lp: Block, h, kc, vc, pos):
    y, kc, vc = _attn_decode(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1),
                             kc, vc, pos)
    h = h + y[:, None, :]
    return h + _ffn(cfg, lp, L.apply_norm(cfg, h, lp.ln2)), kc, vc


# ---------------------------------------------------------------------------
# Mamba2 stacks (ssm / hybrid)
# ---------------------------------------------------------------------------

def _shared_idx(cfg) -> Tuple[List[int], int]:
    """Per-layer invocation index for the hybrid shared attention block
    (-1: none), and the number of invocations."""
    idx, n = [], 0
    for i in range(cfg.n_layers):
        if cfg.attn_every and (i % cfg.attn_every == cfg.attn_every - 1):
            idx.append(n)
            n += 1
        else:
            idx.append(-1)
    return idx, n


def n_shared_invocations(cfg) -> int:
    return _shared_idx(cfg)[1] if cfg.family == "hybrid" else 0


def _inv_idx(cfg) -> List[int]:
    return (_shared_idx(cfg)[0] if cfg.family == "hybrid"
            else [-1] * cfg.n_layers)


def _ssm_stack_full(cfg, params: LM, h):
    """Prefill through a Mamba2 stack.  Returns (h, conv (L, B, W-1,
    conv_dim), state (L, B, H, P, N), shared (k, v) or None)."""
    convs, states, ks, vs = [], [], [], []
    for lp, inv in zip(params.layers, _inv_idx(cfg)):
        y, c = SSM.ssm_apply(cfg, lp.ssm, L.apply_norm(cfg, h, lp.ln1),
                             with_cache=True)
        h = h + y
        convs.append(c.conv)
        states.append(c.state)
        if inv >= 0:
            sp = params.shared_block
            y, (k, v) = _attn_full(cfg, sp.attn, L.apply_norm(cfg, h, sp.ln1))
            h = h + y
            h = h + L.mlp_apply(cfg, sp.mlp, L.apply_norm(cfg, h, sp.ln2))
            ks.append(k)
            vs.append(v)
    shared = (torch.stack(ks), torch.stack(vs)) if ks else None
    return h, torch.stack(convs), torch.stack(states), shared


def _ssm_stack_decode(cfg, params: LM, h, cache, pos):
    """One-token decode through a Mamba2 stack; writes the conv windows,
    the states and the shared K/V into the cache in place."""
    for i, (lp, inv) in enumerate(zip(params.layers, _inv_idx(cfg))):
        y, c = SSM.ssm_decode(cfg, lp.ssm, L.apply_norm(cfg, h, lp.ln1),
                              SSM.SSMCache(cache["conv"][i],
                                           cache["state"][i]))
        h = h + y
        cache["conv"][i].copy_(c.conv)
        cache["state"][i].copy_(c.state)
        if inv >= 0:
            sp = params.shared_block
            sk, sv = cache["shared"][0][inv], cache["shared"][1][inv]
            y, _, _ = _attn_decode(cfg, sp.attn,
                                   L.apply_norm(cfg, h, sp.ln1)[:, 0],
                                   sk, sv, pos)
            h = h + y[:, None, :]
            h = h + L.mlp_apply(cfg, sp.mlp, L.apply_norm(cfg, h, sp.ln2))
    return h


def _lm_head(cfg, params: LM, h):
    h = L.apply_norm(cfg, h, params.ln_f)
    w = params.tok_emb.T if cfg.tie_embeddings else params.lm_head
    logits = h @ w
    if cfg.vocab_padded != cfg.vocab_size:  # mask the padding entries
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# build_model
# ---------------------------------------------------------------------------

def build_model(cfg: ModelConfig) -> Model:
    require_ported(cfg)
    dt = getattr(torch, cfg.dtype)
    mamba = cfg.family in MAMBA

    def init(gen: torch.Generator) -> LM:
        """Random weights drawn from ``gen``, on ``gen``'s device."""
        tok_emb = L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt)
        layers = [_layer_init(cfg, gen) for _ in range(cfg.n_layers)]
        lm_head = (None if cfg.tie_embeddings else
                   L.dense_init(gen, cfg.d_model, cfg.vocab_padded, dt))
        shared = None
        if cfg.family == "hybrid":
            shared = {"ln1": L.norm_init(cfg, cfg.d_model, gen.device),
                      "attn": _attn_init(cfg, gen),
                      "ln2": L.norm_init(cfg, cfg.d_model, gen.device),
                      "mlp": L.mlp_init(cfg, gen, cfg.d_model, cfg.d_ff)}
        return LM(tok_emb, layers, L.norm_init(cfg, cfg.d_model, gen.device),
                  lm_head, shared)

    @torch.no_grad()
    def prefill(params: LM, batch: Batch):
        tokens = batch["tokens"]
        h = params.tok_emb[tokens.long()]
        cache = {"len": torch.tensor(h.shape[1], dtype=torch.int32,
                                     device=h.device)}
        if mamba:
            h, cache["conv"], cache["state"], shared = _ssm_stack_full(
                cfg, params, h)
            if cfg.family == "hybrid":
                cache["shared"] = shared
        else:
            ks, vs = [], []
            for lp in params.layers:
                h, (k, v) = _block_full(cfg, lp, h)
                ks.append(k)
                vs.append(v)
            cache["k"], cache["v"] = torch.stack(ks), torch.stack(vs)
        logits = _lm_head(cfg, params, h[:, -1:, :])[:, 0]
        return logits, cache

    @torch.no_grad()
    def decode(params: LM, cache: Dict, tokens: torch.Tensor):
        pos = cache["len"]
        h = params.tok_emb[tokens.long()]                    # (B, 1, D)
        if mamba:
            h = _ssm_stack_decode(cfg, params, h, cache, pos)
        else:
            for i, lp in enumerate(params.layers):
                h, _, _ = _block_decode(cfg, lp, h, cache["k"][i],
                                        cache["v"][i], pos)
        logits = _lm_head(cfg, params, h[:, -1:, :])[:, 0]
        return logits, dict(cache, len=pos + 1)

    return Model(cfg=cfg, init=init, prefill=prefill, decode=decode)


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """Cache leaf name -> (shape, dtype) for decode at (batch, max_seq);
    the hybrid's ``shared`` maps to a (k, v) pair of them."""
    require_ported(cfg)
    dt = getattr(torch, cfg.dtype)
    Ld = cfg.n_layers
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    c = {"len": ((), torch.int32)}
    if cfg.family in MAMBA:
        d_inner, n, heads, conv_dim = SSM.ssm_dims(cfg)
        c["conv"] = ((Ld, batch, cfg.conv_width - 1, conv_dim), dt)
        c["state"] = ((Ld, batch, heads, cfg.ssm_head_dim, n), torch.float32)
        if cfg.family == "hybrid":
            kv = ((n_shared_invocations(cfg), batch, max_seq, KV, hd), dt)
            c["shared"] = (kv, kv)
        return c
    c["k"] = c["v"] = ((Ld, batch, max_seq, KV, hd), dt)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, filled: int = 0,
               *, device="cuda"):
    def zeros(spec):
        if isinstance(spec[1], torch.dtype):
            return torch.zeros(spec[0], dtype=spec[1], device=device)
        return tuple(zeros(s) for s in spec)

    cache = {name: zeros(spec)
             for name, spec in cache_specs(cfg, batch, max_seq).items()}
    cache["len"] = torch.tensor(filled, dtype=torch.int32, device=device)
    return cache
