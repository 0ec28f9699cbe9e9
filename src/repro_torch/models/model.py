"""Model builder (port of ``repro.models.model``), dense family.

``build_model(cfg)`` returns a :class:`Model` with

  init(generator)                 -> params (a :class:`DenseLM` module)
  prefill(params, batch)          -> (last-position logits, cache)
  decode(params, cache, tokens)   -> (logits, cache)

Parameters keep the reference's names and layouts (``x @ w`` weights of
shape (d_in, d_out), float32 norm weights); the layer stack is a loop
over per-layer modules instead of a ``lax.scan`` over stacked leaves.
The cache keeps the reference's layout: ``k``, ``v`` of shape (L, B,
Smax, KV, hd) and a 0-d int32 ``len``.  ``decode`` writes the new K/V
into the cache tensors in place (the reference returns new arrays) and
returns a new dict around them; like the reference's
``dynamic_update_slice`` it clamps the write position to Smax - 1.

Only the dense family is ported; the others raise NotImplementedError.
``loss`` and training are a later slice (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Batch = Dict[str, torch.Tensor]

_LATER = {
    "moe": "ROADMAP queue 1 item 8 (models/moe.py)",
    "ssm": "ROADMAP queue 1 item 8 (models/ssm.py) with kernel 2.5",
    "hybrid": "ROADMAP queue 1 item 8 (models/ssm.py) with kernel 2.5",
    "encdec": "ROADMAP queue 1 item 8 (the encoder-decoder stack)",
    "vlm": "ROADMAP queue 1 item 8 (the VLM patch front end)",
}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; "
            f"{_LATER.get(cfg.family, 'ROADMAP queue 1 item 8')} brings it")


def _params(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Block(nn.Module):
    """One transformer layer's parameters: ln1, attn, ln2, mlp."""

    def __init__(self, tree: Dict[str, Dict[str, torch.Tensor]]):
        super().__init__()
        for name in ("ln1", "attn", "ln2", "mlp"):
            setattr(self, name, _params(tree[name]))


class DenseLM(nn.Module):
    """Embedding, per-layer blocks, final norm and LM head."""

    def __init__(self, tok_emb: torch.Tensor, layers, ln_f, lm_head=None):
        super().__init__()
        self.tok_emb = nn.Parameter(tok_emb, requires_grad=False)
        self.layers = nn.ModuleList(Block(t) for t in layers)
        self.ln_f = _params(ln_f)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[torch.Generator], DenseLM]
    prefill: Callable[[DenseLM, Batch], Tuple[torch.Tensor, Dict]]
    decode: Callable[[DenseLM, Dict, torch.Tensor], Tuple[torch.Tensor, Dict]]


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
    return {"ln1": L.norm_init(cfg, cfg.d_model, gen.device),
            "attn": _attn_init(cfg, gen),
            "ln2": L.norm_init(cfg, cfg.d_model, gen.device),
            "mlp": L.mlp_init(cfg, gen, cfg.d_model, cfg.d_ff)}


def _block_full(cfg, lp: Block, h):
    """Transformer block, full sequence.  Returns (h, (k, v))."""
    y, kv = _attn_full(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1))
    h = h + y
    y = L.mlp_apply(cfg, lp.mlp, L.apply_norm(cfg, h, lp.ln2))
    return h + y, kv


def _block_decode(cfg, lp: Block, h, kc, vc, pos):
    y, kc, vc = _attn_decode(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1),
                             kc, vc, pos)
    h = h + y[:, None, :]
    y = L.mlp_apply(cfg, lp.mlp, L.apply_norm(cfg, h, lp.ln2))
    return h + y, kc, vc


def _lm_head(cfg, params: DenseLM, h):
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
    _require_dense(cfg)
    dt = getattr(torch, cfg.dtype)

    def init(gen: torch.Generator) -> DenseLM:
        """Random weights drawn from ``gen``, on ``gen``'s device."""
        tok_emb = L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt)
        layers = [_layer_init(cfg, gen) for _ in range(cfg.n_layers)]
        lm_head = (None if cfg.tie_embeddings else
                   L.dense_init(gen, cfg.d_model, cfg.vocab_padded, dt))
        return DenseLM(tok_emb, layers,
                       L.norm_init(cfg, cfg.d_model, gen.device), lm_head)

    @torch.no_grad()
    def prefill(params: DenseLM, batch: Batch):
        tokens = batch["tokens"]
        h = params.tok_emb[tokens.long()]
        S = h.shape[1]
        ks, vs = [], []
        for lp in params.layers:
            h, (k, v) = _block_full(cfg, lp, h)
            ks.append(k)
            vs.append(v)
        logits = _lm_head(cfg, params, h[:, -1:, :])[:, 0]
        cache = {"len": torch.tensor(S, dtype=torch.int32, device=h.device),
                 "k": torch.stack(ks), "v": torch.stack(vs)}
        return logits, cache

    @torch.no_grad()
    def decode(params: DenseLM, cache: Dict, tokens: torch.Tensor):
        pos = cache["len"]
        h = params.tok_emb[tokens.long()]                    # (B, 1, D)
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
    """Cache leaf name -> (shape, dtype) for decode at (batch, max_seq)."""
    _require_dense(cfg)
    dt = getattr(torch, cfg.dtype)
    kv = ((cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim_), dt)
    return {"len": ((), torch.int32), "k": kv, "v": kv}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, filled: int = 0,
               *, device="cuda"):
    cache = {name: torch.zeros(shape, dtype=dtype, device=device)
             for name, (shape, dtype) in cache_specs(cfg, batch,
                                                     max_seq).items()}
    cache["len"] = torch.tensor(filled, dtype=torch.int32, device=device)
    return cache
