"""The model families (port of ``repro.models.model``): dense, moe, ssm,
hybrid, encdec and vlm.

``build_model(cfg, remat=True)`` returns a :class:`Model` with

  init(generator)                 -> params (an :class:`LM` module, or an
                                     :class:`EncDec` for the encdec family)
  loss(params, batch)             -> (scalar loss, metrics dict)  [train]
  prefill(params, batch)          -> (last-position logits, cache)
  decode(params, cache, tokens)   -> (logits, cache)

Parameters keep the reference's names and layouts (``x @ w`` weights of
shape (d_in, d_out), float32 norm weights); the layer stack is a loop
over per-layer modules instead of a ``lax.scan`` over stacked leaves, and
a Python ``if`` takes the place of the hybrid's ``lax.cond``.  The cache
keeps the reference's layout and a 0-d int32 ``len``: ``k``, ``v`` of
shape (L, B, Smax, KV, hd) (dense, moe, vlm; encdec adds the decoder's
cross-attention K/V ``xk``, ``xv`` of (L, B, enc_seq, KV, hd), which
decode reads and never writes); ``conv`` (L, B, W-1, conv_dim),
``state`` (L, B, H, P, N) float32 and, for the hybrid, ``shared``, a
(k, v) pair of (n_inv, B, Smax, KV, hd) for the shared attention block's
invocations.  ``decode`` writes into the cache tensors in place (the
reference returns new arrays) and returns a new dict around them; like
the reference's ``dynamic_update_slice`` it clamps the K/V write
position to Smax - 1.

A moe layer's ``moe`` group holds the router, the experts' weights and,
for llama4-scout, a nested ``shared`` MLP group; prefill and decode both
run the one-hot einsum dispatch (``moe.moe_apply_einsum``), as the
reference's serving does.

The encdec family is whisper's stack: ``batch["frames"]`` (B, enc_seq,
d_model), cast to the model dtype, run through an unmasked encoder; the
decoder adds learned positions (``dec_pos_emb`` read at ``len``, clamped
to its last row in decode as ``dynamic_slice_in_dim`` clamps), and each
layer runs causal self attention, cross attention over the encoder's
output (unmasked, Sq != Sk) and an MLP.  The vlm family puts
``batch["patches"]`` (B, n_patches, d_model) in front of the token
embeddings and runs the dense stack, so ``len`` and the positions count
the patches.

``loss`` mirrors the reference's ``_loss_inner``: the full-sequence
stack, the LM head over every position, cross entropy plus the 1e-4
z-loss over the positions whose label is >= 0 (encdec's labels as they
come, vlm's with -1 at the patch positions), plus 0.01 times the MoE
layers' summed aux loss; metrics ``ce`` and, except for encdec, ``aux``.
MoE layers take the scatter dispatch (``moe.moe_apply``) there, as the
reference's training does.  With ``remat`` each layer's body (an encoder
or decoder layer, a transformer layer, or a Mamba2 layer with the
hybrid's shared block where it runs) is recomputed in the backward pass
(``torch.utils.checkpoint``, non-reentrant) wherever the reference wraps
it in ``jax.checkpoint``.  Unlike the reference's, the port's ``loss``
does not enter ``layers.no_kernels()``: on the card the SSD scan and
flash attention run their kernels with hand-written backward kernels
(``SSDScan``, ``FlashAttention``).  Under ``remat`` each layer's
attention forward runs twice a step (once forward, once recomputed) and
its backward once.  Gradients come from autograd over the module's
parameters (``train.train_step``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.sharding.api import constrain

Batch = Dict[str, torch.Tensor]

PORTED = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
MAMBA = ("ssm", "hybrid")            # the families with Mamba2 layers
MAX_DEC_POS = 32_768                 # rows of the encdec's dec_pos_emb


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise ValueError(f"{cfg.name}: unknown model family "
                         f"{cfg.family!r}; one of {PORTED}")


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


class EncDec(nn.Module):
    """Whisper's stack: tied token embedding, learned decoder and encoder
    positions, the encoder's blocks (ln1, attn, ln2, mlp) and final norm,
    the decoder's blocks (ln1, attn, lnx, xattn, ln2, mlp) and final
    norm."""

    def __init__(self, tok_emb, dec_pos_emb, enc_pos_emb, enc_layers,
                 enc_ln_f, layers, ln_f):
        super().__init__()
        self.tok_emb = nn.Parameter(tok_emb, requires_grad=False)
        self.dec_pos_emb = nn.Parameter(dec_pos_emb, requires_grad=False)
        self.enc_pos_emb = nn.Parameter(enc_pos_emb, requires_grad=False)
        self.enc_layers = nn.ModuleList(Block(t) for t in enc_layers)
        self.enc_ln_f = _params(enc_ln_f)
        self.layers = nn.ModuleList(Block(t) for t in layers)
        self.ln_f = _params(ln_f)


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[torch.Generator], nn.Module]
    loss: Callable[[nn.Module, Batch],
                   Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    prefill: Callable[[nn.Module, Batch], Tuple[torch.Tensor, Dict]]
    decode: Callable[[nn.Module, Dict, torch.Tensor],
                     Tuple[torch.Tensor, Dict]]


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


def _qkv(cfg, p, x, kv_x=None):
    B, S = x.shape[:2]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    q = L.split_heads(x @ p["wq"], (B, S, H, hd))
    k = L.split_heads(kv_x @ p["wk"], (B, Skv, KV, hd))
    v = L.split_heads(kv_x @ p["wv"], (B, Skv, KV, hd))
    return q, k, v


def _attn_full(cfg, p, x, pos0=0, *, causal=True, use_rope=True):
    """Full-sequence self attention.  Returns (out, (k, v))."""
    q, k, v = _qkv(cfg, p, x)
    if use_rope and cfg.rope_frac > 0:
        pos = pos0 + torch.arange(x.shape[1], device=x.device)
        q = L.rope(q, pos, cfg.rope_theta, cfg.rope_frac)
        k = L.rope(k, pos, cfg.rope_theta, cfg.rope_frac)
    o = L.chunked_attention(q, k, v, causal=causal,
                            window=cfg.window if causal else 0)
    return L.merge_heads(o, p["wo"]), (k, v)


def _attn_cross(cfg, p, x, k, v):
    """Cross attention against precomputed encoder K/V (no mask, no
    rope): Sq is the decoder's length, Sk the encoder's."""
    B, S = x.shape[:2]
    H, hd = cfg.n_heads, cfg.head_dim_
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    o = L.chunked_attention(q, k, v, causal=False)
    return L.merge_heads(o, p["wo"])


def _attn_decode(cfg, p, x, k_cache, v_cache, pos, *, use_rope=True,
                 cross=False):
    """Single-token attention; writes the token's K/V into the caches in
    place at ``min(pos, Smax - 1)``, or with ``cross`` attends over every
    position of the (encoder) caches and writes nothing.  Returns (out,
    k_cache, v_cache)."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = L.split_heads(x @ p["wq"], (B, 1, H, hd))
    if cross:
        if use_rope and cfg.rope_frac > 0:
            q = L.rope(q, pos.reshape(1), cfg.rope_theta, cfg.rope_frac)
        o = L.decode_attention(q, k_cache, v_cache, k_cache.shape[1] - 1)
        return L.merge_heads(o[:, 0], p["wo"]), k_cache, v_cache
    k = L.split_heads(x @ p["wk"], (B, 1, KV, hd))
    v = L.split_heads(x @ p["wv"], (B, 1, KV, hd))
    if use_rope and cfg.rope_frac > 0:
        pp = pos.reshape(1)
        q = L.rope(q, pp, cfg.rope_theta, cfg.rope_frac)
        k = L.rope(k, pp, cfg.rope_theta, cfg.rope_frac)
    at = torch.clamp(pos, max=k_cache.shape[1] - 1).reshape(1).long()
    L.write_position(k_cache, at, k.to(k_cache.dtype))
    L.write_position(v_cache, at, v.to(v_cache.dtype))
    o = L.decode_attention(q, k_cache, v_cache, pos, window=cfg.window)
    return L.merge_heads(o[:, 0], p["wo"]), k_cache, v_cache


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


# ---------------------------------------------------------------------------
# whisper-style encoder-decoder
# ---------------------------------------------------------------------------

def _encdec_init(cfg: ModelConfig, gen: torch.Generator) -> EncDec:
    dt = getattr(torch, cfg.dtype)
    d, dev = cfg.d_model, gen.device

    def pos_emb(rows):
        w = torch.randn((rows, d), generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * 0.01).to(dt)

    def enc_layer():
        return {"ln1": L.norm_init(cfg, d, dev), "attn": _attn_init(cfg, gen),
                "ln2": L.norm_init(cfg, d, dev),
                "mlp": L.mlp_init(cfg, gen, d, cfg.d_ff)}

    def dec_layer():
        return {"ln1": L.norm_init(cfg, d, dev), "attn": _attn_init(cfg, gen),
                "lnx": L.norm_init(cfg, d, dev),
                "xattn": _attn_init(cfg, gen),
                "ln2": L.norm_init(cfg, d, dev),
                "mlp": L.mlp_init(cfg, gen, d, cfg.d_ff)}

    return EncDec(L.embed_init(gen, cfg.vocab_padded, d, dt),
                  pos_emb(MAX_DEC_POS), pos_emb(cfg.enc_seq),
                  [enc_layer() for _ in range(cfg.n_enc_layers)],
                  L.norm_init(cfg, d, dev),
                  [dec_layer() for _ in range(cfg.n_layers)],
                  L.norm_init(cfg, d, dev))


def _encode(cfg, params: EncDec, frames):
    """The encoder over ``frames`` (already in the model dtype)."""
    h = frames + params.enc_pos_emb[None, :frames.shape[1]]
    for lp in params.enc_layers:
        y, _ = _attn_full(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1),
                          causal=False, use_rope=False)
        h = h + y
        h = h + L.mlp_apply(cfg, lp.mlp, L.apply_norm(cfg, h, lp.ln2))
    return L.apply_norm(cfg, h, params.enc_ln_f)


def _decode_stack_encdec(cfg, params: EncDec, h, enc_out):
    """Full-sequence decoder pass.  Returns (h, (self_k, self_v, x_k,
    x_v)), each stacked on a leading layer axis."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    B = h.shape[0]
    kvs = []
    for lp in params.layers:
        y, (k, v) = _attn_full(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1),
                               use_rope=False)
        h = h + y
        xk = (enc_out @ lp.xattn["wk"]).reshape(B, -1, KV, hd)
        xv = (enc_out @ lp.xattn["wv"]).reshape(B, -1, KV, hd)
        h = h + _attn_cross(cfg, lp.xattn, L.apply_norm(cfg, h, lp.lnx),
                            xk, xv)
        h = h + L.mlp_apply(cfg, lp.mlp, L.apply_norm(cfg, h, lp.ln2))
        kvs.append((k, v, xk, xv))
    return h, tuple(torch.stack(leaf) for leaf in zip(*kvs))


def _encdec_decode(cfg, params: EncDec, h, cache, pos):
    """One-token decode through the decoder; writes the self-attention
    K/V into the cache in place and reads the cross K/V."""
    for i, lp in enumerate(params.layers):
        y, _, _ = _attn_decode(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1),
                               cache["k"][i], cache["v"][i], pos,
                               use_rope=False)
        h = h + y[:, None, :]
        y, _, _ = _attn_decode(cfg, lp.xattn, L.apply_norm(cfg, h, lp.lnx),
                               cache["xk"][i], cache["xv"][i], pos,
                               use_rope=False, cross=True)
        h = h + y[:, None, :]
        h = h + L.mlp_apply(cfg, lp.mlp, L.apply_norm(cfg, h, lp.ln2))
    return h


def _rows(table, at):
    """``table.index_select(0, at)`` for a plain ``at``; a DTensor table
    (replicated by the rules) is read on each device's own copy."""
    if not isinstance(table, L.DTensor):
        return table.index_select(0, at)
    mesh = table.device_mesh
    whole = [L.Replicate()] * mesh.ndim
    local = table.redistribute(mesh, whole).to_local().index_select(0, at)
    return L.DTensor.from_local(local, mesh, whole, run_check=False)


def _lm_head(cfg, params: LM, h):
    h = L.apply_norm(cfg, h, params.ln_f)
    w = params.tok_emb.T if cfg.tie_embeddings else params.lm_head
    logits = h @ w
    if cfg.vocab_padded != cfg.vocab_size:  # mask the padding entries
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(L.replicated_like(pad, logits), -1e30)
    return logits


def _lse_ll(lf, labels):
    """Each row's log-sum-exp and its label's logit."""
    return (torch.logsumexp(lf, dim=-1),
            torch.gather(lf, -1, labels[..., None].long())[..., 0])


def _xent(logits, labels, mask):
    """CE + z-loss; labels (B, S) int, mask (B, S) float32.  Returns
    (CE + 1e-4 z-loss, CE), each averaged over max(sum(mask), 1).

    DTensor logits are gathered whole on the model axis first (the vocab
    is split there); the log-sum-exp and the label's logit then run on
    each device's own batch rows (``layers.heads_local``), as one
    device's code runs them."""
    lf = logits.float()
    if isinstance(lf, L.DTensor):
        rows = (None, True)
        lse, ll = L.heads_local(_lse_ll, (L.whole_on_model(lf), labels),
                                (rows, rows), (rows, rows))
    else:
        lse, ll = _lse_ll(lf, labels)
    ce = (lse - ll) * mask
    z = torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return ce.sum() / denom + 1e-4 * z.sum() / denom, ce.sum() / denom


# ---------------------------------------------------------------------------
# training stacks: one body per layer, recomputed in backward with remat
# ---------------------------------------------------------------------------

def _run(body, remat: bool, *args):
    if remat:
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return body(*args)


def _stack_train(cfg, params: LM, h, remat: bool):
    """The decoder-only stacks over a full sequence for ``loss``.
    Returns (h, the MoE layers' aux summed, float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in MAMBA:
        def body(h, lp, inv):
            h = h + SSM.ssm_apply(cfg, lp.ssm, L.apply_norm(cfg, h, lp.ln1))
            if inv >= 0:
                sp = params.shared_block
                y, _ = _attn_full(cfg, sp.attn, L.apply_norm(cfg, h, sp.ln1))
                h = h + y
                h = h + L.mlp_apply(cfg, sp.mlp, L.apply_norm(cfg, h, sp.ln2))
            return h

        for lp, inv in zip(params.layers, _inv_idx(cfg)):
            h = _run(body, remat, h, lp, inv)
        return h, aux

    def body(h, lp):
        y, _ = _attn_full(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1))
        h = h + y
        x = L.apply_norm(cfg, h, lp.ln2)
        if cfg.family == "moe":
            y, a = MOE.moe_apply(cfg, lp.moe, x)
            return h + y, a
        return h + L.mlp_apply(cfg, lp.mlp, x), torch.zeros_like(aux)

    for lp in params.layers:
        h, a = _run(body, remat, h, lp)
        aux = aux + a
    return h, aux


def _encdec_train(cfg, params: EncDec, frames, tokens, remat: bool):
    """Whisper's encoder and decoder over full sequences for ``loss``;
    returns the decoder's last hidden states."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim_

    def enc_body(h, lp):
        y, _ = _attn_full(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1),
                          causal=False, use_rope=False)
        h = h + y
        return h + L.mlp_apply(cfg, lp.mlp, L.apply_norm(cfg, h, lp.ln2))

    h = frames + params.enc_pos_emb[None, :frames.shape[1]]
    for lp in params.enc_layers:
        h = _run(enc_body, remat, h, lp)
    enc_out = L.apply_norm(cfg, h, params.enc_ln_f)

    def dec_body(h, enc_out, lp):
        B = h.shape[0]
        y, _ = _attn_full(cfg, lp.attn, L.apply_norm(cfg, h, lp.ln1),
                          use_rope=False)
        h = h + y
        xk = (enc_out @ lp.xattn["wk"]).reshape(B, -1, KV, hd)
        xv = (enc_out @ lp.xattn["wv"]).reshape(B, -1, KV, hd)
        h = h + _attn_cross(cfg, lp.xattn, L.apply_norm(cfg, h, lp.lnx),
                            xk, xv)
        return h + L.mlp_apply(cfg, lp.mlp, L.apply_norm(cfg, h, lp.ln2))

    h = L.embed(params.tok_emb, tokens)
    h = constrain(h + params.dec_pos_emb[None, :h.shape[1]],
                  "batch", None, None)
    for lp in params.layers:
        h = _run(dec_body, remat, h, enc_out, lp)
    return h


# ---------------------------------------------------------------------------
# build_model
# ---------------------------------------------------------------------------

def build_model(cfg: ModelConfig, remat: bool = True) -> Model:
    require_ported(cfg)
    dt = getattr(torch, cfg.dtype)
    mamba = cfg.family in MAMBA

    def init(gen: torch.Generator) -> nn.Module:
        """Random weights drawn from ``gen``, on ``gen``'s device."""
        if cfg.family == "encdec":
            return _encdec_init(cfg, gen)
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

    def embed(params: LM, batch: Batch):
        h = L.embed(params.tok_emb, batch["tokens"])
        if cfg.family == "vlm":
            h = torch.cat([batch["patches"].to(h.dtype), h], dim=1)
        return constrain(h, "batch", None, None)

    def loss(params: nn.Module, batch: Batch):
        """(CE + 1e-4 z-loss + 0.01 aux, metrics) over ``batch``."""
        if cfg.family == "encdec":
            h = _encdec_train(cfg, params, batch["frames"].to(dt),
                              batch["tokens"], remat)
            labels = batch["labels"]
            mask = (labels >= 0).float()
            total, ce = _xent(_lm_head(cfg, params, h),
                              torch.clamp(labels, min=0), mask)
            return total, {"ce": ce}
        h, aux = _stack_train(cfg, params, embed(params, batch), remat)
        labels = batch["labels"]
        if cfg.family == "vlm":   # the patch positions carry no labels
            npat = batch["patches"].shape[1]
            labels = torch.cat([labels.new_full((labels.shape[0], npat), -1),
                                labels], dim=1)
        mask = (labels >= 0).float()
        total, ce = _xent(_lm_head(cfg, params, h),
                          torch.clamp(labels, min=0), mask)
        return total + 0.01 * aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(params: nn.Module, batch: Batch):
        if cfg.family == "encdec":
            enc_out = _encode(cfg, params, batch["frames"].to(dt))
            h = L.embed(params.tok_emb, batch["tokens"])
            h = h + params.dec_pos_emb[None, :h.shape[1]]
            h, (k, v, xk, xv) = _decode_stack_encdec(cfg, params, h, enc_out)
            logits = _lm_head(cfg, params, h[:, -1:, :])[:, 0]
            cache = {"len": torch.tensor(h.shape[1], dtype=torch.int32,
                                         device=h.device),
                     "k": k, "v": v, "xk": xk, "xv": xv}
            return logits, cache
        h = embed(params, batch)
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
    def decode(params: nn.Module, cache: Dict, tokens: torch.Tensor):
        pos = cache["len"]
        h = L.embed(params.tok_emb, tokens)                  # (B, 1, D)
        if cfg.family == "encdec":
            at = torch.clamp(pos, max=MAX_DEC_POS - 1).reshape(1).long()
            h = h + _rows(params.dec_pos_emb, at)[None]
            h = _encdec_decode(cfg, params, h, cache, pos)
        elif mamba:
            h = _ssm_stack_decode(cfg, params, h, cache, pos)
        else:
            for i, lp in enumerate(params.layers):
                h, _, _ = _block_decode(cfg, lp, h, cache["k"][i],
                                        cache["v"][i], pos)
        logits = _lm_head(cfg, params, h[:, -1:, :])[:, 0]
        return logits, dict(cache, len=pos + 1)

    return Model(cfg=cfg, init=init, loss=loss, prefill=prefill,
                 decode=decode)


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
    if cfg.family == "encdec":
        c["xk"] = c["xv"] = ((Ld, batch, cfg.enc_seq, KV, hd), dt)
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
