"""Mixture-of-Experts layer (port of ``repro.models.moe``): mixtral's
top-2 and llama4-scout's top-1 with a shared expert.

GShard-style capacity-bounded dispatch: the T tokens are split into G
groups of ``g = _group_size(T)``; each expert takes at most ``cap`` tokens
of a group, slot-major (every token's first choice before any second
choice), and tokens over capacity are dropped (their residual passes
through).  ``moe_apply_einsum`` dispatches with one-hot einsums, the form
the reference's serving runs in prefill and decode; ``moe_apply``
scatters and gathers, the form its training runs (``model.loss``), and
autograd differentiates it: the gate values through the sort, the
tokens through the scatter and the gather, the aux loss through the
router's probabilities.

Top-k takes a stable descending sort, so ties go to the lower expert
index, as ``jax.lax.top_k`` orders them.  ``_group_size`` halves from
4096 until it divides T, so an odd T gives one-token groups, ``cap = 2``
and every expert runs for every token of the group, as in the reference.
The reference's sharding annotations (``constrain``) stand at its sites
in ``moe_apply`` (the identity without a mesh); its remat name
(``checkpoint_name``) has no counterpart.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding.api import constrain


def _group_size(n_tokens: int) -> int:
    g = 4096
    while n_tokens % g:
        g //= 2
    return max(g, 1)


def moe_init(cfg, gen: torch.Generator, d: int, d_ff: int):
    """Router (float32), the experts' SwiGLU weights (E, d, d_ff) and
    (E, d_ff, d) in ``cfg.dtype``, drawn one tensor at a time on
    ``gen``'s device; and the shared expert's MLP where configured."""
    dt = getattr(torch, cfg.dtype)
    E = cfg.n_experts
    dev = gen.device

    def normal(shape, scale, dtype):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * scale).to(dtype)

    scale = 1.0 / math.sqrt(d)
    p = {"router": normal((d, E), scale, torch.float32),
         "wg": normal((E, d, d_ff), scale, dt),
         "wu": normal((E, d, d_ff), scale, dt),
         "wd": normal((E, d_ff, d), 1.0 / math.sqrt(d_ff), dt)}
    if cfg.moe_shared_expert:
        p["shared"] = layers.mlp_init(cfg, gen, d, d_ff)
    return p


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(cfg, p, xt):
    """Top-k gates and capacity-bounded expert positions of xt (G, g, D).

    Returns (gate_vals (G,g,k), idx (G,g,k), keep (G,g,k), pos (G,g,k),
    cap, aux).
    """
    G, g, _ = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = xt.float() @ p["router"]                           # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = order.values[..., :k], order.indices[..., :k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)          # renormalize

    cap = int(math.ceil(k * g / E * cfg.capacity_factor))
    cap = min(max(8 * ((cap + 7) // 8), 8), g * k)

    # slot-major cumulative positions: top-1 choices win capacity first
    onehot = _one_hot(idx, E, torch.float32)                    # (G,g,k,E)
    slot_major = onehot.transpose(1, 2).reshape(G, k * g, E)
    pos_e = torch.cumsum(slot_major, dim=1) - 1.0               # (G,k*g,E)
    keep_e = (pos_e < cap) * slot_major
    pos_e = pos_e.reshape(G, k, g, E).transpose(1, 2)           # (G,g,k,E)
    keep_e = keep_e.reshape(G, k, g, E).transpose(1, 2)
    pos = (pos_e * onehot).sum(dim=-1).to(torch.int32)          # (G,g,k)
    keep = keep_e.sum(dim=-1) > 0.5

    frac_tokens = (onehot.sum(dim=2) / k).mean(dim=1)
    frac_probs = probs.mean(dim=1)
    aux = E * (frac_tokens * frac_probs).sum(dim=-1).mean()
    return gate_vals, idx, keep, pos, cap, aux


def _experts(cfg, p, xe):
    """Dense expert FFN over dispatched activations xe (G, E, C, D)."""
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["wg"])) \
        * torch.einsum("gecd,edf->gecf", xe, p["wu"])
    return torch.einsum("gecf,efd->gecd", h, p["wd"])


def _shared(cfg, p, x, out):
    if cfg.moe_shared_expert:
        out = out + layers.mlp_apply(cfg, p["shared"], x)
    return out


def moe_apply_einsum(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-hot einsum dispatch (the serving form).  Returns (out, aux)."""
    B, S, D = x.shape
    E = cfg.n_experts
    T = B * S
    g = _group_size(T)
    xt = x.reshape(T // g, g, D)
    gate_vals, idx, keep, pos, cap, aux = _route(cfg, p, xt)

    e_oh = _one_hot(idx, E, x.dtype)                            # (G,g,k,E)
    pos_oh = _one_hot(pos, cap, x.dtype)                        # (G,g,k,C)
    keep_f = keep.to(x.dtype)
    dispatch = torch.einsum("gtk,gtke,gtkc->gtec", keep_f, e_oh, pos_oh)
    combine = torch.einsum("gtk,gtk,gtke,gtkc->gtec",
                           gate_vals.to(x.dtype), keep_f, e_oh, pos_oh)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xt)           # (G,E,C,D)
    ye = _experts(cfg, p, xe)
    y = torch.einsum("gtec,gecd->gtd", combine, ye)
    return _shared(cfg, p, x, y.reshape(B, S, D)), aux


def moe_apply(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter/gather dispatch (the training form): each
    kept (token, choice) lands in slot ``expert * cap + pos``, dropped
    ones in one spare slot.  Returns (out, aux)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    g = _group_size(T)
    G = T // g
    xt = constrain(x.reshape(G, g, D), "batch", None, None)
    gate_vals, idx, keep, pos, cap, aux = _route(cfg, p, xt)

    flat = torch.where(keep, idx * cap + pos,
                       torch.full_like(idx, E * cap))           # (G, g, k)
    flat = constrain(flat, "batch", None, None)
    rows = torch.arange(G, device=x.device)[:, None, None].expand_as(flat)
    xe_flat = constrain(torch.zeros((G, E * cap + 1, D), dtype=x.dtype,
                                    device=x.device), "batch", None, None)
    xe_flat.index_put_((rows, flat), xt[:, :, None, :].expand(G, g, k, D),
                       accumulate=True)
    xe_flat = constrain(xe_flat, "batch", None, None)
    xe = xe_flat[:, :E * cap].reshape(G, E, cap, D)
    # experts shard on the model axis where E divides it
    xe = constrain(xe, None, "expert", None, None)
    ye = _experts(cfg, p, xe)
    ye = constrain(ye, None, "expert", None, None).reshape(G, E * cap, D)
    ye = torch.cat([ye, ye.new_zeros((G, 1, D))], dim=1)
    ye = constrain(ye, "batch", None, None)
    gathered = ye[rows, flat]                                   # (G,g,k,D)
    gathered = constrain(gathered, "batch", None, None, None)
    y = (gathered * gate_vals[..., None].to(x.dtype)).sum(dim=2)
    return _shared(cfg, p, x, y.reshape(B, S, D)), aux
