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

Under a mesh (DTensor activations and weights) both forms run the
routing, the scatter or one-hot dispatch, and the gather or combine on
each device's own groups (``layers.heads_local``, ``local_map``): the
groups are split on the batch axes where ``constrain`` splits them and
whole elsewhere, the router is replicated and its gradient summed over
the axes that split the groups, and ``aux`` is the experts' count times
the mean of every group's term.  The experts' three products run as
DTensor ops in the weights' layout (``sharding.rules``: the experts on
the model axis where E divides it, else their FFN dim).  Without a mesh
the same functions run on plain tensors, so a 1x1 mesh is bit-equal.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding.api import constrain, logical_spec
from repro_torch.sharding.rules import placements


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


def _route(cfg, p, xt, *, terms: bool = False):
    """Top-k gates and capacity-bounded expert positions of xt (G, g, D).

    Returns (gate_vals (G,g,k), idx (G,g,k), keep (G,g,k), pos (G,g,k),
    cap, aux), or with ``terms`` each group's aux term (G,) in place of
    aux (aux is ``n_experts`` times their mean).
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
    per_group = (frac_tokens * frac_probs).sum(dim=-1)          # (G,)
    if terms:
        return gate_vals, idx, keep, pos, cap, per_group
    return gate_vals, idx, keep, pos, cap, E * per_group.mean()


def _experts(cfg, p, xe):
    """Dense expert FFN over dispatched activations xe (G, E, C, D).
    DTensor weights are first gathered on the axes that split the groups
    (their serving layout spreads the FFN dim over ``data`` too, where
    prefill splits the groups): the products then split the groups on
    the batch axes and the experts or the FFN dim on the others."""
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    if isinstance(xe, layers.DTensor):
        wg, wu, wd = (_whole_where_groups_split(w, xe)
                      for w in (wg, wu, wd))
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, wg)) \
        * torch.einsum("gecd,edf->gecf", xe, wu)
    return torch.einsum("gecf,efd->gecd", h, wd)


def _whole_where_groups_split(w, xe):
    """DTensor ``w`` replicated on the mesh axes where ``xe`` splits its
    groups (dim 0), its other placements kept."""
    mesh = w.device_mesh
    want = [layers.Replicate() if g == layers.Shard(0) else pl
            for pl, g in zip(w.placements, xe.placements)]
    return w if list(w.placements) == want else w.redistribute(mesh, want)


def _shared(cfg, p, x, out):
    if cfg.moe_shared_expert:
        out = out + layers.mlp_apply(cfg, p["shared"], x)
    return out


def _groups(x):
    """x (B, S, D) as (G, g, D) groups of ``_group_size(B * S)``.  A
    DTensor is first laid out with its tokens split on the batch axes
    only (``constrain``'s ``"batch"``) and whole on the others: DTensor
    cannot regroup tokens split on two axes, or unevenly, in place."""
    B, S, D = x.shape
    g = _group_size(B * S)
    if isinstance(x, layers.DTensor):
        mesh = x.device_mesh
        spec = logical_spec(mesh, x.shape, "batch", None, None)
        want = (placements(spec, mesh) if spec is not None
                else [layers.Replicate()] * mesh.ndim)
        if list(x.placements) != want:
            x = x.redistribute(mesh, want)
    return x.reshape(B * S // g, g, D)


def _ungroup(y, shape):
    """``y.reshape(shape)``; a DTensor's gradient is laid out as ``y``'s
    forward layout before it is regrouped (the gradient arriving from the
    residual stream may split the tokens on two axes)."""
    out = y.reshape(shape)
    if isinstance(out, layers.DTensor):
        out = out.redistribute(out.device_mesh, out.placements)
    return out


def _on_own_groups(fn, groups, n_out: int, router=None):
    """``fn(*groups[, router])`` on each device's own groups
    (``layers.heads_local``): every tensor of ``groups`` is (G, ...) and
    the first sets the layout; ``router`` is replicated.  The groups stay
    split on the batch axes where ``constrain`` split them; elsewhere they
    run whole on every device (once, not once a device and summed).  The
    router's gradient comes back as each device's share (``Partial``) on
    the axes that split the groups."""
    args, dims = tuple(groups), ((None, True),) * len(groups)
    if router is not None:
        args, dims = args + (router,), dims + ((None, False),)
    return layers.heads_local(fn, args, dims, ((None, True),) * n_out)


def _einsum_dispatch(cfg, xt, route):
    """The one-hot dispatch of xt (G, g, D) by ``route``: (xe (G, E, C,
    D), combine (G, g, E, C))."""
    gate_vals, idx, keep, pos, cap = route
    e_oh = _one_hot(idx, cfg.n_experts, xt.dtype)               # (G,g,k,E)
    pos_oh = _one_hot(pos, cap, xt.dtype)                       # (G,g,k,C)
    keep_f = keep.to(xt.dtype)
    dispatch = torch.einsum("gtk,gtke,gtkc->gtec", keep_f, e_oh, pos_oh)
    combine = torch.einsum("gtk,gtk,gtke,gtkc->gtec",
                           gate_vals.to(xt.dtype), keep_f, e_oh, pos_oh)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xt)           # (G,E,C,D)
    return xe, combine


def _einsum_combine(combine, ye):
    return torch.einsum("gtec,gecd->gtd", combine, ye)


def moe_apply_einsum(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-hot einsum dispatch (the serving form).  Returns (out, aux).

    On DTensors the routing and the dispatch, then the combine, run on
    each device's own groups (:func:`_on_own_groups`); the experts'
    products are DTensor ops in the weights' layout."""
    B, S, D = x.shape
    xt = _groups(x)
    if isinstance(xt, layers.DTensor):
        def dispatch(xt, router):
            *route, terms = _route(cfg, {"router": router}, xt, terms=True)
            return (*_einsum_dispatch(cfg, xt, route), terms)

        xe, combine, terms = _on_own_groups(dispatch, (xt,), 3,
                                            p["router"])
        aux = cfg.n_experts * terms.mean()
        ye = _experts(cfg, p, xe)
        y = _on_own_groups(lambda c, ye: (_einsum_combine(c, ye),),
                           (combine, ye), 1)[0]
    else:
        *route, aux = _route(cfg, p, xt)
        xe, combine = _einsum_dispatch(cfg, xt, route)
        y = _einsum_combine(combine, _experts(cfg, p, xe))
    return _shared(cfg, p, x, _ungroup(y, (B, S, D))), aux


def _scatter(cfg, xt, route):
    """Each kept (token, choice) of xt (G, g, D) into slot ``expert * cap
    + pos`` of its group, dropped ones into one spare slot: (xe (G, E,
    cap, D), the slots (G, g, k))."""
    gate_vals, idx, keep, pos, cap = route
    G, g, D = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    flat = torch.where(keep, idx * cap + pos,
                       torch.full_like(idx, E * cap))           # (G, g, k)
    flat = constrain(flat, "batch", None, None)
    rows = torch.arange(G, device=xt.device)[:, None, None].expand_as(flat)
    xe_flat = constrain(torch.zeros((G, E * cap + 1, D), dtype=xt.dtype,
                                    device=xt.device), "batch", None, None)
    xe_flat.index_put_((rows, flat), xt[:, :, None, :].expand(G, g, k, D),
                       accumulate=True)
    xe_flat = constrain(xe_flat, "batch", None, None)
    return xe_flat[:, :E * cap].reshape(G, E, cap, D), flat


def _gather(flat, gate_vals, ye):
    """Each (token, choice)'s expert output from ye (G, E, cap, D) (the
    spare slot reads zeros), weighted by its gate and summed over the
    choices: (G, g, D)."""
    G, _, _, D = ye.shape
    ye = torch.cat([ye.reshape(G, -1, D), ye.new_zeros((G, 1, D))], dim=1)
    ye = constrain(ye, "batch", None, None)
    rows = torch.arange(G, device=ye.device)[:, None, None].expand_as(flat)
    gathered = ye[rows, flat]                                   # (G,g,k,D)
    gathered = constrain(gathered, "batch", None, None, None)
    return (gathered * gate_vals[..., None].to(ye.dtype)).sum(dim=2)


def moe_apply(cfg, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter/gather dispatch (the training form): each
    kept (token, choice) lands in slot ``expert * cap + pos``, dropped
    ones in one spare slot.  Returns (out, aux).

    On DTensors the routing and the scatter, then the gather, run on each
    device's own groups (:func:`_on_own_groups`); between them the
    experts' products are DTensor ops, with the dispatched activations on
    the expert axis where E divides it."""
    B, S, D = x.shape
    E = cfg.n_experts
    xt = constrain(_groups(x), "batch", None, None)
    if isinstance(xt, layers.DTensor):
        def dispatch(xt, router):
            *route, terms = _route(cfg, {"router": router}, xt, terms=True)
            xe, flat = _scatter(cfg, xt, route)
            return xe, flat, route[0], terms

        xe, flat, gate_vals, terms = _on_own_groups(dispatch, (xt,), 4,
                                                    p["router"])
        aux = E * terms.mean()
    else:
        *route, aux = _route(cfg, p, xt)
        xe, flat = _scatter(cfg, xt, route)
        gate_vals = route[0]
    # experts shard on the model axis where E divides it
    xe = constrain(xe, None, "expert", None, None)
    ye = _experts(cfg, p, xe)
    ye = constrain(ye, None, "expert", None, None)
    if isinstance(ye, layers.DTensor):
        y = _on_own_groups(lambda *a: (_gather(*a),),
                           (flat, gate_vals, ye), 1)[0]
    else:
        y = _gather(flat, gate_vals, ye)
    return _shared(cfg, p, x, _ungroup(y, (B, S, D))), aux
