"""AdamW with global-norm clipping and a cosine schedule.

Port of ``repro.train.optimizer`` over dicts of tensors (name -> tensor):
leaves are taken in sorted-key order, the order in which JAX flattens a
dict.  Moments are float32.  Decoupled weight decay applies to matrices
only (leaves of two or more dimensions), as in the reference.

Leaves may be DTensors (a mesh run: parameters, gradients and moments in
one storage layout).  The gradient norm is then a DTensor reduction
over every shard, and the element-wise update runs on each device's own
shards.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.numerics import fma

Params = Dict[str, torch.Tensor]

# Elements of one piece of a leaf's element-wise update.  ``fma`` works in
# float64, so a whole leaf at once (stablelm-3b's stacked MLP weights are
# 566 M elements, 4.2 GiB a float64 temporary) would take tens of GiB;
# a piece of 2^26 takes ~3.  Pieces give the same bits: every operation is
# element-wise.
PIECE = 1 << 26


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class AdamWState(NamedTuple):
    step: torch.Tensor   # () i32
    mu: Params
    nu: Params


def _zeros32(p):
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Params) -> AdamWState:
    dev = next(iter(params.values())).device
    zeros = {k: _zeros32(p) for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu={k: z.clone() for k, z in zeros.items()})


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step``: linear warmup, then cosine decay to a
    tenth of ``cfg.lr``.

    Written in the form XLA compiles the reference to, with the config's
    constants folded: each division by a constant is a product with its
    float32 reciprocal, ``0.5 * (1 + cos) * 0.9 + 0.1`` is
    ``fma(cos + 1, 0.45, 0.1)``, and ``lr`` multiplies the warmup first.
    The cosine is correctly rounded (XLA's is within one ulp of it).
    """
    step = step.to(torch.float32)
    inv_warm = np.float32(1) / np.float32(max(cfg.warmup_steps, 1))
    inv_decay = np.float32(1) / np.float32(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    warm = torch.clamp(step * float(inv_warm), max=1.0)
    prog = torch.clamp((step - float(cfg.warmup_steps)) * float(inv_decay),
                       0.0, 1.0)
    cos = torch.cos((prog * float(np.float32(math.pi))).double()).float()
    return (warm * cfg.lr) * fma(cos + 1.0, float(np.float32(0.45)), 0.1)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def adamw_update(cfg: AdamWConfig, grads: Params, state: AdamWState,
                 params: Params, *, donate: bool = False
                 ) -> Tuple[Params, AdamWState, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm).

    With ``donate`` the new moments are written into ``state``'s own
    tensors, leaf by leaf, which the new state then holds: the old state
    is used up, as the reference's jitted step donates it
    (``donate_argnums``), and the moments are not held twice at the
    step's end.
    """
    gnorm = global_norm(grads)
    if isinstance(gnorm, DTensor):   # a 0-d reduction: replicated
        gnorm = gnorm.full_tensor()
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))
    new_p, new_m, new_v = {}, {}, {}
    for k in sorted(params):
        p, g, mu, nu = params[k], grads[k], state.mu[k], state.nu[k]
        decay = p.dim() >= 2   # decoupled weight decay on matrices only
        leaf = _update_shards if isinstance(p, DTensor) else _update_leaf
        new_p[k], new_m[k], new_v[k] = leaf(cfg, p, g, mu, nu, decay, scale,
                                            lr, b1c, b2c, donate)
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), gnorm


def _update_leaf(cfg, p, g, mu, nu, decay, scale, lr, b1c, b2c, donate):
    """(new p, new mu, new nu) of one leaf, a piece at a time."""
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in ((p,) if donate else (p, mu, nu))]
    out += [mu, nu] if donate else []
    flat = [t.reshape(-1) for t in (p, g, mu, nu)]
    outs = [t.view(-1) for t in out]   # a donated moment is contiguous
    for i in range(0, p.numel(), PIECE):   # a small leaf: one piece
        piece = _update(cfg, *(t[i:i + PIECE] for t in flat), decay,
                        scale, lr, b1c, b2c)
        for dst, src in zip(outs, piece):
            dst[i:i + PIECE].copy_(src)
    return tuple(out)


def _update_shards(cfg, p, g, mu, nu, decay, scale, lr, b1c, b2c,
                   donate):
    """One DTensor leaf: :func:`_update_leaf` on each device's own shards
    (the four leaves in one layout), wrapped back as DTensors."""
    if any(list(t.placements) != list(p.placements) for t in (g, mu, nu)):
        raise ValueError("adamw_update: a leaf's parameter, gradient and "
                         "moments must share one layout")
    out = _update_leaf(cfg, *(t.to_local() for t in (p, g, mu, nu)), decay,
                       scale, lr, b1c, b2c, donate)
    return tuple(DTensor.from_local(t, p.device_mesh, p.placements,
                                    run_check=False, shape=p.shape,
                                    stride=p.stride()) for t in out)


def _update(cfg: AdamWConfig, p, g, mu, nu, decay: bool, scale, lr, b1c,
            b2c):
    """(new p, new mu, new nu) of one leaf, or one piece of one."""
    g = g.float() * scale
    m = fma(cfg.b1, mu, (1.0 - cfg.b1) * g)
    v = fma(cfg.b2, nu, (1.0 - cfg.b2) * torch.square(g))
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if decay:
        delta = fma(cfg.weight_decay, p.float(), delta)
    return (p.float() - lr * delta).to(p.dtype), m, v
