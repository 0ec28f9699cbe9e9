"""Train step factory: loss -> gradients -> AdamW, with microbatched
gradient accumulation.

Port of ``repro.train.train_step``.  A
model is any object with ``loss(params, batch) -> (loss, metrics)``.
Gradients come from ``torch.autograd.grad`` over the parameters, so a
loss may run ``torch.autograd.Function``s with kernels for backward and
``torch.utils.checkpoint`` recomputation.  ``params`` is either

  * a dict of tensors (the usage predictor): the optimizer sees it as it
    is and the step returns a new dict; or
  * a model's ``nn.Module`` (``models.model.LM`` or ``EncDec``): the
    optimizer sees the reference's tree layout (``optimizer_view``:
    ``layers`` stacked on a leading L axis, keys joined with ``/``, in
    the order JAX flattens the tree), so weight decay applies to the
    leaves the reference decays (a stacked per-layer vector is a matrix
    there) and ``opt_state`` checkpoints in the reference's layout; the
    step writes the new values into the module's parameters in place and
    returns the module.  The stacking costs a copy of the weights and of
    the gradients a step, but AdamW's element-wise chain then runs once
    per stacked leaf instead of once per layer's tensor: a full-width
    mamba2-370m step (B 8 x S 2048, H100) takes 13,878 kernels and
    1.66 s this way, 54,979 and 2.03 s over the module's own parameters.

With ``compute_shardings`` and ``storage_shardings`` (trees of
``sharding.rules.NamedSharding`` in the reference's layout; the module's
parameters are DTensors in the storage layout) the step runs the
reference's ZeRO-1 dataflow on DTensors: the parameters are
redistributed once a step to the compute layout, each microbatch's
gradients go back to the storage layout (from ``Partial`` on the data
axes: a reduce-scatter), and AdamW updates the storage shards.  Where
the two layouts agree (a 1x1 mesh) the redistribution returns the same
local tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import contextlib

import torch
from torch import nn

from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_init, adamw_update)

SEP = "/"   # sorts below every character of a key, as JAX's key order


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        key = prefix + k
        if isinstance(v, dict):
            out.update(flatten(v, key + SEP))
        else:
            out[key] = v
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`flatten`."""
    tree: dict = {}
    for key, v in flat.items():
        *path, last = key.split(SEP)
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _is_model(params) -> bool:
    return isinstance(params, nn.Module)


def optimizer_view(params) -> Dict[str, torch.Tensor]:
    """The flat dict of tensors AdamW updates: the dict itself, or a
    model module's reference-layout tree, flattened."""
    if _is_model(params):
        from repro_torch.convert import model_tree
        return flatten(model_tree(params))
    return params


def value_and_grad(model, params, batch):
    """(loss, metrics, grads): the loss and its metrics detached, and the
    gradients in the optimizer's layout (``optimizer_view``), each in its
    parameter's dtype; a parameter the loss does not reach gets zeros."""
    if _is_model(params):
        named = dict(params.named_parameters())
        arg = params
        for p in named.values():
            p.requires_grad_(True)
    else:
        named = {k: v.detach().requires_grad_(True)
                 for k, v in params.items()}
        arg = named
    try:
        with torch.enable_grad():
            loss, metrics = model.loss(arg, batch)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
    finally:
        if _is_model(params):
            for p in named.values():
                p.requires_grad_(False)
    grads = dict(zip(named, grads))
    if _is_model(params):
        from repro_torch.convert import model_tree
        grads = flatten(model_tree(grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _apply(params, new: Dict[str, torch.Tensor]):
    """The step's new parameters: the dict, or written into the module."""
    if _is_model(params):
        from repro_torch.convert import load_model_tree
        load_model_tree(params, nest(new))
        return params
    return new


def make_train_step(model, opt_cfg: AdamWConfig, accum_steps: int = 1,
                    compute_shardings=None, storage_shardings=None, *,
                    donate: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``metrics`` holds ``loss`` and ``grad_norm``
    (and the loss's own metrics without accumulation) as 0-d tensors
    (nothing waits for the device).

    With ``accum_steps`` > 1 the batch's leading axis is split into that
    many microbatches, whose gradients are averaged in float32.  With
    ``donate`` the step uses up ``opt_state`` (``adamw_update``'s
    ``donate``), as the reference's trainer donates it to its jitted step.
    The sharding trees (both or neither) take the ZeRO-1 path of the
    module docstring; the loss and gradient norm then come back as local
    0-d tensors.
    """
    if compute_shardings is not None or storage_shardings is not None:
        return _sharded_train_step(model, opt_cfg, accum_steps,
                                   compute_shardings, storage_shardings,
                                   donate)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(model, params, batch)
        else:
            micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads, losses = None, []
            for i in range(accum_steps):
                loss_i, _, g = value_and_grad(
                    model, params, {k: v[i] for k, v in micro.items()})
                if grads is None:
                    grads = {k: torch.zeros(t.shape, dtype=torch.float32,
                                            device=t.device)
                             for k, t in g.items()}
                grads = {k: grads[k] + g[k].float() / accum_steps
                         for k in grads}
                losses.append(loss_i)
            loss, metrics = torch.stack(losses).mean(), {}
        new, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state,
                                             optimizer_view(params),
                                             donate=donate)
        return _apply(params, new), opt_state, {"loss": loss,
                                                "grad_norm": gnorm,
                                                **metrics}

    return train_step


@contextlib.contextmanager
def _swapped(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """``module`` with its parameters ``tensors`` (by name) in place of
    its own for the block."""
    saved = []
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        saved.append((sub, leaf, sub._parameters[leaf]))
        sub._parameters[leaf] = t
    try:
        yield module
    finally:
        for sub, leaf, p in saved:
            sub._parameters[leaf] = p


def _redistribute(t, placements):
    return t if list(t.placements) == list(placements) \
        else t.redistribute(t.device_mesh, placements)


def to_compute(params, compute_shardings) -> Dict[str, torch.Tensor]:
    """The module's parameters in the compute layout, by name (a step's
    one all-gather), as leaves that record gradients."""
    from repro_torch.sharding.rules import module_shardings

    compute = module_shardings(params, compute_shardings)
    return {n: _redistribute(p, compute[n]).detach().requires_grad_(True)
            for n, p in params.named_parameters()}


def sharded_grads(model, params, comp, batch, storage_shardings):
    """(loss, metrics, gradients) of one (micro)batch over the
    compute-layout parameters ``comp`` (:func:`to_compute`): the
    gradients in the storage layout (from ``Partial`` on the data axes: a
    reduce-scatter), in the optimizer's view (``optimizer_view``)."""
    from repro_torch.convert import model_tree
    from repro_torch.sharding.rules import module_shardings

    storage = module_shardings(params, storage_shardings)
    with torch.enable_grad(), _swapped(params, comp):
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(comp.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    grads = {n: _redistribute(g, storage[n]) for n, g in zip(comp, grads)}
    # stacked here, as ``value_and_grad`` stacks them, so the per-layer
    # gradients are freed before AdamW runs
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        flatten(model_tree(grads))


def _sharded_train_step(model, opt_cfg, accum_steps, compute_shardings,
                        storage_shardings, donate):
    from torch.distributed.tensor import DTensor

    def local(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any],
                   repeat=None):
        """The step.  With ``repeat`` (a dry run's ``OpRecorder.repeat``)
        ``batch`` holds one microbatch, run once inside
        ``repeat(accum_steps)`` so that it counts ``accum_steps`` times,
        as the reference's accounting multiplies its microbatch scan's
        body by the trip count."""
        comp = to_compute(params, compute_shardings)
        if repeat is not None:
            micro, block = [batch], repeat(accum_steps)
        elif accum_steps == 1:
            micro, block = [batch], contextlib.nullcontext()
        else:
            split = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            micro = [{k: v[i] for k, v in split.items()}
                     for i in range(accum_steps)]
            block = contextlib.nullcontext()
        grads, losses = None, []
        with block:
            for mb in micro:
                loss, metrics, g = sharded_grads(model, params, comp, mb,
                                                 storage_shardings)
                if accum_steps == 1:
                    grads = g
                else:
                    if grads is None:
                        grads = {k: torch.zeros_like(t, dtype=torch.float32)
                                 for k, t in g.items()}
                    grads = {k: grads[k] + g[k].float() / accum_steps
                             for k in grads}
                losses.append(local(loss))
        if accum_steps == 1:
            loss = losses[0]
        else:
            loss, metrics = torch.stack(losses).mean(), {}
        # AdamW on the storage shards
        new, opt_state, gnorm = adamw_update(
            opt_cfg, grads, opt_state, optimizer_view(params),
            donate=donate)
        return _apply(params, new), opt_state, {
            "loss": loss, "grad_norm": local(gnorm),
            **{k: local(v) for k, v in metrics.items()}}

    return train_step


def init_train_state(model, generator: torch.Generator, *,
                     device="cuda") -> Tuple[Any, AdamWState]:
    params = model.init(generator, device=device)
    return params, adamw_init(optimizer_view(params))
