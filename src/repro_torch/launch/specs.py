"""Abstract input specs and step construction for every (arch x shape)
cell (port of ``repro.launch.specs``).

Nothing here allocates: parameters are drawn under a ``FakeTensorMode``
and handed out as ``meta`` tensors, inputs are :class:`SD` shape structs
(or ``meta`` tensors for a step), so a cell of llama4-scout (~100 B
parameters) costs only its metadata.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.model import Model, build_model, cache_specs
from repro_torch.sharding import rules
from repro_torch.sharding.api import mesh_context
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step, optimizer_view


@dataclasses.dataclass(frozen=True)
class SD:
    """A tensor's shape and dtype (``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def _cache_sd(spec):
    if isinstance(spec[1], torch.dtype):
        return SD(tuple(spec[0]), spec[1])
    return tuple(_cache_sd(s) for s in spec)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Abstract model inputs for one shape cell."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if shape.kind in ("train", "prefill"):
        s_text = S - cfg.n_patches if cfg.family == "vlm" else S
        d: Dict[str, Any] = {"tokens": SD((B, s_text), torch.int32)}
        if shape.kind == "train":
            d["labels"] = SD((B, s_text), torch.int32)
        if cfg.family == "encdec":
            d["frames"] = SD((B, cfg.enc_seq, cfg.d_model), dt)
        if cfg.family == "vlm":
            d["patches"] = SD((B, cfg.n_patches, cfg.d_model), dt)
        return d
    # decode: one new token against a cache of length S
    return {"tokens": SD((B, 1), torch.int32),
            "cache": {k: _cache_sd(v)
                      for k, v in cache_specs(cfg, B, S).items()}}


def abstract_params(model: Model) -> nn.Module:
    """``model.init``'s module with ``meta`` parameters, drawn under a
    ``FakeTensorMode`` (no weight is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        gen = torch.Generator()
        gen.manual_seed(0)
        module = model.init(gen)
    for sub in module.modules():
        for name, p in list(sub._parameters.items()):
            if p is not None:
                sub._parameters[name] = nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="meta"),
                    requires_grad=False)
    return module


def param_count(model: Model) -> Tuple[int, int]:
    """(total params, active params): active discounts unrouted experts."""
    cfg = model.cfg
    total = active = 0

    def visit(name, leaf):
        nonlocal total, active
        n = math.prod(leaf.shape)
        total += n
        if (cfg.n_experts and len(leaf.shape) == 4
                and name in ("wg", "wu", "wd")):
            active += n * cfg.top_k // cfg.n_experts
        else:
            active += n

    rules.map_named(visit, rules.abstract_tree(abstract_params(model)))
    return total, active


def accum_steps_for(cfg: ModelConfig, shape: ShapeSpec, dp: int,
                    budget_bytes: float = 4e9) -> int:
    """Microbatching heuristic (the reference's).

    With remat the per-device live activations are dominated by the
    per-layer residual checkpoints: L * (B/accum) * S * d * 2 / dp.  Pick
    the smallest power-of-two accum that fits them in ``budget_bytes``
    while keeping the microbatch at least one sequence per data-parallel
    group.
    """
    if shape.kind != "train":
        return 1
    B, S = shape.global_batch, shape.seq_len
    ckpt = cfg.n_layers * B * S * cfg.d_model * 2.0 / max(dp, 1)
    # expert-parallel MoE: every extra microbatch repeats the expert-grad
    # sync, so trade activation memory for fewer syncs
    if cfg.n_experts and cfg.n_experts % 16 == 0:
        budget_bytes *= 2
    accum = 1
    while ckpt / accum > budget_bytes and B // (2 * accum) >= dp:
        accum *= 2
    return accum


def model_flops(cfg: ModelConfig, shape: ShapeSpec, total: int,
                active: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active
    params."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


def _meta_tree(tree):
    """Shape structs -> ``meta`` tensors."""
    return rules.map_named(
        lambda _, sd: torch.empty(sd.shape, dtype=sd.dtype, device="meta"),
        tree)


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               accum: int | None = None):
    """(step, abstract arguments, meta) for one dry-run cell: the train
    step, the prefill or the decode, on ``meta`` DTensors laid out on
    ``mesh`` (training in the ZeRO-1 storage layout, serving in
    ``"serve"``); ``step(*args)`` runs it once under the mesh.

    A train step with ``accum`` microbatches is the trained step itself
    (``make_train_step``'s sharded path): its arguments hold one
    microbatch, and ``step(*args, repeat=recorder.repeat)`` counts it
    ``accum`` times, as the reference's accounting multiplies its
    microbatch scan's body by the trip count."""
    model = build_model(cfg, remat=(shape.kind == "train"))
    total, active = param_count(model)
    params = abstract_params(model)
    p_abs = rules.abstract_tree(params)
    sizes = rules.axis_sizes(mesh)
    meta = dict(accum=1, total_params=total, active_params=active)

    def run(fn):
        def step(*args, **kw):
            with mesh_context(mesh):
                return fn(*args, **kw)
        return step

    if shape.kind == "train":
        dp = mesh.size() // sizes.get("model", 1)
        accum = accum or accum_steps_for(cfg, shape, dp)
        meta["accum"] = accum
        storage = rules.named_shardings(
            rules.param_specs(p_abs, mesh, "train"), mesh)
        compute = rules.named_shardings(
            rules.param_specs(p_abs, mesh, "compute"), mesh)
        rules.distribute_module(params, mesh, storage)
        step = make_train_step(model, AdamWConfig(), accum_steps=accum,
                               compute_shardings=compute,
                               storage_shardings=storage, donate=True)
        opt = adamw_init(optimizer_view(params))
        micro = dataclasses.replace(shape,
                                    global_batch=shape.global_batch // accum)
        batch = _lay_out(_meta_tree(input_specs(cfg, micro)), mesh)
        return run(step), (params, opt, batch), meta

    rules.distribute_module(params, mesh, rules.param_specs(
        p_abs, mesh, "serve"))
    specs = input_specs(cfg, shape)
    if shape.kind == "prefill":
        batch = _lay_out(_meta_tree(specs), mesh)
        return run(model.prefill), (params, batch), meta
    cache = _meta_tree(specs["cache"])
    cache_len = cache.pop("len")
    cache = _lay_out(cache, mesh)
    cache["len"] = cache_len
    tokens = _lay_out(_meta_tree({"tokens": specs["tokens"]}), mesh)
    return run(model.decode), (params, cache, tokens["tokens"]), meta


def _lay_out(tree, mesh):
    """``tree``'s ``meta`` tensors as DTensors laid out by
    ``input_specs_sharding``."""
    return rules.distribute_tree(tree, mesh,
                                 rules.input_specs_sharding(tree, mesh))
