"""Name-based parameter and input sharding rules (port of
``repro.sharding.rules``).

A spec is the reference's ``PartitionSpec`` as a tuple (a :class:`Spec`)
with one entry per tensor dim: ``None`` (replicated), an axis name, or a
tuple of names (a one-name tuple is written as the name, as
``PartitionSpec`` writes it).
The rules read a leaf's name (its nearest dict key) and shape, and a
mesh's axis names and sizes: a ``DeviceMesh`` or any object with
``axis_names`` and a ``shape`` mapping, as the reference's tests mock one.

Three modes, as in the reference:

  * ``train``: the storage layout (ZeRO-1): parameters, AdamW moments and
    the gradient accumulator 2-D sharded (data x model);
  * ``compute``: what the forward and backward run with, model-parallel
    only; the train step redistributes storage to compute once a step
    and the gradients back to storage (a reduce-scatter) per microbatch;
  * ``serve``: the same as compute.

MoE experts also spread their FFN dim over ``data`` (in compute only when
the experts cannot ride the model axis).  Every rule is guarded: a dim
that does not divide its axes stays replicated.

The rules apply to the reference-layout tree (``convert.model_tree``:
``layers`` stacked on a leading L, the reference's leaf names).
:func:`placements` turns a spec into DTensor placements, and
:func:`module_specs` gives a module's own per-layer parameters their spec
(the stacked spec without its leading L).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

# leaf names whose OUTPUT dim is model-parallel
_OUT_MODEL = {"wq", "wk", "wv", "wg", "wu", "w1", "wz", "wxbc", "wdt"}
# leaf names whose INPUT dim is model-parallel
_IN_MODEL = {"wo", "wd", "w2", "out_proj"}
_EMBED = {"tok_emb"}
_REPLICATED = {"router", "dec_pos_emb", "enc_pos_emb", "conv_b", "A_log",
               "D", "dt_bias", "norm_w", "w", "b"}
_UNSTACKED = ("tok_emb", "lm_head", "dec_pos_emb", "enc_pos_emb")
STACKED = ("layers", "enc_layers")


class Spec(tuple):
    """A spec: a tuple that tree maps take as one leaf."""


class NamedSharding:
    """A spec on a ``DeviceMesh`` (the reference's ``NamedSharding``)."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, Spec(spec)

    @property
    def placements(self):
        return placements(self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({self.spec})"


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or a mocked mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: mesh.shape[n] for n in mesh.axis_names}


def _entry(axes):
    """A spec entry as ``PartitionSpec`` normalizes it."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _div(dim: int, sizes, axis: Optional[str]) -> Optional[str]:
    if axis is None or axis not in sizes:
        return None
    return axis if dim % sizes[axis] == 0 else None


def _div2(dim: int, sizes, axes: tuple):
    size = 1
    for a in axes:
        if a not in sizes:
            return None
        size *= sizes[a]
    return _entry(axes) if dim % size == 0 else None


def map_named(fn, tree, name=None):
    """``tree`` (nested dicts, lists, tuples and NamedTuples) with each
    leaf ``x`` replaced by ``fn(name, x)``; ``name`` is the nearest dict
    key above the leaf."""
    if tree is None:
        return None
    if isinstance(tree, (Spec, NamedSharding)):
        return fn(name, tree)
    if isinstance(tree, dict):
        return {k: map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [map_named(fn, v, name) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(name, tree)


def _param_rule(name, shape, sizes, mode):
    fsdp = "data" if mode == "train" else None
    nd = len(shape)
    core = shape[1:] if nd >= 3 and name not in _UNSTACKED else shape
    lead = (None,) * (nd - len(core))
    if name in _REPLICATED or len(core) <= 1:
        return (None,) * nd
    if name in _EMBED:
        return (_div(shape[0], sizes, "model"), None)
    if name == "lm_head":
        return (None, _div(shape[1], sizes, "model"))
    if name == "conv_w":  # (L, W, conv_dim)
        return (*lead, None, _div(core[1], sizes, "model"))
    if len(core) == 3:  # MoE experts (E, d_in, d_out)
        E, di, do = core
        ep = _div(E, sizes, "model")
        if mode == "compute":
            ffn_axes = () if ep else ("model",)
        else:
            ffn_axes = ("data",) if ep else ("model", "data")
        ffn = _div2(do if name in ("wg", "wu") else di, sizes,
                    ffn_axes) if ffn_axes else None
        if name in ("wg", "wu"):
            return (*lead, ep, None, ffn)
        return (*lead, ep, ffn, None)
    if len(core) == 2:
        if name in _IN_MODEL:
            return (*lead, _div(core[0], sizes, "model"),
                    _div(core[1], sizes, fsdp))
        return (*lead, _div(core[0], sizes, fsdp),
                _div(core[1], sizes, "model"))
    return (None,) * nd


def param_specs(params_tree: Any, mesh, mode: str = "train"):
    """A spec for every leaf of ``params_tree`` (tensors or anything with
    a ``shape``), in the tree's structure."""
    sizes = axis_sizes(mesh)
    return map_named(
        lambda name, leaf: Spec(_param_rule(name, tuple(leaf.shape), sizes,
                                            mode)),
        params_tree)


def input_specs_sharding(inputs_tree: Any, mesh):
    """Specs for a step's inputs: tokens, labels, frames, patches and the
    decode caches."""
    sizes = axis_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    batch_size = 1
    for a in batch_axes:
        batch_size *= sizes[a]

    def bdiv(dim):
        return _entry(batch_axes) if dim % batch_size == 0 else None

    def rule(name, leaf):
        shape = tuple(leaf.shape)
        if name in ("tokens", "labels"):
            return (bdiv(shape[0]), None)
        if name in ("frames", "patches"):
            return (bdiv(shape[0]), None, None)
        if name in ("k", "v", "xk", "xv", "shared"):  # (L|n_inv, B, S, KV, hd)
            b = bdiv(shape[1])
            kv = _div(shape[3], sizes, "model")
            # KV heads that cannot shard on the model axis shard the
            # sequence there instead; a batch that cannot shard on data
            # spreads the sequence over data
            seq = None
            if kv is None:
                seq = _div(shape[2], sizes, "model")
            elif b is None:
                seq = _div(shape[2], sizes, "data")
            return (None, b, seq, kv, None)
        if name == "conv":  # (L, B, W-1, conv_dim)
            return (None, bdiv(shape[1]), None,
                    _div(shape[3], sizes, "model"))
        if name == "state":  # (L, B, H, P, N)
            return (None, bdiv(shape[1]), _div(shape[2], sizes, "model"),
                    None, None)
        return (None,) * len(shape)

    return map_named(lambda name, leaf: Spec(rule(name, leaf)), inputs_tree)


def named_shardings(specs_tree, mesh):
    """A tree of specs -> the same tree of :class:`NamedSharding`."""
    return map_named(lambda _, spec: NamedSharding(mesh, spec), specs_tree)


def placements(spec, mesh):
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: one
    per mesh dim, ``Shard(d)`` where tensor dim d names that axis.

    An axis of size 1 holds the whole dim, so it is ``Replicate``: on a
    1x1 mesh every layout is the same and redistributing between them
    moves nothing.  Where a dim spans two axes against the mesh's order
    (mixtral's expert FFN dim on ``("model", "data")``, rules.py's MoE
    rule, on a ``(data, model)`` mesh), each device holds a block of the
    same size as the reference's, but in data-major order: device (d, m)
    holds block d * M + m where ``PartitionSpec`` puts block m * D + d.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            i = names.index(axis)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


class _Abstract:
    """A leaf's shape, standing in for a tensor."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def abstract_tree(module) -> dict:
    """The reference-layout tree of ``module``'s parameters as shapes:
    ``convert.model_tree``'s structure without its stacked copies."""
    tree: dict = {}
    counts: dict = {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        if parts[0] in STACKED:
            counts[parts[0]] = max(counts.get(parts[0], 0), int(parts[1]) + 1)
    for name, p in module.named_parameters():
        parts = name.split(".")
        shape = tuple(p.shape)
        if parts[0] in STACKED:
            if parts[1] != "0":
                continue
            parts = [parts[0]] + parts[2:]
            shape = (counts[parts[0]],) + shape
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = _Abstract(shape)
    return tree


def module_specs(module, specs_tree) -> Dict[str, Spec]:
    """Parameter name (``named_parameters``) -> spec of ``module``'s own
    tensor: a per-layer parameter takes its stacked leaf's spec without
    the leading L.  ``specs_tree`` may hold :class:`NamedSharding`s."""
    out = {}
    for name, _ in module.named_parameters():
        parts = name.split(".")
        stacked = parts[0] in STACKED
        node = specs_tree
        for key in ([parts[0]] + parts[2:] if stacked else parts):
            node = node[key]
        spec = node.spec if isinstance(node, NamedSharding) else node
        out[name] = Spec(spec[1:] if stacked else spec)
    return out


def module_shardings(module, shardings_tree) -> Dict[str, list]:
    """Parameter name -> DTensor placements of ``module``'s own tensor,
    from a tree of :class:`NamedSharding` in the reference's layout."""
    mesh = next(iter(_leaves(shardings_tree))).mesh
    return {name: placements(spec, mesh)
            for name, spec in module_specs(module, shardings_tree).items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def distribute_module(module, mesh, specs_tree) -> None:
    """Make each of ``module``'s parameters a DTensor laid out by its
    spec, in place.  Every rank holds the same full tensor and keeps its
    own shard (no data moves)."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    for name, spec in module_specs(module, specs_tree).items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        p = sub._parameters[leaf]
        sub._parameters[leaf] = nn.Parameter(
            distribute_tensor(p.data, mesh, placements(spec, mesh),
                              src_data_rank=None), requires_grad=False)


def distribute_tree(tree, mesh, specs_tree):
    """``tree``'s tensors as DTensors laid out by the matching specs (each
    rank holds the full tensors and keeps its own shards)."""
    from torch.distributed.tensor import distribute_tensor

    flat_specs = list(_spec_leaves(specs_tree))
    it = iter(flat_specs)
    return map_named(lambda _, t: distribute_tensor(
        t, mesh, placements(next(it), mesh), src_data_rank=None), tree)


def _spec_leaves(tree):
    out = []
    map_named(lambda _, s: out.append(s), tree)
    return out
