"""numpy arrays -> the port's types, with the reference's dtypes pinned.

The JAX package hands its state over as ``np.asarray`` of each leaf.  The
simulator's state casts every float to float32 and every integer to int32
(a float64 array never becomes a float64 tensor); model parameters keep
their dtype (float32, or bfloat16 through float32, which is exact).  Each
result lands on ``device``.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.noise import ReplayNoise
from repro_torch.core.types import FlexParams, NodeState, TaskSet

_INT_FIELDS = {"arrival", "duration", "priority", "src", "n_tasks",
               "src_count", "jitter"}


def _tensor(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _INT_FIELDS:
        if not np.issubdtype(a.dtype, np.integer):
            raise TypeError(f"{name}: expected integers, got {a.dtype}")
        a = a.astype(np.int32)
    else:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _build(cls, arrays: Mapping[str, np.ndarray], device):
    missing = set(cls._fields) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{f: _tensor(f, arrays[f], device) for f in cls._fields})


def taskset_from_numpy(arrays: Mapping[str, np.ndarray], *,
                       device="cuda") -> TaskSet:
    return _build(TaskSet, arrays, device)


def params_from_numpy(arrays: Mapping[str, np.ndarray], *,
                      device="cuda") -> FlexParams:
    return _build(FlexParams, arrays, device)


def node_state_from_numpy(arrays: Mapping[str, np.ndarray], *,
                          device="cuda") -> NodeState:
    return _build(NodeState, arrays, device)


def noise_table_from_numpy(table: np.ndarray, *, jitter=None,
                           device="cuda") -> ReplayNoise:
    """(S, T) demand-noise table, and optionally the reference's (T,)
    retry-jitter table (``faults.jitter_table`` of its run key's jitter
    stream), -> a :class:`ReplayNoise` source."""
    return ReplayNoise(_tensor("noise", table, device),
                       None if jitter is None
                       else _tensor("jitter", jitter, device))


def fault_schedule_from_numpy(schedule, *, device="cuda"):
    """The reference's ``FaultSchedule`` (a NamedTuple or mapping of
    array-likes; ``draining`` may be None) -> the port's, node_up and
    draining bool, capacity and demand_mult float32."""
    from repro_torch.faults.injection import FaultSchedule

    if hasattr(schedule, "_asdict"):
        schedule = schedule._asdict()
    out = {}
    for name in FaultSchedule._fields:
        a = schedule.get(name)
        if a is None:
            if name != "draining":
                raise KeyError(f"FaultSchedule: missing field {name}")
            out[name] = None
            continue
        a = np.asarray(a)
        a = a.astype(bool if name in ("node_up", "draining")
                     else np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return FaultSchedule(**out)


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes.bfloat16
        t = torch.from_numpy(a.astype(np.float32))
        return t.to(device=device, dtype=torch.bfloat16)
    if a.dtype != np.float32:
        raise TypeError(f"model parameter of dtype {a.dtype}: expected "
                        f"float32 or bfloat16")
    return torch.from_numpy(np.array(a)).to(device)


def model_params_from_numpy(cfg, tree: Mapping[str, Any], *,
                            device="cuda"):
    """The reference's ``model.init`` tree (numpy leaves, ``layers`` and
    the encdec's ``enc_layers`` stacked on a leading L axis, the hybrid's
    ``shared_block`` not; a moe layer's ``moe`` group with its router,
    expert weights and nested ``shared`` MLP) -> the port's :class:`LM`,
    or :class:`EncDec` for the encdec family."""
    from repro_torch.models.model import LM, EncDec, require_ported

    require_ported(cfg)

    def groups(t, i=None):
        return {name: (groups(leaf, i) if isinstance(leaf, Mapping)
                       else _leaf(leaf if i is None else leaf[i], device))
                for name, leaf in t.items()}

    def stack(name, n):
        return [groups(tree[name], i) for i in range(n)]

    if cfg.family == "encdec":
        return EncDec(*(_leaf(tree[k], device) for k in
                        ("tok_emb", "dec_pos_emb", "enc_pos_emb")),
                      stack("enc_layers", cfg.n_enc_layers),
                      groups(tree["enc_ln_f"]),
                      stack("layers", cfg.n_layers), groups(tree["ln_f"]))
    lm_head = tree.get("lm_head")
    shared = tree.get("shared_block")
    return LM(_leaf(tree["tok_emb"], device), stack("layers", cfg.n_layers),
              groups(tree["ln_f"]),
              None if lm_head is None else _leaf(lm_head, device),
              None if shared is None else groups(shared))


def learned_params(np_params: Mapping[str, np.ndarray], *,
                   device="cuda") -> dict:
    """The reference's usage-predictor parameters (``mlp_init``'s dict,
    numpy leaves) -> the port's float32 tensors on ``device``."""
    return {k: _tensor(k, v, device) for k, v in np_params.items()}


_STACKED = ("layers", "enc_layers")


def _named(params) -> Mapping[str, torch.Tensor]:
    """The module's parameters by name, or a mapping of such names."""
    if isinstance(params, Mapping):
        return params
    return dict(params.named_parameters())


def model_tree(params) -> dict:
    """The port's :class:`LM` or :class:`EncDec` (or a mapping of its
    parameter names, as ``named_parameters`` gives them, to tensors: its
    gradients) -> the reference's ``model.init`` tree of tensors:
    ``layers`` and ``enc_layers`` stacked on a leading L axis (copies),
    the other leaves as they are."""
    tree: dict = {}
    stacks: dict = {}

    def put(path, leaf):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    for name, t in _named(params).items():
        parts = name.split(".")
        if parts[0] in _STACKED:
            stacks.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = t
        else:
            put(parts, t)
    for path, per_layer in stacks.items():
        put(path, torch.stack([per_layer[i] for i in range(len(per_layer))]))
    return tree


def load_model_tree(params, tree: Mapping[str, Any]) -> None:
    """Copy a reference-layout tree of tensors (``model_tree``'s, or a
    restored checkpoint's) into the module's parameters, in place."""
    with torch.no_grad():
        for name, p in params.named_parameters():
            parts = name.split(".")
            if parts[0] in _STACKED:
                node, path, i = tree[parts[0]], parts[2:], int(parts[1])
            else:
                node, path, i = tree, parts, None
            for key in path:
                node = node[key]
            p.copy_(node if i is None else node[i])


def model_params_to_numpy(cfg, params) -> dict:
    """The inverse of :func:`model_params_from_numpy`: the reference's
    tree layout (``model_tree``) with numpy leaves.  bfloat16 leaves come
    out as float32 arrays (exact), since numpy has no bfloat16 of its
    own."""
    from repro_torch.models.model import require_ported

    require_ported(cfg)

    def leaves(node):
        if isinstance(node, dict):
            return {k: leaves(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return leaves(model_tree(params))
