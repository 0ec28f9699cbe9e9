"""numpy arrays -> the port's types, with the reference's dtypes pinned.

The JAX package hands its state over as ``np.asarray`` of each leaf; these
functions cast every float to float32 and every integer to int32 (a
float64 array never becomes a float64 tensor) and place the result on
``device``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.noise import ReplayNoise
from repro_torch.core.types import FlexParams, NodeState, TaskSet

_INT_FIELDS = {"arrival", "duration", "priority", "src", "n_tasks",
               "src_count"}


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


def noise_table_from_numpy(table: np.ndarray, *,
                           device="cuda") -> ReplayNoise:
    """(S, T) demand-noise table -> a :class:`ReplayNoise` source."""
    return ReplayNoise(_tensor("noise", table, device))
