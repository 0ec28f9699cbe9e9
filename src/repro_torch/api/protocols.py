"""The three extension protocols (port of ``repro.api.protocols``).

A placement policy filters and scores nodes, an estimator produces the
load estimate L-hat, and a penalty controller adapts the estimation
penalty P from the QoS signal.  Implementations are frozen dataclasses;
their hooks are plain functions of tensors.

Optional policy hooks, checked by attribute:

* ``queue_order(requests (Q, R), priorities (Q,), valid (Q,)) -> (Q,)``
  permutation of the slot's queue; missing means FIFO.
* ``prepare_params(params) -> params``; missing means identity.
* ``default_theta``: theta used when the caller passes no params.
* ``kernel_inputs(ctx, task) -> KernelInputs``: opt in to the fused
  filter+score kernel.  It must equal ``feasible`` + ``score``.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.api.admission import PolicyContext, TaskView
from repro_torch.core.types import ControllerState, FlexParams


@runtime_checkable
class PlacementPolicy(Protocol):
    name: str

    def feasible(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        """(N,) bool: which nodes may take ``task``."""
        ...

    def score(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        """(N,) f32 placement preference; the argmax over feasible wins."""
        ...


def policy_queue_order(policy):
    return getattr(policy, "queue_order", None)


def policy_supports_kernel(policy) -> bool:
    return getattr(policy, "kernel_inputs", None) is not None


def policy_prepare_params(policy, params: FlexParams) -> FlexParams:
    prep = getattr(policy, "prepare_params", None)
    return prep(params) if prep is not None else params


def policy_default_params(policy, *, device="cuda") -> FlexParams:
    return FlexParams.default(theta=getattr(policy, "default_theta", 1.0),
                              device=device)


@runtime_checkable
class Estimator(Protocol):
    def init_state(self, n_nodes: int, n_resources: int = 2, *,
                   device="cuda"):
        ...

    def refresh(self, state, node_usage: torch.Tensor, draw):
        ...


@runtime_checkable
class PenaltyController(Protocol):
    def init(self, params: FlexParams) -> ControllerState:
        ...

    def update(self, ctrl: ControllerState, qos: torch.Tensor,
               params: FlexParams) -> ControllerState:
        ...
