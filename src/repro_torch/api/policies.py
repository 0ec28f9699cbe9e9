"""Built-in policies and the penalty controller (port of ``repro.api.policies``).

The paper's four policies (LeastFit, Oversub, FlexF, FlexL) and two
registry extensions (best-fit-usage, flex-priority), with the reference's
arithmetic, plus the AIMD penalty controller.  The reclaim, migrate and
flex-brownout policies come with the slices that use them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api import admission
from repro_torch.api.admission import PolicyContext, TaskView
from repro_torch.api.registry import register_policy
from repro_torch.core import penalty as _penalty
from repro_torch.core.numerics import fma
from repro_torch.core.types import (
    CLASS_PRODUCTION,
    MEM,
    ControllerState,
    FlexParams,
)


def _flex_src_frac(ctx: PolicyContext, task: TaskView) -> torch.Tensor:
    """Fraction of each node's tasks sharing the incoming task's source
    (same-source tasks tend to peak together, §4.3)."""
    node = ctx.node
    same = node.src_count.index_select(1, task.src.reshape(1)).squeeze(1)
    return same.float() / torch.clamp(node.n_tasks, min=1).float()


def _pin_theta(policy, params: FlexParams) -> FlexParams:
    if policy.pin_theta is None:
        return params
    return params._replace(theta=torch.full_like(params.theta,
                                                 policy.pin_theta))


# ---------------------------------------------------------------------------
# Request-based policies (RLB, eq. 4-5)
# ---------------------------------------------------------------------------

@register_policy("least-fit")
@dataclasses.dataclass(frozen=True)
class LeastFitPolicy:
    """Kubernetes-style LeastFit: request filter + least-requested score."""

    name = "least-fit"
    pin_theta: float | None = 1.0
    default_theta: float = 1.0

    def prepare_params(self, params: FlexParams) -> FlexParams:
        return _pin_theta(self, params)

    def feasible(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        committed = admission.committed_load(ctx.node.requested,
                                             ctx.node.reserved)
        return admission.fits(committed, task.request, ctx.params.theta)

    def score(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        committed = admission.committed_load(ctx.node.requested,
                                             ctx.node.reserved)
        return admission.least_loaded_score(committed, ctx.params.theta)


@register_policy("oversub")
@dataclasses.dataclass(frozen=True)
class OversubPolicy(LeastFitPolicy):
    """LeastFit with requests oversubscribed by theta (paper: 2.0)."""

    name = "oversub"
    pin_theta: float | None = None
    default_theta: float = 2.0


# ---------------------------------------------------------------------------
# Usage-based policies (ULB, eq. 9 + Alg. 3)
# ---------------------------------------------------------------------------

@register_policy("flex-f")
@dataclasses.dataclass(frozen=True)
class FlexFifoPolicy:
    """FlexF: penalized-usage filter, load + same-source score, FIFO."""

    name = "flex-f"
    pin_theta: float | None = 1.0
    default_theta: float = 1.0

    def prepare_params(self, params: FlexParams) -> FlexParams:
        return _pin_theta(self, params)

    def _load(self, ctx: PolicyContext) -> torch.Tensor:
        return admission.usage_load(ctx.node.est_usage, ctx.node.reserved,
                                    ctx.penalty)

    def feasible(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        return admission.fits(self._load(ctx), task.request, 1.0)

    def score(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        load_term = admission.dominant(self._load(ctx))
        return -fma(ctx.params.w_load, load_term,
                    ctx.params.w_src * _flex_src_frac(ctx, task))

    def kernel_inputs(self, ctx: PolicyContext,
                      task: TaskView) -> admission.KernelInputs:
        """Kernel mapping of the ULB filter + Flex score; equal to
        feasible + score."""
        return admission.KernelInputs(
            est_usage=ctx.node.est_usage,
            reserved=ctx.node.reserved,
            src_frac=_flex_src_frac(ctx, task),
            penalty=ctx.penalty,
            cap=torch.ones_like(ctx.penalty),
            w_load=ctx.params.w_load,
            w_src=ctx.params.w_src,
        )


@register_policy("flex-l")
@dataclasses.dataclass(frozen=True)
class FlexLrfPolicy(FlexFifoPolicy):
    """FlexL: FlexF scoring behind a largest-memory-request-first queue."""

    name = "flex-l"

    def queue_order(self, requests: torch.Tensor, priorities: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        mem_req = torch.where(valid, requests[:, MEM], -torch.inf)
        return torch.argsort(-mem_req, stable=True)


@register_policy("best-fit-usage")
@dataclasses.dataclass(frozen=True)
class BestFitUsagePolicy(FlexFifoPolicy):
    """Usage-based best fit: pack the fullest feasible node."""

    name = "best-fit-usage"

    def score(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        return admission.dominant(self._load(ctx))

    def kernel_inputs(self, ctx: PolicyContext,
                      task: TaskView) -> admission.KernelInputs:
        # -(w_load * max(load) + w_src * src) with w_load = -1, w_src = 0
        # is +dominant(load): best fit.
        return super().kernel_inputs(ctx, task)._replace(
            w_load=torch.full_like(ctx.penalty, -1.0),
            w_src=torch.zeros_like(ctx.penalty))


@register_policy("flex-priority")
@dataclasses.dataclass(frozen=True)
class PriorityFlexPolicy(FlexFifoPolicy):
    """Priority-aware Flex: batch tasks fill nodes only to 1 - headroom;
    the queue runs production first, then by memory request."""

    name = "flex-priority"
    headroom: float = 0.1

    def feasible(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        return admission.fits(self._load(ctx), task.request, self._cap(task))

    def _cap(self, task: TaskView) -> torch.Tensor:
        return torch.where(task.priority >= CLASS_PRODUCTION, 1.0,
                           1.0 - self.headroom).to(torch.float32)

    def kernel_inputs(self, ctx: PolicyContext,
                      task: TaskView) -> admission.KernelInputs:
        return super().kernel_inputs(ctx, task)._replace(cap=self._cap(task))

    def queue_order(self, requests: torch.Tensor, priorities: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        is_prod = (priorities >= CLASS_PRODUCTION).float()
        key = torch.where(valid, 2.0 * is_prod + requests[:, MEM],
                          -torch.inf)
        return torch.argsort(-key, stable=True)


def resolve_estimator(est, noise_std: float = 0.0):
    """str | estimator object -> stateful estimator (the estimators
    registry)."""
    from repro_torch.estimators.registry import resolve_estimator as _resolve
    return _resolve(est, noise_std)


# ---------------------------------------------------------------------------
# Penalty controllers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AimdPenaltyController:
    """The paper's AIMD-style controller (Alg. 3 lines 19-25)."""

    def init(self, params: FlexParams) -> ControllerState:
        return ControllerState.init(params)

    def update(self, ctrl: ControllerState, qos: torch.Tensor,
               params: FlexParams) -> ControllerState:
        return _penalty.update_penalty(ctrl, qos, params)
