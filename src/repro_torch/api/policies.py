"""Built-in policies and the penalty controller (port of ``repro.api.policies``).

The paper's four policies (LeastFit, Oversub, FlexF, FlexL), five
registry extensions (best-fit-usage, flex-priority, flex-brownout, and
the simulator's reclaim and migrate passes), with the reference's
arithmetic, the legacy stateless estimators and the AIMD penalty
controller.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api import admission
from repro_torch.api.admission import PolicyContext, TaskView
from repro_torch.api.registry import register_policy
from repro_torch.core import estimator as _est
from repro_torch.core import penalty as _penalty
from repro_torch.core.numerics import fma
from repro_torch.core.types import (
    CLASS_PRODUCTION,
    MEM,
    ControllerState,
    FlexParams,
)
from repro_torch.kernels.flex_score.ref import src_share


def _flex_src_frac(ctx: PolicyContext, task: TaskView) -> torch.Tensor:
    """Fraction of each node's tasks sharing the incoming task's source
    (same-source tasks tend to peak together, §4.3); the queue kernel
    computes the same share itself."""
    return src_share(ctx.node.n_tasks, ctx.node.src_count, task.src)


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

    def _kernel_scalars(self, ctx: PolicyContext, task: TaskView):
        """(penalty, cap, w_load, w_src) of the kernel template for one
        task, or for a queue of them (then broadcastable to (Q,)); the one
        place both kernel hooks take them from."""
        return (ctx.penalty, torch.ones_like(ctx.penalty), ctx.params.w_load,
                ctx.params.w_src)

    def kernel_inputs(self, ctx: PolicyContext,
                      task: TaskView) -> admission.KernelInputs:
        """Kernel mapping of the ULB filter + Flex score; equal to
        feasible + score."""
        penalty, cap, w_load, w_src = self._kernel_scalars(ctx, task)
        return admission.KernelInputs(
            est_usage=ctx.node.est_usage,
            reserved=ctx.node.reserved,
            src_frac=_flex_src_frac(ctx, task),
            penalty=penalty, cap=cap, w_load=w_load, w_src=w_src)

    def queue_kernel_rows(self, ctx: PolicyContext,
                          tasks: TaskView) -> torch.Tensor:
        """The queue kernel's (Q, R + 4) task rows ``[r..., penalty, cap,
        w_load, w_src]`` for a queue of tasks (``tasks`` leaves lead with
        Q), in one pass.

        Defining this hook declares that the policy's ``kernel_inputs``
        are the Flex template over the node state with ``src_frac`` the
        same-source share ``src_count[:, src] / max(n_tasks, 1)``, which
        the queue kernel computes itself from the state each earlier
        decision left.  Row q equals ``kernel_inputs`` of task q.
        """
        q = tasks.request.shape[0]
        cols = [torch.as_tensor(x, dtype=torch.float32,
                                device=tasks.request.device).expand(q)[:, None]
                for x in self._kernel_scalars(ctx, tasks)]
        return torch.cat([tasks.request.to(torch.float32), *cols],
                         dim=1).contiguous()


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

    def _kernel_scalars(self, ctx: PolicyContext, task: TaskView):
        # -(w_load * max(load) + w_src * src) with w_load = -1, w_src = 0
        # is +dominant(load): best fit.
        penalty, cap, _, _ = super()._kernel_scalars(ctx, task)
        return (penalty, cap, torch.full_like(ctx.penalty, -1.0),
                torch.zeros_like(ctx.penalty))


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

    def _kernel_scalars(self, ctx: PolicyContext, task: TaskView):
        penalty, _, w_load, w_src = super()._kernel_scalars(ctx, task)
        return penalty, self._cap(task), w_load, w_src

    def queue_order(self, requests: torch.Tensor, priorities: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        is_prod = (priorities >= CLASS_PRODUCTION).float()
        key = torch.where(valid, 2.0 * is_prod + requests[:, MEM],
                          -torch.inf)
        return torch.argsort(-key, stable=True)


@register_policy("reclaim")
@dataclasses.dataclass(frozen=True)
class ReclaimPolicy(FlexFifoPolicy):
    """Headroom reclamation: second-chance admission against PREDICTED usage.

    The simulator's reclamation pass (``SimConfig(reclamation=True)``)
    re-admits tasks the primary policy dropped: a node is feasible iff
    ``P * L-hat + reserved + r <= 1 - margin_scale * P``.  The margin
    follows the live penalty P, so reclamation backs off as QoS
    violations raise it.  Scoring is FlexF's, and the cap rides the
    kernel template's ``cap`` scalar, so the pass runs through the same
    admission path as primary admission.
    """

    name = "reclaim"
    margin_scale: float = 0.1

    def _cap(self, ctx: PolicyContext) -> torch.Tensor:
        # Rounded once: the jitted reference contracts 1 - m * P.
        return torch.clamp(fma(-self.margin_scale, ctx.penalty, 1.0),
                           min=0.0)

    def feasible(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        return admission.fits(self._load(ctx), task.request, self._cap(ctx))

    def _kernel_scalars(self, ctx: PolicyContext, task: TaskView):
        penalty, _, w_load, w_src = super()._kernel_scalars(ctx, task)
        return penalty, self._cap(ctx), w_load, w_src


@register_policy("migrate")
@dataclasses.dataclass(frozen=True)
class MigratePolicy(ReclaimPolicy):
    """Live-migration targets: re-place a task resident on a draining or
    overloaded node (``repro_torch.migration``).

    The reclaim pass's template: FlexF's score, the cap ``1 - margin_scale
    * P`` in the kernel template's ``cap`` scalar.  The sources need no
    per-task exclusion: the pass puts ``DRAIN_LOAD`` on every draining
    node's reserved row first (``admission.mask_unavailable``), and the
    cap filter rejects those rows for every task.
    """

    name = "migrate"
    margin_scale: float = 0.0


@register_policy("flex-brownout")
@dataclasses.dataclass(frozen=True)
class BrownoutPolicy(FlexFifoPolicy):
    """QoS-pressure brownout: batch tasks may fill a node only up to
    ``clip(1 - brownout_scale * (P - p_min), floor, 1)``, production and
    system tasks to full capacity, so batch admission browns out as the
    penalty rises.  The cap depends on the task's priority and rides the
    kernel template's per-task ``cap`` column (the queue kernel's task
    rows, the batched sweeps' task matrix).
    """

    name = "flex-brownout"
    brownout_scale: float = 0.25
    floor: float = 0.2

    def _cap(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        # Rounded once: the jitted reference contracts 1 - s * (P - p_min).
        batch_cap = torch.clamp(
            fma(-self.brownout_scale, ctx.penalty - ctx.params.p_min, 1.0),
            self.floor, 1.0)
        return torch.where(task.priority >= CLASS_PRODUCTION, 1.0,
                           batch_cap).to(torch.float32)

    def feasible(self, ctx: PolicyContext, task: TaskView) -> torch.Tensor:
        return admission.fits(self._load(ctx), task.request,
                              self._cap(ctx, task))

    def _kernel_scalars(self, ctx: PolicyContext, task: TaskView):
        penalty, _, w_load, w_src = super()._kernel_scalars(ctx, task)
        return penalty, self._cap(ctx, task), w_load, w_src


# ---------------------------------------------------------------------------
# Legacy stateless estimators (wrappers over repro_torch.core.estimator)
#
# They predate the estimators subsystem and keep the legacy
# ``refresh(prev_est, node_usage, draw) -> est`` hook, where ``draw(shape)``
# returns the slot's standard normals from the run's noise source; the
# simulator adapts them by ``estimators.base.StatelessAdapter``.  New code
# registers stateful estimators with ``register_estimator``.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CurrentUsageEstimator:
    """The paper's estimator: L-hat = measured current usage, with
    optional multiplicative measurement noise."""

    noise_std: float = 0.0
    run_axis = True

    def refresh(self, prev_est: torch.Tensor, node_usage: torch.Tensor,
                draw) -> torch.Tensor:
        return _est.current_usage(node_usage, draw, self.noise_std)


@dataclasses.dataclass(frozen=True)
class EwmaEstimator:
    """EWMA smoothing (the related work's standard choice)."""

    decay: float = 0.7
    run_axis = True

    def refresh(self, prev_est: torch.Tensor, node_usage: torch.Tensor,
                draw) -> torch.Tensor:
        return _est.ewma(prev_est, node_usage, self.decay)


ESTIMATORS = {
    "current": CurrentUsageEstimator,
    "ewma": EwmaEstimator,
}


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
