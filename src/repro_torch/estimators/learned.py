"""Learned usage predictor: a small MLP over the sliding usage window.

Port of ``repro.estimators.learned``.  A per-(node, resource) scalar MLP
maps the last ``window`` usage samples to the next one.  It is trained on
AR(1) demand series built from a trace's task statistics, with the
simulator's demand process and rounding.

The head is residual and starts at zero (``pred = last + mlp(window)``),
so an untrained ``learned`` estimator is exactly ``current``.  Training
runs through :mod:`repro_torch.train` (AdamW with the cosine schedule,
gradients from ``torch.func``) and checkpoints through
:mod:`repro_torch.train.checkpoint`, in the reference's layout.

Randomness (the series' white noise, the first layer's initial weights,
the batch indices) comes from one ``torch.Generator``; a caller may pass
each of them instead, which the parity tests do with the reference's
draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.numerics import fma, sqrt
from repro_torch.core.types import NUM_RESOURCES, TaskSet
from repro_torch.estimators.base import EstimatorState, node_shape
from repro_torch.estimators.builtin import ring_chronological, ring_push
from repro_torch.estimators.registry import register_estimator

Params = Dict[str, torch.Tensor]

# Tasks whose series make the training set (the reference's default).
MAX_TASKS = 512


# ---------------------------------------------------------------------------
# Model: per-series scalar MLP, residual head
# ---------------------------------------------------------------------------

def mlp_init(window: int, hidden: int, *,
             generator: Optional[torch.Generator] = None,
             device="cuda") -> Params:
    """Parameters with a zero head: the untrained prediction is the last
    sample."""
    scale = float(np.float32(1.0 / np.sqrt(window)))
    w1 = torch.randn((window, hidden), generator=generator,
                     dtype=torch.float32, device=device)
    return {
        "w1": scale * w1,
        "b1": torch.zeros((hidden,), dtype=torch.float32, device=device),
        "w2": torch.zeros((hidden, 1), dtype=torch.float32, device=device),
        "b2": torch.zeros((1,), dtype=torch.float32, device=device),
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., window) usage history, oldest first -> (...) prediction."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return x[..., -1] + (h @ params["w2"])[..., 0] + params["b2"][0]


class UsagePredictor(nn.Module):
    """The predictor as a module: ``mlp_init``'s parameters and
    ``mlp_apply``."""

    def __init__(self, window: int, hidden: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        for name, value in mlp_init(window, hidden, generator=generator,
                                    device=device).items():
            self.register_parameter(name, nn.Parameter(value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(dict(self.named_parameters()), x)


class UsagePredictorModel(NamedTuple):
    """The model ``make_train_step`` takes: ``init`` and ``loss``."""

    window: int
    hidden: int

    def init(self, generator: Optional[torch.Generator] = None, *,
             device="cuda") -> Params:
        return mlp_init(self.window, self.hidden, generator=generator,
                        device=device)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]):
        """Mean squared error of the prediction."""
        pred = mlp_apply(params, batch["x"])
        return torch.mean(torch.square(pred - batch["y"])), {}


# ---------------------------------------------------------------------------
# Dataset: AR(1) demand series from trace statistics
# ---------------------------------------------------------------------------

def make_dataset(ts: TaskSet, n_slots: int, window: int,
                 white: torch.Tensor, max_tasks: int = MAX_TASKS) -> Params:
    """Sliding (window -> next) examples from per-task demand series.

    Each of the first ``min(T, max_tasks)`` tasks' series follows the
    simulator's demand process (AR(1) noise around ``mean_usage``,
    clipped at ``peak_usage``), driven by ``white``, an
    ``(n, n_slots)`` table of standard normals.  Returns ``{"x": (E,
    window), "y": (E,)}``.

    The pairs are the reference's: ``x`` is ordered (task, time,
    resource) and ``y`` (task, resource, time), so with two resources an
    example's target is another time's or another resource's sample.
    """
    n = min(int(ts.num_tasks), max_tasks)
    if tuple(white.shape) != (n, n_slots):
        raise ValueError(f"make_dataset: white noise must be ({n}, "
                         f"{n_slots}), got {tuple(white.shape)}")
    dev = white.device
    mean, std, peak, rho = (x[:n].to(dev) for x in (
        ts.mean_usage, ts.std_usage, ts.peak_usage, ts.ar_rho))
    innov = sqrt(torch.clamp(fma(-rho, rho, 1.0), min=0.0))
    noise = torch.zeros(n, dtype=torch.float32, device=dev)
    series = []
    for s in range(n_slots):
        noise = fma(rho, noise, innov * white[:, s])
        series.append(torch.minimum(
            torch.clamp(fma(std, noise[:, None], mean), min=0.0), peak))
    series = torch.stack(series, dim=1)                         # (T, S, R)
    idx = (torch.arange(n_slots - window, device=dev)[:, None]
           + torch.arange(window, device=dev)[None, :])         # (E0, W)
    x = series[:, idx, :]                                       # (T, E0, W, R)
    y = series[:, window:, :]                                   # (T, E0, R)
    return {"x": x.movedim(3, 2).reshape(-1, window),
            "y": y.movedim(2, 1).reshape(-1)}


def train_usage_predictor(
        ts: TaskSet, *, window: int = 12, hidden: int = 8,
        n_slots: int = 64, steps: int = 200, batch_size: int = 1024,
        lr: float = 3e-3, seed: int = 0, ckpt_dir: Optional[str] = None,
        device="cuda", params: Optional[Params] = None,
        white: Optional[torch.Tensor] = None,
        batch_index: Optional[Callable[[int], torch.Tensor]] = None
        ) -> Tuple[Params, list]:
    """Fit the predictor on trace-derived series; optionally checkpoint.

    ``params`` (initial parameters), ``white`` (the series' noise table)
    and ``batch_index(step) -> (batch_size,)`` example indices default
    to draws from one ``torch.Generator`` seeded with ``seed``.  Returns
    ``(params, losses)``, one loss a step.  With ``ckpt_dir`` the final
    parameters are saved with the architecture in ``extra``, so
    ``LearnedUsageEstimator.from_checkpoint`` can rebuild the estimator.
    """
    from repro_torch.train.checkpoint import save
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if white is None:
        white = torch.randn((min(int(ts.num_tasks), MAX_TASKS), n_slots),
                            generator=gen, dtype=torch.float32,
                            device=device)
    data = make_dataset(ts, n_slots, window, white.to(device))
    n_examples = data["y"].shape[0]

    model = UsagePredictorModel(window=window, hidden=hidden)
    if params is None:
        params = model.init(gen, device=device)
    params = {k: v.to(device) for k, v in params.items()}
    if batch_index is None:
        def batch_index(step: int) -> torch.Tensor:
            return torch.randint(0, n_examples, (batch_size,),
                                 generator=gen, device=device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                          total_steps=steps, weight_decay=0.0)
    opt_state = adamw_init(params)
    train_step = make_train_step(model, opt_cfg)

    losses = []
    for step in range(steps):
        take = batch_index(step).to(device)
        batch = {"x": data["x"][take], "y": data["y"][take]}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(metrics["loss"])
    losses = torch.stack(losses).tolist() if losses else []

    if ckpt_dir is not None:
        save(ckpt_dir, steps, params,
             extra={"window": window, "hidden": hidden,
                    "final_loss": losses[-1]})
    return params, losses


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

def _freeze(params: Params) -> tuple:
    """Parameters -> hashable nested tuples (sorted keys)."""
    def leaf(t):
        a = t.detach().cpu().numpy()
        return (a.shape, tuple(float(v) for v in a.ravel()))
    return tuple((k, leaf(v)) for k, v in sorted(params.items()))


def _thaw(frozen: tuple, device) -> Params:
    return {k: torch.tensor(vals, dtype=torch.float32).reshape(shape)
            .to(device) for k, (shape, vals) in frozen}


@dataclasses.dataclass(frozen=True)
class LearnedUsageEstimator:
    """MLP next-usage predictor over a ``(window, N, R)`` ring buffer
    (``(window, B, N, R)`` for B runs).

    ``frozen_params`` keeps the object hashable; ``init_state`` thaws
    them onto the state's device.  Predictions are clipped to [0, 1]: a
    load estimate is a fraction of a node's capacity.
    """

    window: int = 12
    hidden: int = 8
    frozen_params: Any = None   # nested tuples from _freeze; None = untrained
    run_axis = True

    @classmethod
    def untrained(cls, window: int = 12,
                  hidden: int = 8) -> "LearnedUsageEstimator":
        """Zero-head parameters: exactly the ``current`` estimator."""
        gen = torch.Generator().manual_seed(0)
        return cls.from_params(
            mlp_init(window, hidden, generator=gen, device="cpu"),
            window, hidden)

    @classmethod
    def from_params(cls, params: Params, window: int,
                    hidden: int) -> "LearnedUsageEstimator":
        return cls(window=window, hidden=hidden,
                   frozen_params=_freeze(params))

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str,
                        step: Optional[int] = None
                        ) -> "LearnedUsageEstimator":
        """Rebuild from a ``train_usage_predictor`` checkpoint (either
        package's)."""
        from repro_torch.train.checkpoint import (latest_step, restore,
                                                  restore_extra)

        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
        extra = restore_extra(ckpt_dir, step)
        window, hidden = int(extra["window"]), int(extra["hidden"])
        like = mlp_init(window, hidden, device="cpu",
                        generator=torch.Generator().manual_seed(0))
        params, _ = restore(ckpt_dir, step, like)
        return cls.from_params(params, window, hidden)

    def init_state(self, n_nodes: int, n_resources: int = NUM_RESOURCES, *,
                   device="cuda", runs=None) -> EstimatorState:
        frozen = self.frozen_params
        if frozen is None:
            frozen = LearnedUsageEstimator.untrained(
                self.window, self.hidden).frozen_params
        shape = node_shape(n_nodes, n_resources, runs)
        buffer = torch.zeros((self.window,) + shape, dtype=torch.float32,
                             device=device)
        return EstimatorState(
            est=torch.zeros(shape, dtype=torch.float32, device=device),
            aux=(buffer, 0, _thaw(frozen, device)))

    def refresh(self, state: EstimatorState, node_usage: torch.Tensor,
                draw) -> EstimatorState:
        buffer, t, params = state.aux
        buffer = ring_push(buffer, t, node_usage)
        # (N, R, W), or (B, N, R, W): the MLP's products batched over runs
        x = ring_chronological(buffer, t).movedim(0, -1)
        est = torch.clamp(mlp_apply(params, x), 0.0, 1.0)
        return EstimatorState(est=est, aux=(buffer, t + 1, params))


# The registry's default is the untrained (== 'current') estimator; runs
# with a trained one pass a LearnedUsageEstimator object instead.
register_estimator("learned", lambda: LearnedUsageEstimator.untrained())
