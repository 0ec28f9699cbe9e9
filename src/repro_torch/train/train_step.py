"""Train step factory: loss -> gradients -> AdamW, with microbatched
gradient accumulation.

Port of ``repro.train.train_step`` without its sharding arguments.  A
model is any object with ``loss(params, batch) -> (loss, metrics)`` over
a dict of parameter tensors; gradients come from
``torch.func.grad_and_value``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                         adamw_init, adamw_update)


def make_train_step(model, opt_cfg: AdamWConfig, accum_steps: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``metrics`` holds ``loss`` and ``grad_norm``
    as 0-d tensors (nothing waits for the device).

    With ``accum_steps`` > 1 the batch's leading axis is split into that
    many microbatches, whose gradients are averaged in float32.
    """
    grad_fn = torch.func.grad_and_value(model.loss, has_aux=True)

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        if accum_steps == 1:
            grads, (loss, metrics) = grad_fn(params, batch)
        else:
            micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            losses = []
            for i in range(accum_steps):
                g, (loss_i, _) = grad_fn(params,
                                         {k: v[i] for k, v in micro.items()})
                grads = {k: grads[k] + g[k].float() / accum_steps
                         for k in grads}
                losses.append(loss_i)
            loss, metrics = torch.stack(losses).mean(), {}
        params, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state,
                                                params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   **metrics}

    return train_step


def init_train_state(model, generator: torch.Generator, *,
                     device="cuda") -> Tuple[Any, AdamWState]:
    params = model.init(generator, device=device)
    return params, adamw_init(params)
