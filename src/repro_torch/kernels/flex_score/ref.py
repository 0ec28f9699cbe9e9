"""Plain PyTorch versions of the Flex filter+score+argmax step.

Mirror ``repro.kernels.flex_score.ref`` (``pick_node_ref`` and its batched
and top-K forms) as the reference runs them, jitted: XLA contracts
``penalty * est + reserved`` and ``w_load * max_R(load) + w_src *
src_frac`` into fused multiply-adds, so these versions round each once
(:func:`repro_torch.core.numerics.fma`), exactly as the CUDA kernels do
with ``__fmaf_rn``.  The CPU tests hold them bit-equal to the reference's
interpret-mode Pallas kernels, and ``chip_smoke.py`` holds the CUDA
kernels bit-equal to them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import fma

# Masking convention shared with repro_torch.api.admission.NEG_INF: a
# finite sentinel keeps max/argmax NaN-free; "any node fits" is decided by
# ``best > NEG_INF / 2``.
NEG_INF = -1e30


def pick_node_ref(est, reserved, src_frac, r_task, penalty, w_load, w_src,
                  cap=1.0):
    """est/reserved (N, R); src_frac (N,); r_task (R,) or scalar.

    ``penalty``/``cap``/``w_load``/``w_src`` are Python floats or 0-d f32
    tensors.  Nothing here waits for the device.
    Returns (idx () i32 or -1, best_score () f32, any_feasible () bool).
    """
    load = fma(penalty, est, reserved)
    feasible = (load + r_task <= cap).all(dim=-1)
    inner = fma(w_load, load.max(dim=-1).values, w_src * src_frac)
    score = torch.where(feasible, -inner, NEG_INF)
    any_feasible = feasible.any()
    best = torch.argmax(score).to(torch.int32)
    idx = torch.where(any_feasible, best, -1).to(torch.int32)
    return idx, score.max(), any_feasible


def _batch_scores(est, reserved, src_frac, r_task, penalty, w_load, w_src,
                  cap):
    """(Q, N) scores of Q tasks against the node table, NEG_INF where a
    node does not fit; per (task, node) the arithmetic of
    :func:`pick_node_ref`."""
    load = fma(penalty[:, None, None], est[None], reserved[None])  # (Q,N,R)
    feasible = (load + r_task[:, None, :] <= cap[:, None, None]).all(dim=-1)
    inner = fma(w_load[:, None], load.max(dim=-1).values,
                w_src[:, None] * src_frac)
    return torch.where(feasible, -inner, NEG_INF)


def pick_node_batch_ref(est, reserved, src_frac, r_task, penalty, w_load,
                        w_src, cap):
    """Batched version: each of Q tasks against the node table.

    est/reserved (N, R); src_frac (Q, N); r_task (Q, R); penalty, w_load,
    w_src and cap (Q,) f32.  Row q equals :func:`pick_node_ref` of task q
    bit for bit.

    Returns (idx (Q,) i32 or -1, best_score (Q,) f32, any_feasible (Q,)).
    """
    score = _batch_scores(est, reserved, src_frac, r_task, penalty, w_load,
                          w_src, cap)
    best = score.max(dim=1).values
    any_feasible = best > NEG_INF / 2
    idx = torch.where(any_feasible, torch.argmax(score, dim=1), -1)
    return idx.to(torch.int32), best, any_feasible


def pick_node_batch_topk_ref(est, reserved, src_frac, r_task, penalty,
                             w_load, w_src, cap, k):
    """Top-``k`` version: each task's k best nodes.

    Shapes as in :func:`pick_node_batch_ref`.  Slots are ordered by
    (score desc, node index asc), the order of ``jax.lax.top_k``: a stable
    descending sort keeps equal scores in index order (``torch.topk``
    promises no order among ties).  Slots past a task's feasible nodes,
    and past N when k > N, are (-1, NEG_INF).  Column 0 is
    :func:`pick_node_batch_ref`'s decision.

    Returns (idx (Q, k) i32, score (Q, k) f32, any_feasible (Q,)).
    """
    score = _batch_scores(est, reserved, src_frac, r_task, penalty, w_load,
                          w_src, cap)
    q, n = score.shape
    best, idx = torch.sort(score, dim=1, descending=True, stable=True)
    best, idx = best[:, :k], idx[:, :k].to(torch.int32)
    if k > n:
        best = torch.cat([best, best.new_full((q, k - n), NEG_INF)], dim=1)
        idx = torch.cat([idx, idx.new_full((q, k - n), -1)], dim=1)
    idx = torch.where(best > NEG_INF / 2, idx, -1).to(torch.int32)
    return idx, best, best[:, 0] > NEG_INF / 2
