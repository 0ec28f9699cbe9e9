"""Plain PyTorch version of the Flex filter+score+argmax step.

Mirrors ``repro.kernels.flex_score.ref.pick_node_ref`` as the reference
runs it, jitted: XLA contracts ``penalty * est + reserved`` and
``w_load * max_R(load) + w_src * src_frac`` into fused multiply-adds, so
this version rounds each once (:func:`repro_torch.core.numerics.fma`),
exactly as the CUDA kernel does with ``__fmaf_rn``.  The CPU tests hold
it bit-equal to the reference's interpret-mode Pallas kernel, and
``chip_smoke.py`` holds the CUDA kernel bit-equal to it on the card.
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
