"""Public wrapper: one Flex placement decision over the node table.

``flex_pick_node`` is the kernel/policy boundary: the policy layer
(``repro_torch.api.admission.pick_node``) hands it the node-side tensors
of a policy's ``kernel_inputs`` hook.  Dispatch follows the tensors'
device: CPU tensors take the plain version (``ref.pick_node_ref``), CUDA
tensors launch the hand-written kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flex_score.flex_score import flex_score_pick
from repro_torch.kernels.flex_score.ref import NEG_INF, pick_node_ref


def pack_task(r_task, penalty, cap, w_load, w_src, device) -> torch.Tensor:
    """The kernel's (R + 4,) f32 task vector ``[r..., penalty, cap, w_load,
    w_src]``, built on ``device`` from tensors or Python floats."""
    parts = []
    for x in (r_task, penalty, cap, w_load, w_src):
        if isinstance(x, torch.Tensor):
            parts.append(x.to(device=device, dtype=torch.float32).reshape(-1))
        else:
            parts.append(torch.full((1,), float(x), dtype=torch.float32,
                                    device=device))
    return torch.cat(parts)


def flex_pick_node(est, reserved, src_frac, r_task, penalty, *, w_load=1.0,
                   w_src=0.25, cap=1.0):
    """One fused filter+score+argmax decision (Alg. 3 lines 3-9).

    est (N, R) f32 load estimate (scaled by ``penalty`` inside);
    reserved (N, R) f32; src_frac (N,) f32; r_task (R,) f32; the four
    scalars are Python floats or 0-d tensors.  The score is
    ``-(w_load * max_R(load) + w_src * src_frac)``; infeasible nodes score
    ``NEG_INF``.

    Returns (idx () i32 or -1, best_score () f32, any_feasible () bool),
    without waiting for the device.
    """
    if est.device.type == "cpu":
        return pick_node_ref(est, reserved, src_frac, r_task, penalty,
                             w_load, w_src, cap=cap)
    if est.device.type != "cuda":
        raise ValueError(f"flex_pick_node: no kernel for device {est.device}")
    task_vec = pack_task(r_task, penalty, cap, w_load, w_src, est.device)
    idx, best = flex_score_pick(est.contiguous(), reserved.contiguous(),
                                src_frac.contiguous(), task_vec)
    best = best[0]
    return idx[0], best, best > NEG_INF / 2
