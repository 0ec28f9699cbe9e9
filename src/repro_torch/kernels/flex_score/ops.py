"""Public wrappers: Flex placement decisions over the node table.

The kernel/policy boundary.  ``flex_pick_node`` makes one decision (the
sequential scan, ``repro_torch.api.admission.pick_node``);
``flex_pick_node_batch`` (each task's argmax) and
``flex_pick_node_batch_topk`` (each task's k best nodes) score a whole
queue in one sweep (wavefront admission,
``repro_torch.api.admission.admit_queue_wavefront``).  Dispatch follows
the tensors' device: CPU tensors take the plain versions (``ref.py``),
CUDA tensors launch the hand-written kernels or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flex_score.flex_score import (flex_score_batch_pick,
                                                       flex_score_batch_topk,
                                                       flex_score_pick)
from repro_torch.kernels.flex_score.ref import (NEG_INF, pick_node_batch_ref,
                                                pick_node_batch_topk_ref,
                                                pick_node_ref)


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


def _device_kind(caller, est) -> str:
    if est.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{caller}: no kernel for device {est.device}")
    return est.device.type


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
    if _device_kind("flex_pick_node", est) == "cpu":
        return pick_node_ref(est, reserved, src_frac, r_task, penalty,
                             w_load, w_src, cap=cap)
    task_vec = pack_task(r_task, penalty, cap, w_load, w_src, est.device)
    idx, best = flex_score_pick(est.contiguous(), reserved.contiguous(),
                                src_frac.contiguous(), task_vec)
    best = best[0]
    return idx[0], best, best > NEG_INF / 2


def _check_batch_args(caller, est, src_frac, r_task, penalty, cap, w_load,
                      w_src):
    """Shape check of the batched wrappers: r_task (Q, R) and src_frac
    (Q, N).  Returns (r_task, penalty, cap, w_load, w_src) as f32 on est's
    device, the four scalars broadcast to (Q,)."""
    dev = est.device
    r_task = torch.as_tensor(r_task, dtype=torch.float32, device=dev)
    q = r_task.shape[0] if r_task.dim() else 0
    n, r = est.shape
    if tuple(r_task.shape) != (q, r) or tuple(src_frac.shape) != (q, n):
        raise ValueError(
            f"{caller}: expected r_task (Q, R)={(q, r)} and src_frac "
            f"(Q, N)={(q, n)}, got {tuple(r_task.shape)} and "
            f"{tuple(src_frac.shape)}")

    def bcast(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x.reshape(-1).expand(q)

    return (r_task,) + tuple(map(bcast, (penalty, cap, w_load, w_src)))


def _task_mat(r_task, penalty, cap, w_load, w_src) -> torch.Tensor:
    """The (Q, R + 4) rows ``[r..., penalty, cap, w_load, w_src]``."""
    return torch.cat([r_task, penalty[:, None], cap[:, None],
                      w_load[:, None], w_src[:, None]], dim=1).contiguous()


def flex_pick_node_batch(est, reserved, src_frac, r_task, penalty, *,
                         w_load, w_src, cap):
    """One batched filter+score+argmax sweep over the whole queue.

    est/reserved (N, R) f32, shared by every task; src_frac (Q, N) f32;
    r_task (Q, R) f32; penalty, w_load, w_src and cap scalars or (Q,).
    Row q equals :func:`flex_pick_node` of task q bit for bit.

    Returns (idx (Q,) i32 or -1, best_score (Q,) f32, any_feasible (Q,)),
    without waiting for the device.
    """
    caller = "flex_pick_node_batch"
    kind = _device_kind(caller, est)
    r_task, penalty, cap, w_load, w_src = _check_batch_args(
        caller, est, src_frac, r_task, penalty, cap, w_load, w_src)
    src_frac = src_frac.to(torch.float32)
    if kind == "cpu":
        return pick_node_batch_ref(est, reserved, src_frac, r_task, penalty,
                                   w_load, w_src, cap)
    idx, best = flex_score_batch_pick(
        est.contiguous(), reserved.contiguous(), src_frac.contiguous(),
        _task_mat(r_task, penalty, cap, w_load, w_src))
    return idx, best, best > NEG_INF / 2


def flex_pick_node_batch_topk(est, reserved, src_frac, r_task, penalty, *,
                              w_load, w_src, cap, k=8):
    """Each task's ``k`` best candidates in one sweep over the node table.

    Arguments as in :func:`flex_pick_node_batch`, plus ``k``.  Rows are
    ordered by (score desc, node asc); column 0 is
    :func:`flex_pick_node_batch`'s decision.

    Returns (idx (Q, k) i32, score (Q, k) f32, any_feasible (Q,)); slots
    past a task's feasible nodes are (-1, NEG_INF).
    """
    caller = "flex_pick_node_batch_topk"
    kind = _device_kind(caller, est)
    r_task, penalty, cap, w_load, w_src = _check_batch_args(
        caller, est, src_frac, r_task, penalty, cap, w_load, w_src)
    src_frac = src_frac.to(torch.float32)
    if kind == "cpu":
        return pick_node_batch_topk_ref(est, reserved, src_frac, r_task,
                                        penalty, w_load, w_src, cap, k)
    idx, best = flex_score_batch_topk(
        est.contiguous(), reserved.contiguous(), src_frac.contiguous(),
        _task_mat(r_task, penalty, cap, w_load, w_src), k)
    return idx, best, best[:, 0] > NEG_INF / 2
