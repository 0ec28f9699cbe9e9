"""Public wrappers: Flex placement decisions over the node table.

The kernel/policy boundary.  ``flex_pick_node`` makes one decision
(``repro_torch.api.admission.pick_node``); ``flex_admit_queue`` admits a
whole queue in order (the sequential scan,
``repro_torch.api.admission.admit_queue``); ``flex_pick_node_batch``
(each task's argmax) and ``flex_pick_node_batch_topk`` (each task's k
best nodes) score a whole queue in one sweep (wavefront admission,
``repro_torch.api.admission.admit_queue_wavefront``).  Dispatch follows
the tensors' device: CPU tensors take the plain versions (``ref.py``),
CUDA tensors launch the hand-written kernels or raise.

Every wrapper also takes a leading run axis: B independent runs, each
with its own node table (est (B, N, R)) and its own tasks, decided in
one kernel launch (``core.simulator.simulate_runs``).  Then every
per-run argument leads with B, a Python number is shared by the runs,
and every output leads with B.  A call without a run axis is the B = 1
launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flex_score.flex_score import (flex_score_admit,
                                                       flex_score_batch_pick,
                                                       flex_score_batch_topk,
                                                       flex_score_pick)
from repro_torch.kernels.flex_score.ref import (NEG_INF, admit_queue_ref,
                                                pick_node_batch_ref,
                                                pick_node_batch_topk_ref,
                                                pick_node_ref)


def pack_task(r_task, penalty, cap, w_load, w_src, device) -> torch.Tensor:
    """The kernel's (R + 4,) f32 task vector ``[r..., penalty, cap, w_load,
    w_src]``, built on ``device`` from tensors or Python floats; with
    r_task (B, R) the (B, R + 4) vectors of B runs, each scalar (B,) or
    shared."""
    r_task = torch.as_tensor(r_task, dtype=torch.float32, device=device)
    lead = tuple(r_task.shape[:-1])
    parts = [r_task.reshape(lead + (-1,))]
    for x in (penalty, cap, w_load, w_src):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        parts.append(x.reshape(-1) if not lead
                     else x.reshape(x.shape + (1,)).expand(lead + (1,)))
    return torch.cat(parts, dim=-1)


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
    without waiting for the device.  With a run axis (est (B, N, R),
    src_frac (B, N), r_task (B, R), the scalars (B,) or shared) one launch
    decides for every run; the outputs are (B,).
    """
    if _device_kind("flex_pick_node", est) == "cpu":
        return pick_node_ref(est, reserved, src_frac, r_task, penalty,
                             w_load, w_src, cap=cap)
    task_vec = pack_task(r_task, penalty, cap, w_load, w_src, est.device)
    idx, best = flex_score_pick(est.contiguous(), reserved.contiguous(),
                                src_frac.contiguous(), task_vec.contiguous())
    if est.dim() == 2:
        idx, best = idx[0], best[0]
    return idx, best, best > NEG_INF / 2


def flex_admit_queue(est, reserved, requested, n_tasks, src_count, task_mat,
                     srcs, valid):
    """A queue admitted in order, one fused decision and commit per task
    (Alg. 3 lines 3-9 and the placement), each scoring with the Flex
    same-source share of the state the tasks before it left.

    est (N, R) f32; reserved, requested (N, R) f32, n_tasks (N,) i32 and
    src_count (N, 64) i32, updated IN PLACE; task_mat (Q, R + 4) f32 rows
    ``[r..., penalty, cap, w_load, w_src]``; srcs (Q,) i32; valid (Q,)
    bool.  CPU tensors take :func:`admit_queue_ref`; CUDA tensors launch
    the queue kernel once, or raise.  With a run axis every argument leads
    with B: run b admits its own queue into its own tables, all B in one
    launch (placements (B, Q)); a run's padding entries are invalid.

    Returns placements (Q,) i32, a node or -1, without waiting for the
    device.
    """
    args = (est, reserved, requested, n_tasks, src_count, task_mat, srcs,
            valid)
    if _device_kind("flex_admit_queue", est) == "cpu":
        return admit_queue_ref(*args)
    return flex_score_admit(*args)


def _check_batch_args(caller, est, src_frac, r_task, penalty, cap, w_load,
                      w_src):
    """Shape check of the batched wrappers: r_task (Q, R) and src_frac
    (Q, N), or with a run axis (B, Q, R) and (B, Q, N).  Returns (r_task,
    penalty, cap, w_load, w_src) as f32 on est's device, the four scalars
    (shared, (Q,) or (B, Q)) broadcast to (Q,) or (B, Q)."""
    dev = est.device
    lead = tuple(est.shape[:-2])
    r_task = torch.as_tensor(r_task, dtype=torch.float32, device=dev)
    q = r_task.shape[len(lead)] if r_task.dim() > len(lead) else 0
    n, r = est.shape[-2:]
    if (tuple(r_task.shape) != lead + (q, r)
            or tuple(src_frac.shape) != lead + (q, n)):
        raise ValueError(
            f"{caller}: expected r_task {lead + (q, r)} and src_frac "
            f"{lead + (q, n)}, got {tuple(r_task.shape)} and "
            f"{tuple(src_frac.shape)}")

    def bcast(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x.expand(lead + (q,))

    return (r_task,) + tuple(map(bcast, (penalty, cap, w_load, w_src)))


def _task_mat(r_task, penalty, cap, w_load, w_src) -> torch.Tensor:
    """The (..., Q, R + 4) rows ``[r..., penalty, cap, w_load, w_src]``."""
    return torch.cat([r_task, penalty[..., None], cap[..., None],
                      w_load[..., None], w_src[..., None]],
                     dim=-1).contiguous()


def flex_pick_node_batch(est, reserved, src_frac, r_task, penalty, *,
                         w_load, w_src, cap):
    """One batched filter+score+argmax sweep over the whole queue.

    est/reserved (N, R) f32, shared by every task; src_frac (Q, N) f32;
    r_task (Q, R) f32; penalty, w_load, w_src and cap scalars or (Q,).
    Row q equals :func:`flex_pick_node` of task q bit for bit.  With a
    run axis (est (B, N, R), src_frac (B, Q, N), r_task (B, Q, R), the
    scalars (B, Q) or shared) one sweep scores every run's queue
    against its own table; the outputs lead with B.

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

    Arguments as in :func:`flex_pick_node_batch` (with or without a run
    axis), plus ``k``.  Rows are ordered by (score desc, node asc); column
    0 is :func:`flex_pick_node_batch`'s decision.

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
    return idx, best, best[..., 0] > NEG_INF / 2
