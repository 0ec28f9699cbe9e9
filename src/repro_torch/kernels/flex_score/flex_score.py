"""Launch wrappers of the hand-written CUDA kernels under ``csrc/``.

``flex_score_pick`` (``csrc/flex_score.cu``) makes one decision;
``flex_score_batch_pick`` and ``flex_score_batch_topk``
(``csrc/flex_score_batch.cu``) score a whole queue.  Each checks its
tensors, allocates the outputs, launches on the current stream and raises
if a launch fails.  None waits for the device.  ``LAUNCHES``,
``BATCH_LAUNCHES`` and ``TOPK_LAUNCHES`` count the kernel launches of
each, so a run can show that its decisions went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
BATCH_LAUNCHES = 0
TOPK_LAUNCHES = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    global LAUNCHES, BATCH_LAUNCHES, TOPK_LAUNCHES
    LAUNCHES = BATCH_LAUNCHES = TOPK_LAUNCHES = 0


def _fn(lib_name: str, fn_name: str, argtypes):
    fn = getattr(_build.load(lib_name), fn_name)
    # Pointers and the stream as c_void_p: left undeclared, ctypes would
    # pass them as 32-bit ints and cut them.
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(caller, name, t, shape, dtype, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{caller}: {name} must be on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{caller}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{caller}: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{caller}: {name} must be contiguous")


def _raise_on(caller, err):
    if err != 0:
        raise RuntimeError(f"{caller}: launch failed with CUDA error {err}")


def flex_score_pick(est: torch.Tensor, reserved: torch.Tensor,
                    src_frac: torch.Tensor, task_vec: torch.Tensor):
    """One decision on the card.

    est/reserved (N, R) f32; src_frac (N,) f32; task_vec (R + 4,) f32
    packed ``[r..., penalty, cap, w_load, w_src]``; all contiguous on one
    CUDA device.  Returns (idx (1,) i32 or -1, best score (1,) f32).
    """
    caller = "flex_score_pick"
    if est.dim() != 2:
        raise ValueError(f"{caller}: est must be (N, R), got "
                         f"{tuple(est.shape)}")
    n, r = est.shape
    device = est.device
    _check(caller, "est", est, (n, r), torch.float32, device)
    _check(caller, "reserved", reserved, (n, r), torch.float32, device)
    _check(caller, "src_frac", src_frac, (n,), torch.float32, device)
    _check(caller, "task_vec", task_vec, (r + 4,), torch.float32, device)
    fn = _fn("flex_score", "flex_score_pick",
             [_PTR] * 4 + [_INT] * 2 + [_PTR] * 3)
    score = torch.empty(1, dtype=torch.float32, device=device)
    idx = torch.empty(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(caller, fn(est.data_ptr(), reserved.data_ptr(),
                         src_frac.data_ptr(), task_vec.data_ptr(), n, r,
                         score.data_ptr(), idx.data_ptr(), stream))
    global LAUNCHES
    LAUNCHES += 1
    return idx, score


def _check_batch(caller, est, reserved, src_frac, task_mat):
    """Shapes (N, R, Q) of a batched call, after checking every tensor."""
    if est.dim() != 2 or task_mat.dim() != 2:
        raise ValueError(f"{caller}: est must be (N, R) and task_mat "
                         f"(Q, R + 4), got {tuple(est.shape)} and "
                         f"{tuple(task_mat.shape)}")
    n, r = est.shape
    q = task_mat.shape[0]
    device = est.device
    _check(caller, "est", est, (n, r), torch.float32, device)
    _check(caller, "reserved", reserved, (n, r), torch.float32, device)
    _check(caller, "src_frac", src_frac, (q, n), torch.float32, device)
    _check(caller, "task_mat", task_mat, (q, r + 4), torch.float32, device)
    lib = _build.load("flex_score_batch")
    if r > lib.flex_score_batch_max_r():
        raise ValueError(f"{caller}: at most "
                         f"{lib.flex_score_batch_max_r()} resources, got {r}")
    return n, r, q


def flex_score_batch_pick(est: torch.Tensor, reserved: torch.Tensor,
                          src_frac: torch.Tensor, task_mat: torch.Tensor):
    """Each queued task's decision on the card, in one launch.

    est/reserved (N, R) f32; src_frac (Q, N) f32; task_mat (Q, R + 4) f32,
    row q packed ``[r..., penalty, cap, w_load, w_src]``; all contiguous on
    one CUDA device.  Returns (idx (Q,) i32 or -1, best score (Q,) f32).
    """
    caller = "flex_score_batch_pick"
    n, r, q = _check_batch(caller, est, reserved, src_frac, task_mat)
    device = est.device
    score = torch.empty(q, dtype=torch.float32, device=device)
    idx = torch.empty(q, dtype=torch.int32, device=device)
    if q == 0:
        return idx, score
    fn = _fn("flex_score_batch", "flex_score_batch_pick",
             [_PTR] * 4 + [_INT] * 3 + [_PTR] * 3)
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(caller, fn(est.data_ptr(), reserved.data_ptr(),
                         src_frac.data_ptr(), task_mat.data_ptr(), n, r, q,
                         score.data_ptr(), idx.data_ptr(), stream))
    global BATCH_LAUNCHES
    BATCH_LAUNCHES += 1
    return idx, score


def flex_score_batch_topk(est: torch.Tensor, reserved: torch.Tensor,
                          src_frac: torch.Tensor, task_mat: torch.Tensor,
                          k: int):
    """Each queued task's ``k`` best nodes on the card.

    Inputs as in :func:`flex_score_batch_pick`.  Returns (idx (Q, k) i32,
    score (Q, k) f32), each row ordered by (score desc, node asc), with
    (-1, NEG_INF) past the task's feasible nodes.  One launch fills 32
    slots; a larger ``k`` takes ``ceil(k / 32)`` launches.
    """
    caller = "flex_score_batch_topk"
    k = int(k)
    if k < 1:
        raise ValueError(f"{caller}: k must be at least 1, got {k}")
    n, r, q = _check_batch(caller, est, reserved, src_frac, task_mat)
    device = est.device
    score = torch.empty((q, k), dtype=torch.float32, device=device)
    idx = torch.empty((q, k), dtype=torch.int32, device=device)
    if q == 0:
        return idx, score
    lib = _build.load("flex_score_batch")
    fn = _fn("flex_score_batch", "flex_score_batch_topk",
             [_PTR] * 4 + [_INT] * 4 + [_PTR] * 3)
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(caller, fn(est.data_ptr(), reserved.data_ptr(),
                         src_frac.data_ptr(), task_mat.data_ptr(), n, r, q,
                         k, score.data_ptr(), idx.data_ptr(), stream))
    global TOPK_LAUNCHES
    TOPK_LAUNCHES += -(-k // lib.flex_score_batch_pass_slots())
    return idx, score
