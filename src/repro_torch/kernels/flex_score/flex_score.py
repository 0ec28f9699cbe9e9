"""Launch wrappers of the hand-written CUDA kernels under ``csrc/``.

``flex_score_pick`` (``csrc/flex_score.cu``) makes one decision;
``flex_score_admit`` (``csrc/flex_score_admit.cu``) admits a whole queue
in order, decision after decision, in one launch;
``flex_score_batch_pick`` and ``flex_score_batch_topk``
(``csrc/flex_score_batch.cu``) score a whole queue.  Each checks its
tensors, allocates the outputs (and the batched kernels' scratch, see
:func:`batch_plan`), launches on the current stream and raises if a launch
fails.  None waits for the device.  ``LAUNCHES``, ``QUEUE_LAUNCHES``,
``BATCH_LAUNCHES`` and ``TOPK_LAUNCHES`` count the kernel launches of
each, so a run can show that its decisions went through the kernels: one
per call of the pick, of the queue kernel and of the argmax, and one per
top-K pass, the merge kernel of a split sweep included.

Each launcher takes a leading run axis: B independent runs, each with its
own node table, decided in the same launch (the pick: one block a run;
the queue kernel: one cluster a run; the sweeps: the runs' tasks in one
grid, each scored against its own run's table).  A call without one is
the B = 1 launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
QUEUE_LAUNCHES = 0
BATCH_LAUNCHES = 0
TOPK_LAUNCHES = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    global LAUNCHES, QUEUE_LAUNCHES, BATCH_LAUNCHES, TOPK_LAUNCHES
    LAUNCHES = QUEUE_LAUNCHES = BATCH_LAUNCHES = TOPK_LAUNCHES = 0


def _declare(fn, argtypes):
    # Pointers and the stream as c_void_p: left undeclared, ctypes would
    # pass them as 32-bit ints and cut them.
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _fn(lib_name: str, fn_name: str, argtypes):
    return _declare(getattr(_build.load(lib_name), fn_name), argtypes)


class _BatchLib(NamedTuple):
    pick: object
    topk: object
    max_r: int        # most resources a task row may have
    pass_slots: int   # slots one top-K pass fills


_BATCH = {}


def _batch_lib() -> _BatchLib:
    """The batched kernels' entry points and constants, looked up once
    per loaded library."""
    lib = _build.load("flex_score_batch")
    found = _BATCH.get(lib)
    if found is None:
        found = _BATCH[lib] = _BatchLib(
            _declare(lib.flex_score_batch_pick,
                     [_PTR] * 4 + [_INT] * 4 + [_PTR] * 5 + [_INT]),
            _declare(lib.flex_score_batch_topk,
                     [_PTR] * 4 + [_INT] * 5 + [_PTR] * 5 + [_INT]),
            lib.flex_score_batch_max_r(), lib.flex_score_batch_pass_slots())
    return found


# The batched sweep's plan: a warp per (task, chunk of the node range),
# WARPS of them a block (kWarps in csrc/flex_score_batch.cu).  A queue that
# cannot keep FILL_WARPS warps streaming (16 on each of the H100's 132
# SMs) has its node range split into chunks of at least MIN_CHUNK nodes
# (two 16-byte loads a lane), at most MAX_SPLITS of them.
WARPS = 8
FILL_WARPS = 16 * 132
MIN_CHUNK = 256
MAX_SPLITS = 32


def batch_plan(n: int, q: int, runs: int = 1):
    """(chunk, splits, blocks) of a batched sweep over ``n`` nodes for
    ``q`` tasks in each of ``runs`` runs: nodes per chunk (a multiple of
    4), chunks per task, and the sweep kernel's blocks.  With ``splits >
    1`` the launcher allocates ``runs * q * splits`` partials and the
    kernel merges them in a second pass."""
    q = q * runs
    splits = max(1, min(-(-FILL_WARPS // q), -(-n // MIN_CHUNK), MAX_SPLITS))
    chunk = -(-n // splits)
    chunk += -chunk % 4
    splits = -(-n // chunk)
    return chunk, splits, -(-q * splits // WARPS)


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


def _runs_view(t: torch.Tensor, dims: int) -> torch.Tensor:
    """``t`` with a leading run axis: as it is when it has one (``dims + 1``
    dimensions), else a (1, ...) view."""
    return t if t.dim() == dims + 1 else t.unsqueeze(0)


def flex_score_pick(est: torch.Tensor, reserved: torch.Tensor,
                    src_frac: torch.Tensor, task_vec: torch.Tensor):
    """One decision on the card.

    est/reserved (N, R) f32; src_frac (N,) f32; task_vec (R + 4,) f32
    packed ``[r..., penalty, cap, w_load, w_src]``; all contiguous on one
    CUDA device.  Returns (idx (1,) i32 or -1, best score (1,) f32).
    With a run axis (est (B, N, R), src_frac (B, N), task_vec (B, R + 4))
    one launch of B blocks decides for every run: (B,) outputs.
    """
    caller = "flex_score_pick"
    if est.dim() not in (2, 3):
        raise ValueError(f"{caller}: est must be (N, R) or (B, N, R), got "
                         f"{tuple(est.shape)}")
    est = _runs_view(est, 2)
    b, n, r = est.shape
    device = est.device
    reserved, src_frac, task_vec = (_runs_view(reserved, 2),
                                    _runs_view(src_frac, 1),
                                    _runs_view(task_vec, 1))
    _check(caller, "est", est, (b, n, r), torch.float32, device)
    _check(caller, "reserved", reserved, (b, n, r), torch.float32, device)
    _check(caller, "src_frac", src_frac, (b, n), torch.float32, device)
    _check(caller, "task_vec", task_vec, (b, r + 4), torch.float32, device)
    fn = _fn("flex_score", "flex_score_pick",
             [_PTR] * 4 + [_INT] * 2 + [_PTR] * 3 + [_INT])
    score = torch.empty(b, dtype=torch.float32, device=device)
    idx = torch.empty(b, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _raise_on(caller, fn(est.data_ptr(), reserved.data_ptr(),
                         src_frac.data_ptr(), task_vec.data_ptr(), n, r,
                         score.data_ptr(), idx.data_ptr(), stream, b))
    global LAUNCHES
    LAUNCHES += 1
    return idx, score


# The queue kernel's plan (csrc/flex_score_admit.cu): one cluster of
# ADMIT_CLUSTER CTAs a run, each holding ceil(N / ADMIT_CLUSTER) node rows in its
# shared memory for the whole queue: est and reserved (8 R bytes a node)
# and n_tasks (4), plus the node's SRC_BUCKETS src_count entries (256) where
# they fit in ADMIT_SMEM beside ADMIT_FIXED_SMEM bytes of the kernel's own.
ADMIT_CLUSTER = 16
ADMIT_MAX_R = 8
ADMIT_SMEM = 232448       # shared memory an H100 block may opt in to
ADMIT_FIXED_SMEM = 640
SRC_BUCKETS = 64          # repro_torch.core.types.NUM_SRC_BUCKETS
_ERR_SHAPE, _ERR_CLUSTER = -1, -2


def admit_plan(n: int, r: int):
    """(rows, src_on_chip, smem) of the queue kernel over ``n`` nodes with
    ``r`` resources: node rows per CTA, whether src_count is held in
    shared memory (else gathered from global memory), and each CTA's
    shared memory in bytes.  Raises ValueError where even the rows of est,
    reserved and n_tasks do not fit."""
    rows = -(-n // ADMIT_CLUSTER)
    table = 8 * r + 4
    on_chip = (ADMIT_FIXED_SMEM + rows * (table + 4 * SRC_BUCKETS)
               <= ADMIT_SMEM)
    smem = ADMIT_FIXED_SMEM + rows * (table
                                      + (4 * SRC_BUCKETS if on_chip else 0))
    if smem > ADMIT_SMEM:
        limit = (ADMIT_SMEM - ADMIT_FIXED_SMEM) // table * ADMIT_CLUSTER
        raise ValueError(
            f"flex_score_admit: at most {limit} nodes at R = {r} (a run's "
            f"node table lives in the shared memory of {ADMIT_CLUSTER} "
            f"CTAs), got {n}")
    return rows, on_chip, smem


_ADMIT = {}


def _admit_fn():
    """The queue kernel's entry point, looked up once per loaded library,
    after checking that the library was built with this plan's
    constants."""
    lib = _build.load("flex_score_admit")
    fn = _ADMIT.get(lib)
    if fn is None:
        built = (lib.flex_score_admit_cluster(), lib.flex_score_admit_max_r())
        want = (ADMIT_CLUSTER, ADMIT_MAX_R)
        if built != want:
            raise RuntimeError(f"flex_score_admit: the library's (cluster, "
                               f"max R) {built} differ from the launcher's "
                               f"{want}")
        fn = _ADMIT[lib] = _declare(lib.flex_score_admit,
                                    [_PTR] * 8 + [_INT] * 6 + [_PTR] * 2
                                    + [_INT])
    return fn


def flex_score_admit(est: torch.Tensor, reserved: torch.Tensor,
                     requested: torch.Tensor, n_tasks: torch.Tensor,
                     src_count: torch.Tensor, task_mat: torch.Tensor,
                     srcs: torch.Tensor, valid: torch.Tensor):
    """A whole queue admitted in order on the card, in one launch.

    est (N, R) f32, read only; reserved and requested (N, R) f32, n_tasks
    (N,) i32 and src_count (N, 64) i32, updated IN PLACE; task_mat (Q,
    R + 4) f32, row q packed ``[r..., penalty, cap, w_load, w_src]``; srcs
    (Q,) i32 in [0, 64) (the kernel clamps others); valid (Q,) bool; all
    contiguous on one CUDA device.  Each decision's src_frac is the Flex
    same-source share ``src_count[:, src] / max(n_tasks, 1)`` of the state
    the earlier decisions left.  Returns placements (Q,) i32, a node or
    -1.  A call with Q > 0 counts one launch in ``QUEUE_LAUNCHES``.

    With a run axis (est (B, N, R), ..., task_mat (B, Q, R + 4), srcs and
    valid (B, Q)) one launch admits every run's queue into its own
    tables, a cluster a run: placements (B, Q).  A run's padding entries
    are invalid.  About 8 clusters of the largest plan are resident on an
    H100 at once; more runs go in waves.
    """
    caller = "flex_score_admit"
    if est.dim() not in (2, 3) or task_mat.dim() != est.dim():
        raise ValueError(f"{caller}: est must be (N, R) and task_mat "
                         f"(Q, R + 4), each with or without a leading run "
                         f"axis, got {tuple(est.shape)} and "
                         f"{tuple(task_mat.shape)}")
    unbatched = est.dim() == 2
    est, reserved, requested, task_mat = (_runs_view(x, 2) for x in (
        est, reserved, requested, task_mat))
    n_tasks, srcs, valid = (_runs_view(x, 1) for x in (n_tasks, srcs,
                                                        valid))
    src_count = _runs_view(src_count, 2)
    b, n, r = est.shape
    q = task_mat.shape[1]
    device = est.device
    for name, t, shape, dtype in (
            ("est", est, (b, n, r), torch.float32),
            ("reserved", reserved, (b, n, r), torch.float32),
            ("requested", requested, (b, n, r), torch.float32),
            ("n_tasks", n_tasks, (b, n), torch.int32),
            ("src_count", src_count, (b, n, SRC_BUCKETS), torch.int32),
            ("task_mat", task_mat, (b, q, r + 4), torch.float32),
            ("srcs", srcs, (b, q), torch.int32),
            ("valid", valid, (b, q), torch.bool)):
        _check(caller, name, t, shape, dtype, device)
    if r > ADMIT_MAX_R:
        raise ValueError(f"{caller}: at most {ADMIT_MAX_R} resources, "
                         f"got {r}")
    if n == 0:
        raise ValueError(f"{caller}: the node table is empty")
    rows, on_chip, smem = admit_plan(n, r)
    placements = torch.empty((b, q), dtype=torch.int32, device=device)
    if q == 0 or b == 0:
        return placements[0] if unbatched else placements
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _admit_fn()(
        est.data_ptr(), reserved.data_ptr(), requested.data_ptr(),
        n_tasks.data_ptr(), src_count.data_ptr(), task_mat.data_ptr(),
        srcs.data_ptr(), valid.data_ptr(), n, r, q, rows, int(on_chip),
        smem, placements.data_ptr(), stream, b)
    if err == _ERR_CLUSTER:
        raise RuntimeError(f"{caller}: a cluster of {ADMIT_CLUSTER} CTAs "
                           f"with {smem} bytes of shared memory each cannot "
                           f"be scheduled on this card")
    if err == _ERR_SHAPE:
        raise RuntimeError(f"{caller}: the kernel does not take the plan "
                           f"(rows={rows}, on_chip={on_chip}, smem={smem})")
    _raise_on(caller, err)
    global QUEUE_LAUNCHES
    QUEUE_LAUNCHES += 1
    return placements[0] if unbatched else placements


def _scratch(q, splits, slots, device):
    """The split sweep's partials (score, node), or None for one chunk."""
    if splits == 1:
        return None, None
    shape = (q, splits, slots)
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_batch(caller, est, reserved, src_frac, task_mat):
    """(est, reserved, src_frac, task_mat) with a leading run axis, and
    the shapes (B, N, R, Q) of a batched call, after checking every
    tensor."""
    if est.dim() not in (2, 3) or task_mat.dim() != est.dim():
        raise ValueError(f"{caller}: est must be (N, R) and task_mat "
                         f"(Q, R + 4), each with or without a leading run "
                         f"axis, got {tuple(est.shape)} and "
                         f"{tuple(task_mat.shape)}")
    est, reserved, src_frac, task_mat = (_runs_view(x, 2) for x in (
        est, reserved, src_frac, task_mat))
    b, n, r = est.shape
    q = task_mat.shape[1]
    device = est.device
    _check(caller, "est", est, (b, n, r), torch.float32, device)
    _check(caller, "reserved", reserved, (b, n, r), torch.float32, device)
    _check(caller, "src_frac", src_frac, (b, q, n), torch.float32, device)
    _check(caller, "task_mat", task_mat, (b, q, r + 4), torch.float32,
           device)
    max_r = _batch_lib().max_r
    if r > max_r:
        raise ValueError(f"{caller}: at most {max_r} resources, got {r}")
    return (est, reserved, src_frac, task_mat), (b, n, r, q)


def flex_score_batch_pick(est: torch.Tensor, reserved: torch.Tensor,
                          src_frac: torch.Tensor, task_mat: torch.Tensor):
    """Each queued task's decision on the card, in one sweep.

    est/reserved (N, R) f32; src_frac (Q, N) f32; task_mat (Q, R + 4) f32,
    row q packed ``[r..., penalty, cap, w_load, w_src]``; all contiguous on
    one CUDA device.  Returns (idx (Q,) i32 or -1, best score (Q,) f32).
    With a run axis (est (B, N, R), src_frac (B, Q, N), task_mat (B, Q,
    R + 4)) one sweep scores every run's queue against its own table:
    (B, Q) outputs.  A sweep whose node range :func:`batch_plan` splits
    runs a second, merging kernel; either way a call counts one launch in
    ``BATCH_LAUNCHES``.
    """
    caller = "flex_score_batch_pick"
    unbatched = est.dim() == 2
    (est, reserved, src_frac, task_mat), (b, n, r, q) = _check_batch(
        caller, est, reserved, src_frac, task_mat)
    device = est.device
    score = torch.empty((b, q), dtype=torch.float32, device=device)
    idx = torch.empty((b, q), dtype=torch.int32, device=device)
    if q * b:
        chunk, splits, _ = batch_plan(n, q, b)
        part_s, part_i = _scratch(b * q, splits, 1, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(caller, _batch_lib().pick(
            est.data_ptr(), reserved.data_ptr(), src_frac.data_ptr(),
            task_mat.data_ptr(), n, r, q, chunk, _ptr(part_s),
            _ptr(part_i), score.data_ptr(), idx.data_ptr(), stream, b))
        global BATCH_LAUNCHES
        BATCH_LAUNCHES += 1
    return (idx[0], score[0]) if unbatched else (idx, score)


def flex_score_batch_topk(est: torch.Tensor, reserved: torch.Tensor,
                          src_frac: torch.Tensor, task_mat: torch.Tensor,
                          k: int):
    """Each queued task's ``k`` best nodes on the card.

    Inputs as in :func:`flex_score_batch_pick`, with or without a run
    axis.  Returns (idx (Q, k) i32, score (Q, k) f32), each row ordered by
    (score desc, node asc), with (-1, NEG_INF) past the task's feasible
    nodes; (B, Q, k) with a run axis.  One pass fills 32 slots; a larger
    ``k`` takes ``ceil(k / 32)`` passes, each counted as one launch in
    ``TOPK_LAUNCHES`` (with the merging kernel of a split sweep, see
    :func:`flex_score_batch_pick`).
    """
    caller = "flex_score_batch_topk"
    k = int(k)
    if k < 1:
        raise ValueError(f"{caller}: k must be at least 1, got {k}")
    unbatched = est.dim() == 2
    (est, reserved, src_frac, task_mat), (b, n, r, q) = _check_batch(
        caller, est, reserved, src_frac, task_mat)
    device = est.device
    score = torch.empty((b, q, k), dtype=torch.float32, device=device)
    idx = torch.empty((b, q, k), dtype=torch.int32, device=device)
    if q * b:
        lib = _batch_lib()
        slots = lib.pass_slots
        chunk, splits, _ = batch_plan(n, q, b)
        part_s, part_i = _scratch(b * q, splits, min(k, slots), device)
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(caller, lib.topk(
            est.data_ptr(), reserved.data_ptr(), src_frac.data_ptr(),
            task_mat.data_ptr(), n, r, q, k, chunk, _ptr(part_s),
            _ptr(part_i), score.data_ptr(), idx.data_ptr(), stream, b))
        global TOPK_LAUNCHES
        TOPK_LAUNCHES += -(-k // slots)
    return (idx[0], score[0]) if unbatched else (idx, score)
