"""Launch wrapper of the hand-written CUDA kernel ``csrc/flex_score.cu``.

``flex_score_pick`` checks its tensors, allocates the outputs, launches
one decision on the current stream and raises if the launch fails.  It
never waits for the device.  ``LAUNCHES`` counts its launches, so a run
can show that its decisions went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _lib():
    lib = _build.load("flex_score")
    fn = lib.flex_score_pick
    # Pointers and the stream as c_void_p: left undeclared, ctypes would
    # pass them as 32-bit ints and cut them.
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"flex_score_pick: {name} must be on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"flex_score_pick: {name} must be {dtype}, "
                         f"got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"flex_score_pick: {name} must have shape {shape}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"flex_score_pick: {name} must be contiguous")


def flex_score_pick(est: torch.Tensor, reserved: torch.Tensor,
                    src_frac: torch.Tensor, task_vec: torch.Tensor):
    """One decision on the card.

    est/reserved (N, R) f32; src_frac (N,) f32; task_vec (R + 4,) f32
    packed ``[r..., penalty, cap, w_load, w_src]``; all contiguous on one
    CUDA device.  Returns (idx (1,) i32 or -1, best score (1,) f32).
    """
    if est.dim() != 2:
        raise ValueError(f"flex_score_pick: est must be (N, R), got "
                         f"{tuple(est.shape)}")
    n, r = est.shape
    device = est.device
    _check("est", est, (n, r), torch.float32, device)
    _check("reserved", reserved, (n, r), torch.float32, device)
    _check("src_frac", src_frac, (n,), torch.float32, device)
    _check("task_vec", task_vec, (r + 4,), torch.float32, device)
    fn = _lib()
    score = torch.empty(1, dtype=torch.float32, device=device)
    idx = torch.empty(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(est.data_ptr(), reserved.data_ptr(), src_frac.data_ptr(),
             task_vec.data_ptr(), n, r, score.data_ptr(), idx.data_ptr(),
             stream)
    if err != 0:
        raise RuntimeError(f"flex_score_pick: launch failed with CUDA "
                           f"error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return idx, score
