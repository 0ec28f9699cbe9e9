"""Launch wrapper of the hand-written CUDA chunked SSD scan kernel.

``ssd_scan_chunked`` (``csrc/ssd_scan.cu``) checks its tensors, launches
on the current stream and raises if the launch fails; it does not wait
for the device.  Unlike the reference's pre-chunked Pallas inputs it
takes the model layout and the chunk length, and chunks inside the
kernel: a ragged last chunk is zero-padded there (dt = a = 0 past S, so
the padding changes neither y nor the state).  x, B and C may be strided
views (only the last dim must be contiguous), as the model's slices of
one xBC tensor are; a and dt are made contiguous.  In bfloat16 the views
must start on 16 bytes and have strides of multiples of 8 elements (the
kernels copy 16-byte pieces), and the call runs three kernels on the
stream (chunk states, state passing, chunk scan) over float32 scratch
that this wrapper allocates: the chunks' states (Bt, nc, H, P, N) and
their cumulative decays (Bt, nc, H, q_pad).  ``LAUNCHES`` counts calls,
one per call whatever the number of kernels.

``ssd_scan_chunked_bwd`` (``csrc/ssd_scan_bwd.cu``) is the backward: from
the forward's inputs and dy it returns dx, dB, dC in the inputs' dtype
and da, ddt in float32, over scratch that it allocates
(``bwd_scratch_shapes``: the states entering and the gradients leaving
each chunk, the chunks' cumulative decays, and the shares of dB, dC and
dacum that blocks hand to the last kernel).  It accepts the forward's
shapes and views; float32 runs three CUDA-core kernels per call, bfloat16
four chunk-parallel tensor-core kernels with the heads in groups of
``bwd_heads_per_block``.  ``BWD_LAUNCHES`` counts calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
BWD_LAUNCHES = 0
HEAD_DIMS = (16, 32, 64, 128)
STATE_DIMS = (8, 16, 32, 64, 128)
MAX_CHUNK = 1024
TILE = 64          # rows of the bf16 kernels' tiles; chunks pad to it
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = 0


_FN = _BWD_FN = None


def _fn():
    """The kernel's C entry point, loaded (and built) once."""
    global _FN
    if _FN is not None:
        return _FN
    fn = _build.load("ssd_scan").ssd_scan_fwd
    # Pointers and the stream as c_void_p, strides as 64-bit ints: left
    # undeclared, ctypes would pass them as 32-bit ints and cut them.
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 7 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    _FN = fn
    return fn


def _bwd_fn():
    """The backward's C entry point, loaded (and built) once."""
    global _BWD_FN
    if _BWD_FN is not None:
        return _BWD_FN
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 7
                   + [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _BWD_FN = fn
    return fn


def scratch_shapes(Bt: int, S: int, H: int, P: int, N: int, chunk: int):
    """Shapes of the bf16 path's float32 scratch: the chunks' states and
    their cumulative decays, each chunk padded to a multiple of ``TILE``
    rows."""
    nc = -(-S // chunk)
    q_pad = -(-chunk // TILE) * TILE
    return (Bt, nc, H, P, N), (Bt, nc, H, q_pad)


def _check(x, B, C, a, dt, chunk: int, caller: str) -> None:
    """Raise ValueError for what the kernels do not take."""
    if x.dim() != 4 or B.dim() != 3 or C.dim() != 3:
        raise ValueError(f"{caller}: x must be 4-d and B, C 3-d, got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if tuple(B.shape) != (Bt, S, N) or tuple(C.shape) != (Bt, S, N):
        raise ValueError(f"{caller}: B and C must be (Bt, S, N) = "
                         f"{(Bt, S, N)}, got {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    if tuple(a.shape) != (Bt, S, H) or tuple(dt.shape) != (Bt, S, H):
        raise ValueError(f"{caller}: a and dt must be (Bt, S, H) = "
                         f"{(Bt, S, H)}, got {tuple(a.shape)}, "
                         f"{tuple(dt.shape)}")
    if P not in HEAD_DIMS:
        raise ValueError(f"{caller}: head dim {P} not in {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"{caller}: state dim {N} not in {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{caller}: chunk {chunk} not in 1..{MAX_CHUNK}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{caller}: dtype must be float32 or bfloat16, "
                         f"got {x.dtype}")
    if a.dtype != torch.float32 or dt.dtype != torch.float32:
        raise ValueError(f"{caller}: a and dt must be float32, got "
                         f"{a.dtype}, {dt.dtype}")
    for name, t in (("x", x), ("B", B), ("C", C), ("a", a), ("dt", dt)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{caller}: {name} must be on one CUDA device "
                             f"with x, got {t.device}")
        if name in ("B", "C") and t.dtype != x.dtype:
            raise ValueError(f"{caller}: {name} is {t.dtype}, x {x.dtype}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{caller}: {name} must be contiguous along "
                             f"its last dim")
        if name in ("x", "B", "C") and t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(
                    st % 8 for st, n in zip(t.stride()[:-1], t.shape[:-1])
                    if n > 1)):
            raise ValueError(f"{caller}: bfloat16 {name} must start on 16 "
                             f"bytes and have strides of multiples of 8 "
                             f"elements (the kernels copy 16-byte pieces)")


def ssd_scan_chunked(x, B, C, a, dt, chunk: int, *, return_state=False):
    """x: (Bt, S, H, P); B, C: (Bt, S, N); a = dt * A, dt: (Bt, S, H).

    x, B and C on one CUDA device in one dtype (float32 or bfloat16), P in
    ``HEAD_DIMS``, N in ``STATE_DIMS``, 1 <= chunk <= ``MAX_CHUNK``; a and
    dt float32.  Returns y (Bt, S, H, P) in x's dtype and, with
    ``return_state``, also the final state (Bt, H, P, N) in float32.
    """
    _check(x, B, C, a, dt, chunk, "ssd_scan_chunked")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    a, dt = a.contiguous(), dt.contiguous()
    y = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    state = (torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
             if return_state else None)
    states = acum = None
    if x.dtype == torch.bfloat16:
        states, acum = (torch.empty(shape, dtype=torch.float32,
                                    device=x.device)
                        for shape in scratch_shapes(Bt, S, H, P, N, chunk))
    if Bt * H:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fn()(x.data_ptr(), B.data_ptr(), C.data_ptr(), a.data_ptr(),
                    dt.data_ptr(), y.data_ptr(),
                    None if state is None else state.data_ptr(),
                    _DTYPES[x.dtype], Bt, S, H, P, N, chunk,
                    *x.stride()[:3], *B.stride()[:2], *C.stride()[:2],
                    None if states is None else states.data_ptr(),
                    None if acum is None else acum.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"ssd_scan_chunked: launch failed with CUDA "
                               f"error {err}")
        global LAUNCHES
        LAUNCHES += 1
    return (y, state) if return_state else y


def bwd_heads_per_block(H: int, P: int) -> int:
    """Heads per block of the bf16 backward's key-tile kernel: 4 where
    they fit the registers (P <= 64) and divide H, else 1 (no instance for
    2, which keeps the kernel's build short)."""
    return 4 if P <= 64 and H % 4 == 0 else 1


def bwd_scratch_shapes(Bt: int, S: int, H: int, P: int, N: int,
                       chunk: int, dtype) -> dict:
    """The backward's scratch, by the C entry point's names in its order:
    name -> (shape, dtype).  ``dtype`` is the inputs'."""
    nc = -(-S // chunk)
    q_pad = -(-chunk // TILE) * TILE
    f32 = torch.float32
    if dtype == torch.float32:
        return {"s_in": ((Bt, nc, H, P, N), f32),
                "d_out": ((Bt, nc, H, P, N), f32),
                "acum": ((Bt, nc, H, q_pad), f32), "sd": ((Bt, nc, H), f32),
                "db_h": ((Bt, S, H, N), f32), "dc_h": ((Bt, S, H, N), f32),
                "dac": ((Bt, S, H), f32), "u": ((Bt, S, H), f32)}
    nt = q_pad // TILE
    n_pairs = nt * (nt + 1) // 2
    G = H // bwd_heads_per_block(H, P)
    n_sd = -(-P * N // 2048)     # the chunk pass's tiles of a state
    return {"sloc": ((Bt, nc, H, P, N), f32),
            "dloc": ((Bt, nc, H, P, N), f32),
            "acum": ((Bt, nc, H, q_pad), f32),
            "s_hl": ((Bt, nc, H, 2, P, N), torch.bfloat16),
            "d_hl": ((Bt, nc, H, 2, P, N), torch.bfloat16),
            "sd": ((Bt, nc, H, n_sd), f32),
            "db_part": ((Bt, S, G, N), f32),
            "dc_part": ((Bt, nc, G, n_pairs, TILE, N), f32),
            "rowpart": ((Bt, nc, H, n_pairs, TILE), f32),
            "dac": ((Bt, S, H), f32), "u": ((Bt, S, H), f32)}


def ssd_scan_chunked_bwd(x, B, C, a, dt, dy, chunk: int):
    """The backward of ``ssd_scan_chunked(x, B, C, a, dt, chunk)`` for
    the output gradient ``dy`` (Bt, S, H, P), any strides, in x's dtype.

    Takes the forward's inputs as it takes them (strided views included).
    Returns (dx, dB, dC, da, ddt): fresh contiguous tensors, dx, dB and
    dC in the dtypes of x, B and C, da and ddt float32.
    """
    caller = "ssd_scan_chunked_bwd"
    _check(x, B, C, a, dt, chunk, caller)
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if tuple(dy.shape) != (Bt, S, H, P):
        raise ValueError(f"{caller}: dy must be (Bt, S, H, P) = "
                         f"{(Bt, S, H, P)}, got {tuple(dy.shape)}")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"{caller}: dy must be {x.dtype} on {x.device}, "
                         f"got {dy.dtype} on {dy.device}")
    a, dt, dy = a.contiguous(), dt.contiguous(), dy.contiguous()
    dev = x.device
    dx = torch.empty((Bt, S, H, P), dtype=x.dtype, device=dev)
    dB = torch.empty((Bt, S, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bt, S, N), dtype=x.dtype, device=dev)
    da = torch.empty((Bt, S, H), dtype=torch.float32, device=dev)
    ddt = torch.empty((Bt, S, H), dtype=torch.float32, device=dev)
    if Bt * H * S:
        scratch = [torch.empty(shape, dtype=kind, device=dev)
                   for shape, kind in bwd_scratch_shapes(
                       Bt, S, H, P, N, chunk, x.dtype).values()]
        ptrs = (ctypes.c_void_p * len(scratch))(
            *(t.data_ptr() for t in scratch))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bwd_fn()(x.data_ptr(), B.data_ptr(), C.data_ptr(),
                        a.data_ptr(), dt.data_ptr(), dy.data_ptr(),
                        dx.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                        da.data_ptr(), ddt.data_ptr(),
                        _DTYPES[x.dtype], Bt, S, H, P, N, chunk,
                        bwd_heads_per_block(H, P),
                        *x.stride()[:3], *B.stride()[:2], *C.stride()[:2],
                        ptrs, len(scratch), stream)
        if err != 0:
            raise RuntimeError(f"{caller}: launch failed with CUDA error "
                               f"{err}")
        global BWD_LAUNCHES
        BWD_LAUNCHES += 1
    return dx, dB, dC, da, ddt
