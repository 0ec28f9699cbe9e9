"""Launch wrappers of the hand-written CUDA flash-attention kernels.

``flash_attention_bhsd`` (``csrc/flash_attention.cu``) checks its tensors,
launches on the current stream and raises if the launch fails; it does
not wait for the device.  It takes strided views (only the head dim must
be contiguous) and an optional ``out``, so the model-layout adapter in
``ops.py`` passes (B, S, H, hd) tensors as transposed views without
copying them.  In bfloat16 the kernel reads and writes them by TMA, whose
tensor maps need 16-byte aligned bases and strides: a view that starts
elsewhere or has a stride that is not a multiple of 8 elements raises.
With ``lse`` it also writes each row's float32 log-sum-exp, which the
backward reads.

``flash_attention_bhsd_bwd`` (``csrc/flash_attention_bwd.cu``) takes the
forward's inputs, its output and ``lse`` and the output's gradient, and
writes dq, dk and dv (through strided views too, with the same checks;
its bf16 kernels read q, k, v and dO by TMA as well, through four tensor
maps a call, hence the same alignment rule).  ``LAUNCHES`` counts the
forward's launches and ``BWD_LAUNCHES`` the backward's (one a call of its
three kernels).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
BWD_LAUNCHES = 0
HEAD_DIMS = (32, 64, 80, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = BWD_LAUNCHES = 0


_FN = None
_BWD_FN = None


def _declare(fn, n_ptrs: int, n_strides: int, n_tail: int):
    # Pointers and the stream as c_void_p, strides as 64-bit ints: left
    # undeclared, ctypes would pass them as 32-bit ints and cut them.
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * n_strides
                   + [ctypes.c_void_p] * n_tail)
    fn.restype = ctypes.c_int
    return fn


def _fn():
    """The forward's C entry point, loaded (and built) once: q, k, v, o;
    dtype and the sizes; the strides; lse and the stream."""
    global _FN
    if _FN is None:
        _FN = _declare(_build.load("flash_attention").flash_attention_fwd,
                       4, 12, 2)
    return _FN


def _bwd_fn():
    """The backward's C entry point, loaded (and built) once."""
    global _BWD_FN
    if _BWD_FN is None:
        _BWD_FN = _declare(
            _build.load("flash_attention_bwd").flash_attention_bwd, 10, 24,
            1)
    return _BWD_FN


def _check_views(caller: str, like, named) -> None:
    """Every (name, tensor) on ``like``'s CUDA device in its dtype, unit
    stride along hd, and in bfloat16 16-byte aligned (TMA's rule)."""
    for name, t in named:
        if not t.is_cuda or t.device != like.device:
            raise ValueError(f"{caller}: {name} must be on one CUDA device "
                             f"with q, got {t.device}")
        if t.dtype != like.dtype:
            raise ValueError(f"{caller}: {name} is {t.dtype}, q "
                             f"{like.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{caller}: {name} must be contiguous along "
                             f"the head dim")
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(
                    st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1)):
            raise ValueError(f"{caller}: bfloat16 {name} must start on 16 "
                             f"bytes and have strides of multiples of 8 "
                             f"elements (TMA's rule)")


def _check_lse(caller: str, lse, q) -> None:
    B, H, Sq, _ = q.shape
    if (tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"{caller}: lse must be a contiguous float32 "
                         f"{(B, H, Sq)} on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")


def _shapes(caller: str, q, k, v):
    """(B, H, KV, Sq, Sk, hd) of q (B, H, Sq, hd), k and v (B, KV, Sk,
    hd), checked."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{caller}: q, k, v must be 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, Sk, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{caller}: k and v must be (B, KV, Sk, hd) = "
                         f"{(B, KV, Sk, hd)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{caller}: {H} query heads do not group onto "
                         f"{KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{caller}: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{caller}: dtype must be float32 or bfloat16, "
                         f"got {q.dtype}")
    return B, H, KV, Sq, Sk, hd


def _out(caller: str, name: str, t, shape, like):
    if t is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if tuple(t.shape) != shape:
        raise ValueError(f"{caller}: {name} must be {shape}, got "
                         f"{tuple(t.shape)}")
    return t


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, out=None,
                         lse=None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd).

    All on one CUDA device, float32 or bfloat16 alike, hd in
    ``HEAD_DIMS``, H a multiple of KV, unit stride along hd.  ``out``,
    if given, is a (B, H, Sq, hd) tensor (or view) of q's dtype.
    ``lse``, if given, is a contiguous float32 (B, H, Sq) that receives
    each row's natural log of the sum of exp(s / sqrt(hd)) over the keys
    it attends to (+inf for a row with none).
    """
    caller = "flash_attention_bhsd"
    B, H, KV, Sq, Sk, hd = _shapes(caller, q, k, v)
    out = _out(caller, "out", out, (B, H, Sq, hd), q)
    _check_views(caller, q, (("q", q), ("k", k), ("v", v), ("out", out)))
    if lse is not None:
        _check_lse(caller, lse, q)
    if B * H == 0 or Sq == 0:
        return out
    if Sk == 0:
        raise ValueError(f"{caller}: no keys to attend to")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd, int(bool(causal)),
                int(window), *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *out.stride()[:3],
                None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{caller}: launch failed with CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def flash_attention_bhsd_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                             dq=None, dk=None, dv=None):
    """The gradients (dq, dk, dv) of ``flash_attention_bhsd``'s output
    ``o`` with its ``lse``, given the output's gradient ``do``.

    q, o, do: (B, H, Sq, hd); k, v: (B, KV, Sk, hd); lse: contiguous
    float32 (B, H, Sq); all on one CUDA device, as the forward takes them.
    ``dq``, ``dk``, ``dv``, if given, are tensors (or views) of q's and
    k's shapes and q's dtype; dk and dv are summed over each kv head's
    query heads.
    """
    caller = "flash_attention_bhsd_bwd"
    B, H, KV, Sq, Sk, hd = _shapes(caller, q, k, v)
    dq = _out(caller, "dq", dq, (B, H, Sq, hd), q)
    dk = _out(caller, "dk", dk, (B, KV, Sk, hd), q)
    dv = _out(caller, "dv", dv, (B, KV, Sk, hd), q)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, H, Sq, hd):
            raise ValueError(f"{caller}: {name} must be {(B, H, Sq, hd)}, "
                             f"got {tuple(t.shape)}")
    _check_views(caller, q, (("q", q), ("k", k), ("v", v), ("o", o),
                             ("do", do), ("dq", dq), ("dk", dk),
                             ("dv", dv)))
    _check_lse(caller, lse, q)
    if B * H == 0:
        return dq, dk, dv
    if Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    if Sk == 0:
        raise ValueError(f"{caller}: no keys to attend to")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq, Sk,
        hd, int(bool(causal)), int(window),
        *(st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]),
        stream)
    if err != 0:
        raise RuntimeError(f"{caller}: launch failed with CUDA error {err}")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv
