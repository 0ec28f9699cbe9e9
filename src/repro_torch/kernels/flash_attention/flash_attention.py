"""Launch wrapper of the hand-written CUDA flash-attention kernel.

``flash_attention_bhsd`` (``csrc/flash_attention.cu``) checks its tensors,
launches on the current stream and raises if the launch fails; it does
not wait for the device.  It takes strided views (only the head dim must
be contiguous) and an optional ``out``, so the model-layout adapter in
``ops.py`` passes (B, S, H, hd) tensors as transposed views without
copying them.  In bfloat16 the kernel reads and writes them by TMA, whose
tensor maps need 16-byte aligned bases and strides: a view that starts
elsewhere or has a stride that is not a multiple of 8 elements raises.
``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
HEAD_DIMS = (32, 64, 80, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


_FN = None


def _fn():
    """The kernel's C entry point, loaded (and built) once."""
    global _FN
    if _FN is not None:
        return _FN
    fn = _build.load("flash_attention").flash_attention_fwd
    # Pointers and the stream as c_void_p, strides as 64-bit ints: left
    # undeclared, ctypes would pass them as 32-bit ints and cut them.
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _FN = fn
    return fn


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, out=None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd).

    All on one CUDA device, float32 or bfloat16 alike, hd in
    ``HEAD_DIMS``, H a multiple of KV, unit stride along hd.  ``out``,
    if given, is a (B, H, Sq, hd) tensor (or view) of q's dtype.
    """
    caller = "flash_attention_bhsd"
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
    if out is None:
        out = torch.empty((B, H, Sq, hd), dtype=q.dtype, device=q.device)
    elif tuple(out.shape) != (B, H, Sq, hd):
        raise ValueError(f"{caller}: out must be {(B, H, Sq, hd)}, got "
                         f"{tuple(out.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{caller}: {name} must be on one CUDA device "
                             f"with q, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{caller}: {name} is {t.dtype}, q {q.dtype}")
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
    if B * H == 0 or Sq == 0:
        return out
    if Sk == 0:
        raise ValueError(f"{caller}: no keys to attend to")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd, int(bool(causal)),
                int(window), *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *out.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"{caller}: launch failed with CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
