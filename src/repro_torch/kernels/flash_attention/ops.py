"""Model-layout adapter of the flash-attention kernel.

Dispatch follows the tensors' device: CUDA tensors launch the kernel
(or raise), CPU tensors take the plain version.  There is no fallback
from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bhsd)
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, S, H, hd); k, v: (B, Sk, KV, hd) -> (B, S, H, hd)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.is_cuda:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        flash_attention_bhsd(qt, kt, vt, causal=causal, window=window,
                             out=out.transpose(1, 2))
        return out
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return attention_ref(qt, kt, vt, causal=causal,
                         window=window).transpose(1, 2)
