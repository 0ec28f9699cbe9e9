"""Model-layout adapter of the flash-attention kernel.

Dispatch follows the tensors' device: CUDA tensors launch the kernel
(or raise), CPU tensors take the plain version.  There is no fallback
from one to the other.  The kernel has no backward yet: a CUDA call that
autograd would record raises :class:`FlashBackwardMissing`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bhsd)
from repro_torch.kernels.flash_attention.ref import attention_ref


class FlashBackwardMissing(RuntimeError):
    """Raised for a CUDA flash-attention call under grad."""


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, S, H, hd); k, v: (B, Sk, KV, hd) -> (B, S, H, hd)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise FlashBackwardMissing(
                "flash_attention: the flash-attention kernel has no "
                "backward kernel yet (ROADMAP.md section 2, 'flash "
                "backward (4b)'); training the attention families on the "
                "card waits for it")
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        flash_attention_bhsd(qt, kt, vt, causal=causal, window=window,
                             out=out.transpose(1, 2))
        return out
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return attention_ref(qt, kt, vt, causal=causal,
                         window=window).transpose(1, 2)
