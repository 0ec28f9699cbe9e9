"""Model-layout adapter of the flash-attention kernel.

Dispatch follows the tensors' device: CUDA tensors launch the kernels (or
raise), CPU tensors take the plain version ``attention_ref``, which
autograd differentiates.  There is no fallback from one to the other.

On the card, when autograd records (grad enabled and an input requires a
gradient), the call goes through :class:`FlashAttention`: its forward
launches the forward kernel with the row log-sum-exp, its backward the
hand-written backward kernel (``csrc/flash_attention_bwd.cu``).
Otherwise the forward kernel is called directly, without the
log-sum-exp, as serving calls it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bhsd, flash_attention_bhsd_bwd)
from repro_torch.kernels.flash_attention.ref import attention_ref


def _forward(q, k, v, causal, window, lse=None):
    """The forward kernel on model-layout tensors, into a new output."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         out=out.transpose(1, 2), lse=lse)
    return out


class FlashAttention(torch.autograd.Function):
    """``flash_attention_bhsd`` with the backward kernel as its gradient.

    ``apply(q, k, v, causal, window)`` takes and returns the model layout
    (q, out (B, S, H, hd); k, v (B, Sk, KV, hd)) and returns the output;
    the inputs are saved as they come (views of the projections), with
    the output and the float32 (B, H, S) log-sum-exp.  Under
    ``torch.utils.checkpoint`` the forward runs again before the backward
    and the saved tensors are its recomputation's: the forward kernel is
    deterministic, so they are the same bits.
    """

    @staticmethod
    def forward(q, k, v, causal, window):
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        return _forward(q, k, v, causal, window, lse), lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            return None, None, None, None, None
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        flash_attention_bhsd_bwd(
            *(t.transpose(1, 2) for t in (q, k, v, out)), lse,
            dout.contiguous().transpose(1, 2), causal=ctx.causal,
            window=ctx.window, dq=dq.transpose(1, 2), dk=dk.transpose(1, 2),
            dv=dv.transpose(1, 2))
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, S, H, hd); k, v: (B, Sk, KV, hd) -> (B, S, H, hd)."""
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal, window)[0]
        return _forward(q, k, v, causal, window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal,
                         window=window).transpose(1, 2)
