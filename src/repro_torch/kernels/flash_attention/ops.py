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

On ``meta`` tensors (a dry run, ``launch.dryrun``) the model calls the
kernels' stand-ins instead (:func:`flash_attention_stand_in`,
:func:`meta_ops`): custom ops that give the
kernels' outputs (the forward's with the log-sum-exp, the backward's
gradients) and compute nothing, so that ``launch.roofline`` charges the
work the card runs (:data:`META_FLOPS`), not the plain version's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
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


def attention_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: query row r sees keys
    below min(r + 1, Sk) under the causal mask (all Sk without), and
    from r - window + 1 on with a window."""
    r = np.arange(sq, dtype=np.int64)
    hi = np.minimum(r + 1, sk) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(r - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo, 0).sum())


def _flops(q, k, causal, window, per_pair: int) -> int:
    B, S, H, hd = q.shape
    return per_pair * hd * H * B * attention_pairs(S, k.shape[1], causal,
                                                   window)


# op name -> the flops of a call from its arguments (q, k, v, ..., causal,
# window): 4 hd a live pair forward (Q K^T, P V), 10 hd backward (S, dP,
# dV, dK, dQ), as ``chip_smoke.py``'s bounds count them
META_FLOPS = {
    "flash_attention": lambda a: _flops(a[0], a[1], a[3], a[4], 4),
    "flash_attention_bwd": lambda a: _flops(a[0], a[1], a[6], a[7], 10),
}
_META = None


def meta_ops():
    """The forward and backward kernels' stand-ins on ``meta`` tensors,
    the custom ops ``repro_torch::flash_attention(q, k, v, causal,
    window) -> (out, lse)`` and ``repro_torch::flash_attention_bwd(q, k,
    v, out, lse, dout, causal, window) -> (dq, dk, dv)``, the second the
    first's gradient; defined on first use."""
    global _META
    if _META is not None:
        return _META
    lib = "repro_torch::"

    # the ops' bodies serve no device; their fake (meta) versions give
    # the outputs
    @torch.library.custom_op(lib + "flash_attention", mutates_args=())
    def fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
        raise ValueError("repro_torch::flash_attention: meta tensors only")

    @fwd.register_fake
    def _(q, k, v, causal, window):
        B, S, H, _ = q.shape
        return (torch.empty_like(q),
                q.new_empty((B, H, S), dtype=torch.float32))

    @torch.library.custom_op(lib + "flash_attention_bwd", mutates_args=())
    def bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
            causal: bool, window: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        raise ValueError("repro_torch::flash_attention_bwd: meta tensors "
                         "only")

    @bwd.register_fake
    def _(q, k, v, out, lse, dout, causal, window):
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        ctx.save_for_backward(q, k, v, *output)
        ctx.causal, ctx.window = causal, window

    def backward(ctx, dout, _dlse):
        dq, dk, dv = bwd(*ctx.saved_tensors, dout, ctx.causal, ctx.window)
        return dq, dk, dv, None, None

    fwd.register_autograd(backward, setup_context=setup_context)
    _META = fwd
    return _META


def flash_attention_stand_in(q, k, v, *, causal=True, window=0):
    """:func:`flash_attention` on ``meta`` tensors: the kernels'
    stand-ins, differentiable as ``FlashAttention`` is."""
    if not q.is_meta:
        raise ValueError(f"flash_attention_stand_in: meta tensors only, "
                         f"got {q.device}")
    return meta_ops()(q, k, v, causal, window)[0]


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
