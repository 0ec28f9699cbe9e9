"""Model-layout adapter of the SSD scan kernel (``repro.kernels.ssd_scan
.ops`` in the port), with the contract of ``models.ssm.ssd_chunked``.

Dispatch follows the tensors' device: CUDA tensors launch the kernel at
any S (or raise), CPU tensors take the plain ``ssd_ref``, as the
reference falls back to it off the TPU.  There is no fallback from one
to the other.

On the card, when autograd records (grad enabled and an input requires a
gradient), the call goes through :class:`SSDScan`, whose backward is the
hand-written backward kernel; otherwise the forward kernel is called
directly.  ``a = dt * A`` and ``A = -exp(A_log)`` stay in PyTorch outside
the Function, so autograd carries da into dt and A_log.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (ssd_scan_chunked,
                                                   ssd_scan_chunked_bwd)


class SSDScan(torch.autograd.Function):
    """``ssd_scan_chunked`` with the backward kernel as its gradient.

    ``forward(x, B, C, a, dt, chunk, return_state)`` returns y, and the
    final state with ``return_state``; the inputs are saved as they come
    (x, B and C may be views of one xBC tensor).  A gradient into the
    final state raises: nothing differentiates through it.
    """

    @staticmethod
    def forward(x, B, C, a, dt, chunk, return_state):
        return ssd_scan_chunked(x, B, C, a, dt, chunk,
                                return_state=return_state)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, B, C, a, dt, chunk, _ = inputs
        ctx.save_for_backward(x, B, C, a, dt)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, *dstate):
        if dstate and dstate[0] is not None:
            raise NotImplementedError(
                "SSDScan: the backward kernel takes no gradient of the "
                "final state; differentiate y only")
        dx, dB, dC, da, ddt = ssd_scan_chunked_bwd(*ctx.saved_tensors, dy,
                                                   ctx.chunk)
        return dx, dB, dC, da, ddt, None, None


def ssd_scan(x, B, C, dt, A_log, chunk: int = 256, *, return_state=False):
    """x: (Bt, S, H, P); B, C: (Bt, S, N); dt: (Bt, S, H) post-softplus.

    Returns y (Bt, S, H, P) in x's dtype and, with ``return_state``, also
    the final state (Bt, H, P, N) in float32.
    """
    if x.is_cuda:
        A = -torch.exp(A_log.float())
        dt = dt.float()
        a = dt * A
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, B, C, a, dt)):
            return SSDScan.apply(x, B, C, a, dt, chunk, return_state)
        return ssd_scan_chunked(x, B, C, a, dt, chunk,
                                return_state=return_state)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    y, state = ssd_ref(x, B, C, dt, A_log)
    y = y.to(x.dtype)
    return (y, state) if return_state else y
