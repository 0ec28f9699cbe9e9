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

On ``meta`` tensors (a dry run, ``launch.dryrun``) the model calls the
kernels' stand-ins instead (:func:`ssd_scan_stand_in`,
:func:`meta_ops`): custom ops that give the
kernels' outputs and compute nothing, so that ``launch.roofline``
charges the work the card runs (:data:`META_FLOPS`), not the plain
version's.
"""
from __future__ import annotations

from typing import Tuple

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


def scan_flops(x, B, chunk: int, backward: bool = False) -> int:
    """The products one call needs, as ``chip_smoke.py``'s bounds count
    them.  Forward, per chunk of r rows: the causal half of C B^T, r (r +
    1) N, once for all heads (they share one (B, C) group), and per head
    the causal half of the scores times x, r (r + 1) P, and the two state
    products, 4 r N P.  Backward: the shared r (r + 1) N, and per head
    the causal halves of dy x^T and of the products for dx, dB and dC, r
    (r + 1) (2 P + 2 N), and five (P, N) products over the rows, 10 r P
    N."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    shared = per_head = 0
    for c0 in range(0, s, chunk):
        r = min(chunk, s - c0)
        shared += r * (r + 1) * n
        per_head += (r * (r + 1) * (2 * p + 2 * n) + 10 * r * p * n
                     if backward else r * (r + 1) * p + 4 * r * n * p)
    return b * shared + b * h * per_head


# op name -> the flops of a call from its arguments (x, B, C, a, dt, ...,
# chunk, ...)
META_FLOPS = {
    "ssd_scan": lambda a: scan_flops(a[0], a[1], a[5]),
    "ssd_scan_bwd": lambda a: scan_flops(a[0], a[1], a[6], backward=True),
}
_META = None


def meta_ops():
    """The forward and backward kernels' stand-ins on ``meta`` tensors,
    the custom ops ``repro_torch::ssd_scan(x, B, C, a, dt, chunk,
    return_state) -> (y, state)`` (state (0,) without ``return_state``)
    and ``repro_torch::ssd_scan_bwd(x, B, C, a, dt, dy, chunk) -> (dx, dB,
    dC, da, ddt)``, the second the first's gradient (none into the
    state); defined on first use."""
    global _META
    if _META is not None:
        return _META
    lib = "repro_torch::"

    # the ops' bodies serve no device; their fake (meta) versions give
    # the outputs
    @torch.library.custom_op(lib + "ssd_scan", mutates_args=())
    def fwd(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            a: torch.Tensor, dt: torch.Tensor, chunk: int,
            return_state: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        raise ValueError("repro_torch::ssd_scan: meta tensors only")

    @fwd.register_fake
    def _(x, B, C, a, dt, chunk, return_state):
        Bt, _, H, P = x.shape
        shape = (Bt, H, P, B.shape[-1]) if return_state else (0,)
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                x.new_empty(shape, dtype=torch.float32))

    @torch.library.custom_op(lib + "ssd_scan_bwd", mutates_args=())
    def bwd(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            a: torch.Tensor, dt: torch.Tensor, dy: torch.Tensor, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
        raise ValueError("repro_torch::ssd_scan_bwd: meta tensors only")

    @bwd.register_fake
    def _(x, B, C, a, dt, dy, chunk):
        new = lambda t, dtype: torch.empty(t.shape, dtype=dtype,
                                           device=t.device)
        return (new(x, x.dtype), new(B, x.dtype), new(C, x.dtype),
                new(a, torch.float32), new(dt, torch.float32))

    def setup_context(ctx, inputs, output):
        x, B, C, a, dt, chunk, _ = inputs
        ctx.save_for_backward(x, B, C, a, dt)
        ctx.chunk = chunk

    def backward(ctx, dy, _dstate):
        return (*bwd(*ctx.saved_tensors, dy, ctx.chunk), None, None)

    fwd.register_autograd(backward, setup_context=setup_context)
    _META = fwd
    return _META


def ssd_scan_stand_in(x, B, C, dt, A_log, chunk: int = 256, *,
                      return_state=False):
    """:func:`ssd_scan` on ``meta`` tensors: a and dt as the card's path
    makes them, then the kernels' stand-ins, differentiable as
    ``SSDScan`` is."""
    if not x.is_meta:
        raise ValueError(f"ssd_scan_stand_in: meta tensors only, got "
                         f"{x.device}")
    dt = dt.float()
    a = dt * -torch.exp(A_log.float())
    y, state = meta_ops()(x, B, C, a, dt, chunk, return_state)
    return (y, state) if return_state else y


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
