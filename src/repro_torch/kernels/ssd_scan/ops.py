"""Model-layout adapter of the SSD scan kernel (``repro.kernels.ssd_scan
.ops`` in the port), with the contract of ``models.ssm.ssd_chunked``.

Dispatch follows the tensors' device: CUDA tensors launch the kernel at
any S (or raise), CPU tensors take the plain ``ssd_ref``, as the
reference falls back to it off the TPU.  There is no fallback from one
to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_chunked


def ssd_scan(x, B, C, dt, A_log, chunk: int = 256, *, return_state=False):
    """x: (Bt, S, H, P); B, C: (Bt, S, N); dt: (Bt, S, H) post-softplus.

    Returns y (Bt, S, H, P) in x's dtype and, with ``return_state``, also
    the final state (Bt, H, P, N) in float32.
    """
    if x.is_cuda:
        A = -torch.exp(A_log.float())
        dt = dt.float()
        return ssd_scan_chunked(x, B, C, dt * A, dt, chunk,
                                return_state=return_state)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    y, state = ssd_ref(x, B, C, dt, A_log)
    y = y.to(x.dtype)
    return (y, state) if return_state else y
