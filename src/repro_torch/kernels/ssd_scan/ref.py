"""Plain PyTorch version of the SSD scan kernel, mirroring
``repro.kernels.ssd_scan.ref``: the sequential recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t (x) x_t ;  y_t = C_t h_t

one step per position, in float32 whatever the input dtype.
"""
from __future__ import annotations

import torch


def ssd_ref(x, B, C, dt, A_log):
    """x: (Bt, S, H, P); B, C: (Bt, S, N); dt: (Bt, S, H) post-softplus.

    Returns (y (Bt, S, H, P), final_state (Bt, H, P, N)), both float32.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    A = -torch.exp(A_log.float())
    xf, Bf, Cf, dtf = x.float(), B.float(), C.float(), dt.float()
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dtf[:, t]                                   # (Bt, H)
        decay = torch.exp(dtt * A)                        # (Bt, H)
        dBx = (dtt[..., None, None] * Bf[:, t, None, None, :]
               * xf[:, t, :, :, None])                    # (Bt, H, P, N)
        h = decay[..., None, None] * h + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bt, 0, H, P), dtype=torch.float32, device=x.device))
    return y, h
