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


def ssd_three_pass(x, B, C, dt, A_log, chunk: int):
    """The CUDA bf16 path's split, in plain PyTorch (for the tests): chunk
    states, then state passing, then chunk scan (arXiv:2405.21060 sections
    6-7), at a fixed chunk length with the ragged last chunk zero-padded
    (dt = 0 there: decay 1, no input).

    x: (Bt, S, H, P); B, C: (Bt, S, N); dt: (Bt, S, H) post-softplus.
    Returns (y (Bt, S, H, P), final_state (Bt, H, P, N)), both float32.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    A = -torch.exp(A_log.float())

    def chunks(t):   # (Bt, S, ...) -> (Bt, nc, chunk, ...), zero-padded
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(Bt, nc, chunk, *t.shape[2:])

    xc, Bc, Cc, dtc = chunks(x), chunks(B), chunks(C), chunks(dt)
    acum = torch.cumsum(dtc * A, dim=2)                   # (Bt, nc, Q, H)
    last = acum[:, :, -1]                                 # (Bt, nc, H)

    # 1. chunk states: x^T (w (.) B), w_s = exp(acum_last - acum_s) dt_s
    w = torch.exp(last[:, :, None] - acum) * dtc
    local = torch.einsum("bcsh,bcshp,bcsn->bchpn", w, xc, Bc)

    # 2. state passing: the state carried into each chunk, and the last
    s_in = torch.zeros((Bt, nc, H, P, N), dtype=torch.float32,
                       device=x.device)
    state = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    for c in range(nc):
        s_in[:, c] = state
        state = torch.exp(last[:, c])[..., None, None] * state + local[:, c]

    # 3. chunk scan: (C B^T o decay o dt_s) x + exp(acum_l) C s_in^T, the
    # decay masked (s <= l) before the exp
    G = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]   # (.., l, s, H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    diff = torch.where(causal[None, None, :, :, None], diff, -torch.inf)
    scores = G[..., None] * torch.exp(diff) * dtc[:, :, None]
    y = torch.einsum("bclsh,bcshp->bclhp", scores, xc)
    y = y + torch.exp(acum)[..., None] * torch.einsum("bcln,bchpn->bclhp",
                                                      Cc, s_in)
    return y.reshape(Bt, nc * chunk, H, P)[:, :S], state
