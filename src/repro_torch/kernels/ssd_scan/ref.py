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


def ssd_scan_bwd_ref(x, B, C, a, dt, dy, chunk: int):
    """The backward of the chunked SSD scan with ``a`` and ``dt`` as
    separate inputs (``ssd_scan_chunked``'s contract), in plain PyTorch:
    the formulas the CUDA backward kernel computes, over the split of
    ``ssd_three_pass`` (chunks of ``chunk`` rows, the ragged last one
    zero-padded at dt = a = 0), all in float32.

    Per chunk, with acum the within-chunk cumulative sum of a, L its last
    row, S_c the state entering chunk c and D_c the gradient of the state
    leaving it (zero after the last chunk, then carried back as
    D_{c-1} = exp(acum_L) D_c + sum_l exp(acum_l) dy_l C_l^T):

      G = C B^T, M_ls = exp(acum_l - acum_s) (s <= l, masked before the
      exp), dyx_ls = dy_l . x_s, e_s = exp(acum_L - acum_s):
      dx_s  = sum_l G M dt_s dy_l + e_s dt_s D B_s
      ddt_s = sum_l G M dyx + e_s x_s . (D B_s)
      dB_s  = sum_h [sum_l dyx M dt_s C_l + e_s dt_s x_s^T D]
      dC_l  = sum_h [sum_s dyx M dt_s B_s + exp(acum_l) dy_l^T S_c]
      d acum, then da by a reverse cumulative sum over the chunk.

    x, dy: (Bt, S, H, P); B, C: (Bt, S, N); a, dt: (Bt, S, H).  Returns
    (dx, dB, dC, da, ddt), float32, of the inputs' shapes.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(t):   # (Bt, S, ...) -> (Bt, nc, chunk, ...), zero-padded
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(Bt, nc, chunk, *t.shape[2:])

    xc, Bc, Cc, dyc = chunks(x), chunks(B), chunks(C), chunks(dy)
    ac, dtc = chunks(a), chunks(dt)
    acum = torch.cumsum(ac, dim=2)                        # (Bt, nc, Q, H)
    last = acum[:, :, -1]                                 # (Bt, nc, H)
    e = torch.exp(last[:, :, None] - acum)                # e_s
    w = e * dtc

    # states entering each chunk, and the gradients leaving each chunk
    local = torch.einsum("bcsh,bcshp,bcsn->bchpn", w, xc, Bc)
    dloc = torch.einsum("bclh,bclhp,bcln->bchpn", torch.exp(acum), dyc, Cc)
    s_in = torch.zeros((Bt, nc, H, P, N), dtype=torch.float32,
                       device=x.device)
    d_out = torch.zeros_like(s_in)
    state = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    grad = torch.zeros_like(state)
    for c in range(nc):
        s_in[:, c] = state
        state = torch.exp(last[:, c])[..., None, None] * state + local[:, c]
    for c in reversed(range(nc)):
        d_out[:, c] = grad
        grad = torch.exp(last[:, c])[..., None, None] * grad + dloc[:, c]

    # intra-chunk terms
    G = torch.einsum("bcln,bcsn->bcls", Cc, Bc)[..., None]   # (.., l, s, 1)
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]   # (.., l, s, H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    M = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                              -torch.inf))
    dyx = torch.einsum("bclhp,bcshp->bclsh", dyc, xc)
    dts = dtc[:, :, None]                                  # dt_s
    E = G * M * dyx
    R = dyx * M * dts
    dx = torch.einsum("bclsh,bclhp->bcshp", G * M * dts, dyc)
    ddt = E.sum(dim=2)
    dB = torch.einsum("bclsh,bcln->bcsn", R, Cc)
    dC = torch.einsum("bclsh,bcsn->bcln", R, Bc)
    Edt = E * dts
    dacum = Edt.sum(dim=3) - Edt.sum(dim=2)

    # the state entering the chunk (inter-chunk term of y)
    SC = torch.einsum("bclhp,bchpn->bclhn", dyc, s_in)
    eSC = torch.exp(acum)[..., None] * SC
    dC = dC + eSC.sum(dim=3)
    dacum = dacum + torch.einsum("bclhn,bcln->bclh", eSC, Cc)

    # the state leaving the chunk
    V = torch.einsum("bchpn,bcsn->bcshp", d_out, Bc)       # D B_s
    xV = (xc * V).sum(dim=-1)
    dx = dx + w[..., None] * V
    ddt = ddt + e * xV
    dB = dB + torch.einsum("bcsh,bcshp,bchpn->bcsn", w, xc, d_out)
    u = w * xV
    dacum = dacum - u
    tail = (torch.exp(last) * (d_out * s_in).sum(dim=(-2, -1))
            + u.sum(dim=2))                                # (Bt, nc, H)
    da = torch.flip(torch.cumsum(torch.flip(dacum, [2]), dim=2), [2]) \
        + tail[:, :, None]

    def unchunk(t):
        return t.reshape(Bt, nc * chunk, *t.shape[3:])[:, :S]

    return (unchunk(dx), unchunk(dB), unchunk(dC), unchunk(da),
            unchunk(ddt))
