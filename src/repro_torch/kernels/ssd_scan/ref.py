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


def split_hi_lo(v, on: bool = True):
    """A float32 operand as the bf16 kernels feed it to the tensor cores:
    the pair (hi, lo) of bf16 values (as float32) whose sum keeps about 16
    bits of ``v``; ``(v,)`` when ``on`` is false."""
    if not on:
        return (v,)
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _mm(eq, comp, other, hilo: bool):
    """``einsum(eq, comp, other)`` with the computed operand ``comp`` split
    into hi + lo when ``hilo``: one product each, summed in float32."""
    out = None
    for part in split_hi_lo(comp, hilo):
        r = torch.einsum(eq, part, other)
        out = r if out is None else out + r
    return out


def ssd_scan_bwd_split(x, B, C, a, dt, dy, chunk: int, heads_per_group: int,
                       *, tile: int = 64, hilo: bool = False):
    """``ssd_scan_bwd_ref``'s gradients by the bf16 CUDA path's split, in
    plain PyTorch (for the tests): chunks of ``chunk`` rows padded to
    ``tile``-row tiles, then

      1. each chunk's local state (w (.) x)^T B and local gradient
         (exp(acum) (.) dy)^T C;
      2. a backward pass over the chunks for D_c and a forward one for S_c,
         and <D_c, S_c>;
      3. per key tile j and group of ``heads_per_group`` heads: the tile
         against the boundary states, then each query tile i >= j: G =
         C_i B_j^T once per pair and group, each head's dyx, M, W and R; dx,
         ddt and dacum's column and state terms of the tile's rows, dB's
         share summed over the group's heads, and the pair's shares of dC
         (R summed over the group's heads first) and of dacum's row part;
      4. the sums over groups and pairs, and da by a reverse sum.

    With ``hilo`` each product of a computed float32 operand (w x, exp(acum)
    dy, S_c, D_c, W, the head sums of R) takes it as a hi + lo bf16 pair
    (``split_hi_lo``), as the tensor cores take it; the other operand
    should then be bf16-valued, as the kernels' inputs are.

    x, dy: (Bt, S, H, P); B, C: (Bt, S, N); a, dt: (Bt, S, H).  Returns
    (dx, dB, dC, da, ddt), float32, of the inputs' shapes.
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    gh = heads_per_group
    G = H // gh
    nc = -(-S // chunk)
    q_pad = -(-chunk // tile) * tile
    nt = q_pad // tile
    dev = x.device
    F = torch.nn.functional

    def chunks(t):   # (Bt, S, ...) -> (Bt, nc, q_pad, ...), zero-padded
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, nc * chunk - S))
        t = t.reshape(Bt, nc, chunk, *t.shape[2:])
        return F.pad(t, (0, 0) * (t.dim() - 3) + (0, q_pad - chunk))

    xc, Bc, Cc, dyc, ac, dtc = map(chunks, (x, B, C, dy, a, dt))
    acum = torch.cumsum(ac, dim=2)                        # (Bt, nc, q, H)
    last = acum[:, :, -1]                                 # (Bt, nc, H)
    e = torch.exp(last[:, :, None] - acum)
    w = e * dtc

    # 1. the chunks' local states and local state gradients
    sloc = _mm("bcshp,bcsn->bchpn", w[..., None] * xc, Bc, hilo)
    dloc = _mm("bclhp,bcln->bchpn", torch.exp(acum)[..., None] * dyc, Cc,
               hilo)
    # 2. the passes: D_c backward, S_c forward
    s_in = torch.zeros((Bt, nc, H, P, N), dtype=torch.float32, device=dev)
    d_out = torch.zeros_like(s_in)
    state = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=dev)
    grad = torch.zeros_like(state)
    for c in reversed(range(nc)):
        d_out[:, c] = grad
        grad = torch.exp(last[:, c])[..., None, None] * grad + dloc[:, c]
    for c in range(nc):
        s_in[:, c] = state
        state = torch.exp(last[:, c])[..., None, None] * state + sloc[:, c]
    sd = (d_out * s_in).sum(dim=(-2, -1))                 # (Bt, nc, H)

    # 3. each key tile and head group
    dx = torch.zeros_like(xc)
    ddt, u, dac = (torch.zeros_like(dtc) for _ in range(3))
    db_part = torch.zeros((Bt, nc, q_pad, G, N), dtype=torch.float32,
                          device=dev)
    dc_part = torch.zeros((Bt, nc, G, nt, nt, tile, N), dtype=torch.float32,
                          device=dev)                     # [.., i, j, l, n]
    rowpart = torch.zeros((Bt, nc, H, nt, nt, tile), dtype=torch.float32,
                          device=dev)                     # [.., i, j, l]
    eye = torch.eye(tile, dtype=torch.bool, device=dev)
    causal = torch.ones((tile, tile), dtype=torch.bool, device=dev).triu()
    for jt in range(nt):
        sj = slice(jt * tile, (jt + 1) * tile)
        Bj, Cj = Bc[:, :, sj], Cc[:, :, sj]
        for grp in range(G):
            hs = slice(grp * gh, (grp + 1) * gh)
            xj, dyj = xc[:, :, sj, hs], dyc[:, :, sj, hs]
            acj, dtj = acum[:, :, sj, hs], dtc[:, :, sj, hs]
            # the boundary states: D_c (keys), S_c (queries)
            V = _mm("bchpn,bcsn->bcshp", d_out[:, :, hs], Bj, hilo)
            dxj = w[:, :, sj, hs, None] * V
            xv = (xj * V).sum(dim=-1)
            XD = _mm("bchpn,bcshp->bcshn", d_out[:, :, hs], xj, hilo)
            dbj = (w[:, :, sj, hs, None] * XD).sum(dim=3)
            eT = torch.exp(acj)[..., None] * _mm(
                "bchpn,bclhp->bclhn", s_in[:, :, hs], dyj, hilo)
            dc_part[:, :, grp, jt, jt] = eT.sum(dim=3)
            di = (eT * Cj[:, :, :, None]).sum(dim=-1)
            colE = torch.zeros_like(acj)
            colOff = torch.zeros_like(acj)
            for it in range(jt, nt):
                si = slice(it * tile, (it + 1) * tile)
                Ci, dyi, aci = Cc[:, :, si], dyc[:, :, si, hs], acum[:, :, si,
                                                                   hs]
                Gt = torch.einsum("bcsn,bcln->bcsl", Bj, Ci)[..., None]
                xy = torch.einsum("bcshp,bclhp->bcslh", xj, dyi)
                diff = aci[:, :, None] - acj[:, :, :, None]   # (.., s, l, h)
                if it == jt:   # masked before the exp
                    diff = torch.where(causal[None, None, :, :, None], diff,
                                       -torch.inf)
                M = torch.exp(diff)
                dts = dtj[:, :, :, None]                      # dt_s
                E = Gt * M * xy
                dxj = dxj + _mm("bcslh,bclhp->bcshp", Gt * M * dts, dyi, hilo)
                Rsum = (xy * M * dts).sum(dim=-1)
                dbj = dbj + _mm("bcsl,bcln->bcsn", Rsum, Ci, hilo)
                dc_part[:, :, grp, it, jt] += _mm("bcsl,bcsn->bcln", Rsum, Bj,
                                                  hilo)
                Eoff = E.masked_fill(eye[None, None, :, :, None], 0.0) \
                    if it == jt else E
                colE = colE + E.sum(dim=3)
                colOff = colOff + Eoff.sum(dim=3)
                rowpart[:, :, hs, it, jt] = (Eoff * dts).sum(dim=2).transpose(
                    2, 3)
            dx[:, :, sj, hs] = dxj
            ddt[:, :, sj, hs] = colE + e[:, :, sj, hs] * xv
            u[:, :, sj, hs] = w[:, :, sj, hs] * xv
            dac[:, :, sj, hs] = di - (dtj * colOff + u[:, :, sj, hs])
            db_part[:, :, sj, grp] = dbj

    # 4. the sums over groups and pairs, and da
    dB = db_part.sum(dim=3)
    dC = torch.zeros_like(Bc)
    for it in range(nt):
        rows = slice(it * tile, (it + 1) * tile)
        dC[:, :, rows] = dc_part[:, :, :, it, :it + 1].sum(dim=(2, 3))
        dac[:, :, rows] += rowpart[:, :, :, it, :it + 1].sum(dim=3).transpose(
            2, 3)
    tail = torch.exp(last) * sd + u.sum(dim=2)            # (Bt, nc, H)
    da = torch.flip(torch.cumsum(torch.flip(dac, [2]), dim=2), [2]) \
        + tail[:, :, None]

    def unchunk(t):
        return t[:, :, :chunk].reshape(Bt, nc * chunk, *t.shape[3:])[:, :S]

    return tuple(map(unchunk, (dx, dB, dC, da, ddt)))
