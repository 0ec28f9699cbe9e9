"""Mamba2 / SSD (state-space duality) block (port of ``repro.models.ssm``),
arXiv:2405.21060.

Prefill uses the chunked dual form: within a chunk the recurrence is the
quadratic "attention-like" form, across chunks a (B, H, P, N) state is
carried.  On a CUDA tensor ``ssm_apply`` runs it in the hand-written SSD
scan kernel at any sequence length, with or without the cache's final
state, or raises: it never runs a plain version on the card.  Under
autograd the kernel's gradient is the hand-written backward kernel
(``kernels.ssd_scan.ops.SSDScan``).  On the CPU it takes the reference's
``ssd_chunked``, and autograd differentiates it as the reference's
``loss`` differentiates its jnp form.

Decode is the O(1) recurrent update  h <- exp(dt*A) h + dt * B (x) x,
plain PyTorch on every device, as in the reference.

Heads share a single (B, C) group (n_groups = 1), matching mamba2-370m.
``softplus`` is the reference's ``jax.nn.softplus`` (``logaddexp(x, 0)``),
not ``F.softplus``, which returns x itself above 20.

Under a mesh (DTensor activations) the causal conv runs on each
device's own channels and the scan on its own heads
(``layers.heads_local``): x, dt, A_log and y split on the model axis
where the heads divide it, B and C whole.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_stand_in
from repro_torch.models.layers import (heads_local, model_axis_size,
                                       require_kernels)


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_dim) rolling conv input window
    state: torch.Tensor  # (B, H, P, N) SSM state


def ssm_dims(cfg):
    d_inner = cfg.d_inner
    n = cfg.ssm_state
    heads = cfg.ssm_heads
    conv_dim = d_inner + 2 * n           # conv over [x, B, C]
    return d_inner, n, heads, conv_dim


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_init(cfg, gen: torch.Generator):
    """The reference's distributions, drawn from ``gen`` on its device."""
    d = cfg.d_model
    d_inner, n, heads, conv_dim = ssm_dims(cfg)
    dt = getattr(torch, cfg.dtype)
    dev = gen.device

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * scale).to(dt)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        return lo + (hi - lo) * u

    # dt_bias: inverse-softplus of dt ~ U[1e-3, 1e-1]
    u = uniform((heads,), 1e-3, 1e-1)
    dt_bias = u + torch.log(-torch.expm1(-u))
    scale = 1.0 / math.sqrt(d)
    return {
        "wz": normal((d, d_inner), scale),
        "wxbc": normal((d, conv_dim), scale),
        "wdt": normal((d, heads), scale),
        "conv_w": normal((cfg.conv_width, conv_dim), 0.2),
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32, device=dev),
        "A_log": torch.log(uniform((heads,), 1.0, 16.0)),
        "D": torch.ones((heads,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm_w": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": normal((d_inner, d), 1.0 / math.sqrt(d_inner)),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d.  x: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x, dtype=torch.float32)
    for i in range(W):
        out = out + xp[:, i:i + S, :].float() * w[i]
    return (out + b).to(x.dtype)


def _project(p, x):
    return x @ p["wz"], x @ p["wxbc"], x @ p["wdt"]


def _gated_out(cfg, p, y, z):
    # Mamba2 gated RMSNorm: norm(y * silu(z)) then out_proj.
    h = y.float() * F.silu(z.float())
    inv = torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + 1e-5)
    h = (h * inv * p["norm_w"]).to(p["out_proj"].dtype)
    return h @ p["out_proj"]


def ssd_chunked(x, B, C, dt, A_log, chunk: int):
    """Chunked SSD scan (the CPU path), with the reference's chunk length:
    Q halves until it divides S.

    x: (Bt, S, H, P); B, C: (Bt, S, N); dt: (Bt, S, H) (post-softplus).
    Returns (y (Bt, S, H, P) in x's dtype, final_state (Bt, H, P, N)).
    """
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    nc = S // Q

    A = -torch.exp(A_log)                     # (H,) negative
    a = dt * A                                # (Bt, S, H) log-decay per step

    xc = x.reshape(Bt, nc, Q, H, P)
    Bc = B.reshape(Bt, nc, Q, N).float()
    Cc = C.reshape(Bt, nc, Q, N).float()
    ac = a.reshape(Bt, nc, Q, H)
    dtc = dt.reshape(Bt, nc, Q, H)
    # mask BEFORE exp: above-diagonal seg is large-positive and would
    # overflow
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))

    state = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xq, bq, cq = xc[:, c].float(), Bc[:, c], Cc[:, c]
        aq, dq = ac[:, c], dtc[:, c]
        a_cum = torch.cumsum(aq, dim=1)                           # (Bt,Q,H)
        # intra-chunk quadratic form
        cb = torch.einsum("bln,bsn->bls", cq, bq)                 # (Bt,Q,Q)
        seg = a_cum[:, :, None, :] - a_cum[:, None, :, :]         # (Bt,l,s,H)
        decay = torch.exp(torch.where(mask[None, :, :, None], seg, -1e30))
        scores = cb[..., None] * decay * dq[:, None, :, :]        # (Bt,l,s,H)
        y_intra = torch.einsum("blsh,bshp->blhp", scores, xq)
        # inter-chunk contribution from the carried state
        y_inter = torch.exp(a_cum)[..., None] * torch.einsum(
            "bln,bhpn->blhp", cq, state)
        # state update
        tail = torch.exp(a_cum[:, -1:, :] - a_cum)                # (Bt,Q,H)
        dB = (tail * dq)[..., None] * bq[:, :, None, :]           # (Bt,Q,H,N)
        state = (torch.exp(a_cum[:, -1, :])[:, :, None, None] * state
                 + torch.einsum("bshn,bshp->bhpn", dB, xq))
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(Bt, S, H, P)
    return y, state


def ssm_apply(cfg, p, x, with_cache: bool = False):
    """Full-sequence (train/prefill) Mamba2 block.  x: (B, S, D).

    with_cache=True additionally returns the decode cache (rolling conv
    window tail + final SSD state) so prefill is a single pass.
    """
    d_inner, n, heads, _ = ssm_dims(cfg)
    P = cfg.ssm_head_dim
    z, xBC_raw, dt_raw = _project(p, x)
    if isinstance(xBC_raw, DTensor):
        # on each device's own channels: depthwise, so no data moves
        c = 2 if xBC_raw.shape[-1] % model_axis_size(xBC_raw) == 0 else None
        conv = heads_local(
            lambda *a: (_causal_conv(*a),),
            (xBC_raw, p["conv_w"], p["conv_b"]),
            ((c, True), (None if c is None else 1, False),
             (None if c is None else 0, False)), ((c, True),))[0]
    else:
        conv = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xBC = F.silu(conv.float()).to(x.dtype)
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + n]
    Cm = xBC[..., d_inner + n:]
    xh = xs.reshape(*xs.shape[:-1], heads, P)
    if isinstance(xh, DTensor):
        # dt (element-wise) and the scan on each device's own heads
        h = 2 if heads % model_axis_size(xh) == 0 else None
        per_head = (None if h is None else 0, False)
        outs = ((h, True), (None if h is None else 1, True))

        def local(xh, Bm, Cm, dt_raw, dt_bias, A_log):
            dt = softplus(dt_raw.float() + dt_bias)
            return _scan(cfg, xh, Bm, Cm, dt, A_log,
                         with_cache)[:1 + with_cache]

        y, *state = heads_local(
            local, (xh, Bm, Cm, dt_raw, p["dt_bias"], p["A_log"]),
            ((h, True), (None, True), (None, True), (h, True), per_head,
             per_head), outs[:1 + with_cache])
        state = state[0] if with_cache else None
    else:
        dt = softplus(dt_raw.float() + p["dt_bias"])
        y, state = _scan(cfg, xh, Bm, Cm, dt, p["A_log"], with_cache)
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(*x.shape[:-1], d_inner)
    out = _gated_out(cfg, p, y, z)
    if with_cache:
        tail = xBC_raw[:, -(cfg.conv_width - 1):, :]
        return out, SSMCache(conv=tail, state=state)
    return out


def _scan(cfg, xh, Bm, Cm, dt, A_log, with_cache):
    """(y, final state or None): the kernel on the card (on ``meta``
    tensors, a dry run, its stand-in), ``ssd_chunked`` on the CPU."""
    if xh.is_cuda or xh.is_meta:
        # the kernel, at any S; x, B and C go in as views of xBC
        if xh.is_cuda:
            require_kernels("ssm_apply")
        scan = ssd_scan if xh.is_cuda else ssd_scan_stand_in
        out = scan(xh, Bm, Cm, dt, A_log, cfg.ssd_chunk,
                   return_state=with_cache)
        return out if with_cache else (out, None)
    if xh.device.type == "cpu":
        return ssd_chunked(xh, Bm, Cm, dt, A_log, cfg.ssd_chunk)
    raise ValueError(f"ssm_apply: no SSD scan for {xh.device}")


def ssm_cache_init(cfg, batch: int, dtype, *, device="cuda") -> SSMCache:
    d_inner, n, heads, conv_dim = ssm_dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, heads, cfg.ssm_head_dim, n),
                          dtype=torch.float32, device=device))


def ssm_decode(cfg, p, x, cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
    """One-token recurrent step.  x: (B, 1, D)."""
    d_inner, n, heads, conv_dim = ssm_dims(cfg)
    P = cfg.ssm_head_dim
    z, xBC, dt_raw = _project(p, x)

    window = torch.cat([cache.conv, xBC], dim=1)             # (B, W, conv)
    conv_out = torch.einsum("bwc,wc->bc", window.float(),
                            p["conv_w"].float()) + p["conv_b"]
    xBC = F.silu(conv_out)[:, None, :].to(x.dtype)
    new_conv = window[:, 1:, :]

    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + n].float()                # (B,1,N)
    Cm = xBC[..., d_inner + n:].float()
    dt = softplus(dt_raw.float() + p["dt_bias"])              # (B,1,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt[:, 0, :] * A)                        # (B,H)
    xh = xs.reshape(-1, heads, P).float()                     # (B,H,P)
    dBx = (dt[:, 0, :, None, None] * Bm[:, 0, None, None, :]
           * xh[..., None])                                   # (B,H,P,N)
    state = decay[..., None, None] * cache.state + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], state)         # (B,H,P)
    y = y + p["D"][:, None] * xh
    y = y.reshape(x.shape[0], 1, d_inner)
    out = _gated_out(cfg, p, y, z)
    return out, SSMCache(conv=new_conv, state=state)
