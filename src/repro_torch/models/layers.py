"""Neural-net building blocks (port of ``repro.models.layers``).

Plain functions on tensors.  Attention comes in two plain versions:

  * ``naive_attention``: materializes the (Sq, Sk) score matrix; used for
    short sequences and as the test oracle;
  * ``chunked_attention``: online softmax over KV chunks, O(S) memory.

On a CUDA tensor ``chunked_attention`` launches the hand-written
flash-attention kernel for every sequence length (the kernel masks the
ragged tail itself) or raises: it never runs the plain versions on the
card.  On the CPU it takes the reference's CPU branches.  Scores are
taken in float32 whatever the input dtype, as the reference's
``preferred_element_type=jnp.float32`` einsums take them.

``kernels_allowed``/``no_kernels`` keep the reference's names and its
thread-local flag.  A CPU tensor takes the plain version whatever the
flag; on a CUDA tensor inside ``no_kernels()``, ``chunked_attention``
and ``models.ssm.ssm_apply`` raise, since the card has no plain path.
The reference's ``loss`` enters ``no_kernels()`` because its Pallas
kernels have no VJP; the port's ``loss`` does not: its SSD scan and its
flash attention carry their own backward kernels
(``kernels.ssd_scan.ops.SSDScan``,
``kernels.flash_attention.ops.FlashAttention``).
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

_NEG = -1e30

_tls = threading.local()


def kernels_allowed() -> bool:
    return getattr(_tls, "kernels_ok", True)


@contextlib.contextmanager
def no_kernels():
    prev = getattr(_tls, "kernels_ok", True)
    _tls.kernels_ok = False
    try:
        yield
    finally:
        _tls.kernels_ok = prev


def require_kernels(caller: str) -> None:
    """Raise inside ``no_kernels()``: a CUDA tensor has only its kernel."""
    if not kernels_allowed():
        raise RuntimeError(f"{caller}: a CUDA tensor inside no_kernels(); "
                           f"the card has no plain path")


# --------------------------------------------------------------------------
# initialization helpers (torch.Generator draws: other numbers than the
# reference's jax.random for the same seed)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-5):
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * w).to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


def norm_init(cfg, d: int, device):
    ones = torch.ones((d,), dtype=torch.float32, device=device)
    if cfg.norm == "layernorm":
        return {"w": ones, "b": torch.zeros_like(ones)}
    return {"w": ones}


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope(x, positions, theta: float, frac: float = 1.0):
    """RoPE on x (..., S, H, hd) at positions (..., S).

    ``frac`` rotates only the first frac * hd dims (chatglm 0.5, stablelm
    0.25); the rest pass through.
    """
    hd = x.shape[-1]
    rot = int(hd * frac)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.cat([y1, y2], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < hd else out


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _mask(pos_q, pos_k, causal: bool, window: int):
    """(Sq, Sk) boolean mask: True = attend."""
    dq = pos_q[:, None]
    dk = pos_k[None, :]
    m = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool,
                   device=pos_q.device)
    if causal:
        m &= dk <= dq
    if window > 0:
        m &= dk > dq - window
    return m


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Oracle attention.  q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd) * (hd ** -0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    pos_q = q_offset + torch.arange(Sq, device=q.device)
    pos_k = torch.arange(Sk, device=q.device)
    s = torch.where(_mask(pos_q, pos_k, causal, window), s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      q_chunk=1024, kv_chunk=1024):
    """Online-softmax attention, O(S) memory.

    A CUDA tensor goes to the flash-attention kernel at any length; the
    kernel has no query offset, so ``q_offset != 0`` raises there.
    Otherwise the reference's algorithm: naive below one query chunk or
    for ragged lengths, else a loop over query chunks, each scanning only
    the KV chunks that are not fully masked.
    """
    if q.is_cuda:
        require_kernels("chunked_attention")
        if q_offset:
            raise ValueError(f"chunked_attention: the flash-attention "
                             f"kernel takes no query offset, got "
                             f"q_offset={q_offset}")
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal=causal, window=window)

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if Sq % q_chunk or Sk % kv_chunk or Sq <= q_chunk:
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)

    qg = q.reshape(B, Sq, KV, G, hd) * (hd ** -0.5)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    kc = k.reshape(B, nk, kv_chunk, KV, hd)
    vc = v.reshape(B, nk, kv_chunk, KV, hd)
    blocks = []
    for i in range(nq):
        qi = qg[:, i * q_chunk:(i + 1) * q_chunk].float()
        pos_q = q_offset + i * q_chunk + torch.arange(q_chunk,
                                                      device=q.device)
        m_run = torch.full((B, KV, G, q_chunk), _NEG, device=q.device)
        l_run = torch.zeros((B, KV, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, hd), device=q.device)
        # causal: kv chunks beyond the diagonal are fully masked -> skip;
        # sliding window additionally bounds how far back we look.
        lo, hi = 0, nk
        if causal:
            hi = min(i + 1, nk)
            if window > 0:
                lo = max(0, (i * q_chunk + q_chunk - window) // kv_chunk)
        for j in range(lo, hi):
            kj, vj = kc[:, j], vc[:, j]
            s = torch.einsum("bqkgd,bckd->bkgqc", qi, kj.float())
            pos_k = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
            s = torch.where(_mask(pos_q, pos_k, causal, window), s, _NEG)
            m_new = torch.maximum(m_run, s.max(dim=-1).values)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vj.dtype).float(),
                              vj.float())
            acc = acc * corr[..., None] + pv
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        blocks.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd))
    return torch.cat(blocks, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0):
    """Single-position attention against a padded KV cache.

    q: (B,1,H,hd); caches: (B,Smax,KV,hd); cache_len: () int tensor, the
    new token's position (keys at positions <= cache_len attend).  No
    kernel: plain PyTorch on every device, as in the reference.
    """
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd) * (hd ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    pos_k = torch.arange(Smax, device=q.device)
    valid = pos_k <= cache_len
    if window > 0:
        valid &= pos_k > cache_len - window
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_init(cfg, gen: torch.Generator, d: int, d_ff: int):
    dt = getattr(torch, cfg.dtype)
    if cfg.act == "swiglu":
        return {"wg": dense_init(gen, d, d_ff, dt),
                "wu": dense_init(gen, d, d_ff, dt),
                "wd": dense_init(gen, d_ff, d, dt)}
    return {"w1": dense_init(gen, d, d_ff, dt),
            "w2": dense_init(gen, d_ff, d, dt)}


def mlp_apply(cfg, p, x):
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
        return h @ p["wd"]
    h = x @ p["w1"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h, approximate="tanh") if cfg.act == "gelu" \
        else torch.square(F.relu(h))
    return h @ p["w2"]
