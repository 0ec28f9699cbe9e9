"""Plain PyTorch versions of the flash-attention kernels (GQA, causal,
sliding window): ``attention_ref`` mirrors
``repro.kernels.flash_attention.ref``; ``attention_lse_ref`` adds the
forward kernel's row log-sum-exp and ``attention_bwd_ref`` is the
backward kernel's function, for holding both kernels against them.

All compute in float32 whatever the input dtype and return the input
dtype (the log-sum-exp in float32).  They materialize the (Sq, Sk) score
matrix: for tests and for holding the kernels against them on the card,
not for long sequences.
"""
from __future__ import annotations

import torch

_NEG = -1e30


def _mask(Sq: int, Sk: int, causal: bool, window: int, device):
    """(Sq, Sk) boolean mask, True = attend; query 0 sits with key 0."""
    pos_q = torch.arange(Sq, device=device)[:, None]
    pos_k = torch.arange(Sk, device=device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= pos_k <= pos_q
    if window > 0:
        m &= pos_k > pos_q - window
    return m


def _scores(q, k, causal, window):
    """Scaled float32 scores (B, KV, G, Sq, Sk) and the mask."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, hd).float() * (hd ** -0.5)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    return s, _mask(Sq, Sk, causal, window, q.device)


def attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd)."""
    B, H, Sq, hd = q.shape
    s, m = _scores(q, k, causal, window)
    p = torch.softmax(torch.where(m, s, _NEG), dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def attention_lse_ref(q, k, v, *, causal=True, window=0):
    """(``attention_ref``'s output, lse): lse (B, H, Sq) float32 is each
    row's natural log of the sum of exp(q.k / sqrt(hd)) over the keys it
    attends to, +inf for a row that attends to none (the kernel's)."""
    B, H, Sq, _ = q.shape
    s, m = _scores(q, k, causal, window)
    lse = torch.logsumexp(torch.where(m, s, float("-inf")), dim=-1)
    lse = torch.where(torch.isneginf(lse), float("inf"), lse)
    return (attention_ref(q, k, v, causal=causal, window=window),
            lse.reshape(B, H, Sq))


def attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0):
    """(dq, dk, dv) of ``attention_ref`` at its output ``o`` and ``lse``
    for the output gradient ``do``, in q's dtype: D = rowsum(do o) from
    o in its own dtype, P = exp(scale S - lse), dV = P^T dO, dP = dO V^T,
    dS = P (dP - D), dQ = scale dS K, dK = scale dS^T Q; dk and dv summed
    over the G query heads of each kv head."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    s, m = _scores(q, k, causal, window)
    lse = lse.reshape(B, KV, G, Sq, 1)
    p = torch.where(m, torch.exp(s - lse), 0.0)
    dof = do.reshape(B, KV, G, Sq, hd).float()
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, v.float())
    delta = (dof * o.reshape(B, KV, G, Sq, hd).float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * scale
    qf = q.reshape(B, KV, G, Sq, hd).float()
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))
