"""Plain PyTorch version of the flash-attention kernel (GQA, causal,
sliding window), mirroring ``repro.kernels.flash_attention.ref``.

Computes in float32 whatever the input dtype and returns the input dtype.
It materializes the (Sq, Sk) score matrix: for tests and for holding the
kernel against it on the card, not for long sequences.
"""
from __future__ import annotations

import torch

_NEG = -1e30


def attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) -> (B, H, Sq, hd)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd).float() * (hd ** -0.5)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    pos_k = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= pos_k <= pos_q
    if window > 0:
        m &= pos_k > pos_q - window
    s = torch.where(m, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)
