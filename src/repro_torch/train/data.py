"""Deterministic synthetic data pipeline (port of ``repro.train.data``).

A seeded, stateless token stream: batch ``i`` is a pure function of
(seed, i), so a job that resumes from step k sees exactly the batches it
would have seen.  The draws are the reference's numpy ``default_rng``
calls in the reference's order, so tokens, labels, ``frames`` (encdec)
and ``patches`` (vlm) are bit-identical to its; they become tensors only
at the end.

Tokens follow a Zipf-ish unigram distribution with a repeated-phrase
structure, so cross-entropy has learnable signal.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
                    index: int, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the stream: int32 ``tokens`` and ``labels`` of
    shape (batch, seq), and float32 ``frames`` (batch, enc_seq, d_model)
    or ``patches`` (batch, n_patches, d_model) for the encdec and vlm
    families, on ``device``."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + index))
    V = cfg.vocab_size
    # zipf-ish unigram over a smallish active vocab + copied phrases
    active = min(V, 1024)
    p = 1.0 / (np.arange(1, active + 1) ** 1.2)
    p /= p.sum()
    toks = rng.choice(active, size=(batch, seq + 1), p=p).astype(np.int32)
    # inject structure: second half of each row repeats the first half
    half = (seq + 1) // 2
    toks[:, half:2 * half] = toks[:, :half]
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            0, 1, (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            0, 1, (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for k, a in out.items()}


def stream(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
           start_index: int = 0, *,
           device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    i = start_index
    while True:
        yield synthetic_batch(cfg, batch, seq, seed, i, device=device)
        i += 1
