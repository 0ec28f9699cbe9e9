"""int8 gradient all-reduce with error feedback (port of
``repro.train.compression``).

A ring all-reduce of float32 gradients moves ~8 bytes an element a
device; the compressed exchange moves ~2: an int8 all-to-all of chunk
shards, then an int8 all-gather of the reduced chunks.  The quantization
error is carried in an error-feedback buffer added to the next step's
gradient, so SGD and Adam still converge (Seide et al., Tang et al.).

The reference writes it with ``shard_map``; here it is
``torch.distributed`` over the process group of the mesh's ``axis``, on
the card (nccl) or the CPU (gloo).  The wire format is the reference's:
int8 payloads, one float32 scale per payload.

The quantizer is the reference's: ``scale = max(max|x|, 1e-12) / 127``,
round half to even, clip to +-127.  Inside the reference's exchange the
division by 127 is compiled, and XLA makes it a product with the float32
reciprocal; its error-feedback residual divides eagerly.  Both forms are
kept (``reciprocal``), so the int8 payloads are the reference's.  The
reduced chunk adds the peers' dequantized shards one at a time in peer
order and multiplies by the reciprocal of the peer count; where XLA
sums in another order its phase-2 scale can differ by one rounding, so
the output agrees to ~1e-7 of its largest value.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

_INV_127 = float(np.float32(1) / np.float32(127))


def _quantize(x: torch.Tensor, reciprocal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = m * _INV_127 if reciprocal else m / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _axis_group(mesh, axis: str):
    i = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(i), mesh.size(i)


def compressed_allreduce(grad: torch.Tensor, mesh,
                         axis: str = "data") -> torch.Tensor:
    """Mean all-reduce of ``grad`` (each rank's own copy, float32, (n,)
    with n divisible by the axis size) over ``axis`` in int8."""
    group, n_dev = _axis_group(mesh, axis)
    g = grad.reshape(n_dev, -1)
    q, scale = _quantize(g)
    # phase 1: all-to-all -- each rank collects every peer's copy of ITS
    # chunk (int8 on the wire), and every peer's scale
    qs = torch.empty_like(q)
    dist.all_to_all_single(qs, q, group=group)
    scales = torch.empty(n_dev, dtype=scale.dtype, device=scale.device)
    dist.all_gather_into_tensor(scales, scale.reshape(1), group=group)
    acc = torch.zeros(qs.shape[1], dtype=torch.float32, device=grad.device)
    for i in range(n_dev):
        acc = acc + qs[i].float() * scales[i]
    chunk = acc * float(np.float32(1) / np.float32(n_dev))
    # phase 2: re-quantize the reduced chunk, all-gather (int8 on the wire)
    q2, s2 = _quantize(chunk)
    qall = torch.empty(n_dev * q2.numel(), dtype=torch.int8,
                       device=q2.device)
    dist.all_gather_into_tensor(qall, q2, group=group)
    qall = qall.view(n_dev, -1)
    sall = torch.empty(n_dev, dtype=s2.dtype, device=s2.device)
    dist.all_gather_into_tensor(sall, s2.reshape(1), group=group)
    return (qall.float() * sall[:, None]).reshape(-1)


def ef_compress_step(grad: torch.Tensor, error: torch.Tensor, mesh,
                     axis: str = "data"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback compressed sync: (synced gradient, new error)."""
    corrected = grad + error
    synced = compressed_allreduce(corrected, mesh, axis)
    # the local quantization residual becomes next step's correction
    q, s = _quantize(corrected, reciprocal=False)
    new_error = corrected - _dequantize(q, s)
    return synced, new_error
