"""Per-node resource allocation via weighted fair share (paper §3).

Port of ``repro.core.allocation``: the three cases of the paper reduce to
two rounds of water-filling, with weights proportional to the request.

  1. sum(d) <= C                 -> a_j = d_j
  2. sum(d) >  C, sum(r) <= C    -> guarantee min(d_j, r_j), then WFS the
                                    remaining capacity over excess demand
  3. sum(d) >  C, sum(r) >  C    -> WFS over requests, then over demand

Segment sums are ``index_add_``.  On the CPU it adds in index order, the
order of the reference's ``jax.ops.segment_sum``, so sums are bit-equal.
On the card it runs under ``torch.use_deterministic_algorithms(True)``,
where PyTorch's implementation adds in an order that does not change from
run to run (the float-atomic default does).
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

_EPS = 1e-9


@contextlib.contextmanager
def _deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn_only)


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num: int) -> torch.Tensor:
    """Sum rows of ``data`` into ``num`` segments by ``seg`` (in [0, num))."""
    out = data.new_zeros((num,) + tuple(data.shape[1:]))
    with _deterministic():
        out.index_add_(0, seg, data)
    return out


def waterfill(node_capacity: torch.Tensor, weights: torch.Tensor,
              caps: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
              num_nodes: int, iters: int = 4) -> torch.Tensor:
    """Weighted progressive filling; returns the (T, R) allocation.

    node_capacity (N, R); weights (T,); caps (T, R); seg (T,) node per
    task, already clipped; mask (T,) 1.0 for live tasks.
    """
    caps = torch.clamp(caps, min=0.0) * mask[:, None]
    w = torch.clamp(weights, min=_EPS) * mask

    total_cap = segment_sum(caps, seg, num_nodes)
    fits_t = (total_cap <= node_capacity + _EPS)[seg]

    alloc = torch.where(fits_t, caps, 0.0)
    remaining_node = node_capacity - segment_sum(alloc, seg, num_nodes)
    for _ in range(iters):
        need = caps - alloc
        unsat = (need > _EPS) & ~fits_t
        w_eff = torch.where(unsat, w[:, None], 0.0)
        w_node = segment_sum(w_eff, seg, num_nodes)
        share = (remaining_node[seg] * w_eff
                 / torch.clamp(w_node[seg], min=_EPS))
        give = torch.minimum(torch.clamp(share, min=0.0), need) * unsat
        alloc = alloc + give
        remaining_node = remaining_node - segment_sum(give, seg, num_nodes)
    return alloc


def wfs_allocate(demand: torch.Tensor, request: torch.Tensor,
                 placement: torch.Tensor, active: torch.Tensor,
                 num_nodes: int, capacity=1.0,
                 iters: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Realized allocation per task (paper §3 'Resource allocation').

    ``capacity`` is a scalar, (N,) or (N, R).  Returns (alloc (T, R),
    node_usage (N, R)).
    """
    mask = active.to(torch.float32)
    seg = torch.where(active, placement, num_nodes - 1)
    seg = torch.clamp(seg, 0, num_nodes - 1)
    r = demand.shape[-1]
    cap = torch.as_tensor(capacity, dtype=torch.float32,
                          device=demand.device)
    if cap.dim() == 1:
        cap = cap[:, None]
    cap_node = torch.broadcast_to(cap, (num_nodes, r))

    weights = torch.clamp(request.max(dim=-1).values, min=_EPS)
    a1 = waterfill(cap_node, weights, torch.minimum(demand, request), seg,
                   mask, num_nodes, iters)
    rem = cap_node - segment_sum(a1, seg, num_nodes)
    a2 = waterfill(rem, weights, demand - a1, seg, mask, num_nodes, iters)

    alloc = (a1 + a2) * mask[:, None]
    return alloc, segment_sum(alloc, seg, num_nodes)
