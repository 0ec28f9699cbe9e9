"""The reference's float32 rounding, pinned so every device agrees.

The JAX reference runs jitted.  XLA's CPU backend fuses elementwise code
into loops and contracts a multiply feeding an add into ONE fused
multiply-add, rounded once (``p * est + reserved`` becomes
``fma(p, est, reserved)``).  PyTorch rounds the product and the sum
separately.  Where the reference contracts, the port calls :func:`fma`,
which rounds exactly once on every device; the CUDA kernels call
``__fmaf_rn`` at the same places.  ``torch.sqrt`` on CPU float32 is not
correctly rounded (XLA's is), so :func:`sqrt` goes through float64.
"""
from __future__ import annotations

import numpy as np
import torch


def _f64(x):
    """A float32 value widened to float64: a tensor, or a Python float
    (a scalar never becomes a device tensor, which would copy from the
    host and wait)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).double()
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, like a hardware FMA.

    The product of two float32 values is exact in float64.  The float64
    sum is made round-to-odd (TwoSum gives its exact error; an inexact
    result with an even last bit moves one ulp toward the error), and
    round-to-odd at 53 bits followed by round-to-nearest at 24 bits is
    the correctly rounded float32 result.  At least one argument is a
    tensor.
    """
    a, b, c = (_f64(x) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()
