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


def _f32(x):
    """A tensor as float32, or a Python number rounded to float32 (a
    scalar never becomes a device tensor, which would copy from the host
    and wait)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, like a hardware FMA.

    The product of two float32 values is exact in float64, and so is the
    error ``err`` of the float64 sum ``s`` (TwoSum).  Rounding ``s`` to
    float32 (``r``) is right except where ``s`` lies exactly halfway
    between two float32 values and ``err`` is not zero: then the exact sum
    lies on the error's side, and rounds to the neighbour there.  ``s`` is
    halfway iff its reflection ``2 s - r`` (exact) is itself a float32.
    Element-wise arithmetic alone, so ``torch.func.vmap`` maps it; the
    float32 operands widen inside the float64 operations.  At least one
    argument is a tensor.
    """
    a, b, c = (_f32(x) for x in (a, b, c))
    # Widen the operand with more dimensions: a 0-d tensor takes no part
    # in type promotion against a dimensioned one.
    if isinstance(a, torch.Tensor) and (not isinstance(b, torch.Tensor)
                                        or a.dim() >= b.dim()):
        p = a.double() * b
    elif isinstance(b, torch.Tensor):
        p = b.double() * a
    else:
        p = a * b                       # Python floats: exact
    if not isinstance(p, torch.Tensor) or p.dim() == 0:
        c = c.double() if isinstance(c, torch.Tensor) else c
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    d = s - r
    other = s + d                       # 2 s - r, exact
    near = other.float()
    # s is halfway when near is 2 s - r itself (never at an infinity);
    # then near - r = 2 d, and the exact sum rounds to near when err lies
    # on d's side
    up = ((near - other) == 0) & (err * d > 0)
    return torch.where(up, near, r)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


# The partial width of XLA's CPU tree reduction.
_XLA_WINDOW = 32


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over axis 0, added in the order the reference's
    compiled ``jnp.sum`` adds (XLA's CPU tree-reduction rewrite).

    While the axis is longer than 32, XLA pads it with zeros (half the
    padding in front, the odd one behind) to a multiple of 32 and sums
    each run of 32 in order; the last at most 32 partials are summed in
    order.  Each addition here is one float32 add, so the result is the
    same bits on every device.
    """
    w = _XLA_WINDOW
    while x.shape[0] > w:
        n = x.shape[0]
        pad = (w - n % w) % w
        rest = x.shape[1:]
        x = torch.cat([x.new_zeros((pad // 2,) + rest), x,
                       x.new_zeros((pad - pad // 2,) + rest)])
        x = x.reshape((-1, w) + rest)
        acc = x[:, 0]
        for k in range(1, w):
            acc = acc + x[:, k]
        x = acc
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc
