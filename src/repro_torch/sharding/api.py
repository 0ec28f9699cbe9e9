"""Context-scoped activation sharding constraints (port of
``repro.sharding.api``).

Model code calls ``constrain(x, "batch", None, None)`` with logical axis
names.  With a mesh set (``set_mesh``/``mesh_context``) and ``x`` a
DTensor, the call redistributes ``x`` to the placements the context's
logical -> mesh mapping gives; with no mesh, or nothing shardable, it
returns ``x`` itself.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

from torch.distributed.tensor import DTensor

from repro_torch.sharding.rules import axis_sizes, placements

_tls = threading.local()


def _axes_map(names) -> dict:
    m = {"model": "model" if "model" in names else None,
         "expert": "model" if "model" in names else None}
    if "pod" in names:
        m["batch"] = ("pod", "data")
    elif "data" in names:
        m["batch"] = "data"
    else:
        m["batch"] = None
    m["data"] = "data" if "data" in names else None
    return m


def set_mesh(mesh, *, shard_batch: bool = True) -> None:
    _tls.mesh = mesh
    _tls.shard_batch = shard_batch


def current_mesh():
    return getattr(_tls, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh, *, shard_batch: bool = True):
    prev = getattr(_tls, "mesh", None)
    prev_sb = getattr(_tls, "shard_batch", True)
    set_mesh(mesh, shard_batch=shard_batch)
    try:
        yield
    finally:
        set_mesh(prev, shard_batch=prev_sb)


def logical_spec(mesh, shape, *logical: Optional[str]):
    """The spec ``constrain`` gives a tensor of ``shape`` on ``mesh``, or
    None where nothing is shardable."""
    sizes = axis_sizes(mesh)
    amap = _axes_map(tuple(sizes))
    axes = []
    for name, dim in zip(logical, shape):
        phys = amap.get(name) if name else None
        if phys is None or (name == "batch"
                            and not getattr(_tls, "shard_batch", True)):
            axes.append(None)
            continue
        size = 1
        for a in ((phys,) if isinstance(phys, str) else phys):
            size *= sizes[a]
        axes.append(phys if dim % size == 0 else None)
    if all(a is None for a in axes):
        # nothing shardable: constraining would force replication (an
        # all-gather), which is never what a no-op intent means
        return None
    return tuple(axes)


def constrain(x, *logical: Optional[str]):
    mesh = getattr(_tls, "mesh", None)
    if mesh is None:
        return x
    spec = logical_spec(mesh, x.shape, *logical)
    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec, mesh))
