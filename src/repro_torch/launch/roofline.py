"""Roofline terms of one device's share of a step, for the H100.

The reference derives its terms from TPU HLO with v5e constants.  Here a
dry run records what one device runs (:class:`OpRecorder`): the aten ops
on its local shards, below DTensor, and the c10d functional collectives
DTensor issues to redistribute.  :func:`analyze` applies the reference's
accounting rules to that record:

  * flops: 2 * |result| * K for every matmul (mm, bmm, addmm, baddbmm),
    on the local shapes, so they are per-device flops (a ``FlopCounterMode``
    around DTensor ops would count the global op);
  * bytes: a matmul reads its operands and writes its result; any other
    materialised op costs twice its result bytes; an in-place update of
    an index (``index_copy_``, ``index_put_``, ...) twice its source's;
    views, dtype converts, factories and fills move nothing;
  * collectives: result bytes by kind (all-gather, reduce-scatter,
    all-reduce, all-to-all, ...), also charged as materialised ops;
  * the hand-written kernels: the model runs their stand-ins on ``meta``
    tensors (``repro_torch::flash_attention``, ``::ssd_scan`` and their
    backwards, in ``kernels.*.ops``), each charged with its kernel's
    flops (``META_FLOPS`` there: the products its bound counts) and its
    inputs read and outputs written once.  So the attention and SSD
    terms are those of the path the card runs, not the plain versions'.
    A kernel's scratch is not counted in the peak.

Ops that DTensor's sharding propagation runs on global-shape stand-ins
are not the device's and are left out.  The recorder also tracks the
peak of live local bytes: every storage the device holds (the step's
arguments and each op's new outputs) counts from its first sight until
it is freed.

Hardware (NVIDIA H100 80GB HBM3 SXM at 700 W, the figures
``chip_smoke.py``'s bounds use): 989 TFLOP/s dense bf16, 3.35 TB/s HBM.
One collective bandwidth for every axis, as the reference keeps one:
50 GB/s per GPU, InfiniBand NDR at 400 Gb/s, the link a 16-wide axis
crosses between two 8-GPU nodes.
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12     # bf16 per GPU
HBM_BW = 3.35e12        # bytes/s per GPU
COLL_BW = 50e9          # bytes/s per GPU (InfiniBand NDR 400 Gb/s)

_MATMUL = {"mm": 1, "bmm": 2, "addmm": 1, "baddbmm": 2}  # K: dim of lhs
_MATMUL_LHS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
    "permute_tensor": "collective-permute",
}
_NO_TRAFFIC = {
    "_to_copy", "detach", "alias", "lift_fresh", "lift_fresh_copy",
    "_unsafe_view", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "arange",
    "scalar_tensor", "new_empty", "new_zeros", "new_ones", "new_full",
    "new_empty_strided", "fill_", "zero_", "wait_tensor",
    "_wrap_tensor_autograd", "_local_scalar_dense", "expand", "set_",
}
# in-place updates of an index: op -> position of the source operand
_INDEX_UPDATES = {"index_copy_": 3, "index_put_": 2, "index_add_": 3,
                  "scatter_": 3, "scatter_add_": 3}
_PROPAGATION = {"_propagate_tensor_meta_non_cached", "_propagate_tensor_meta",
                "propagate_op_sharding_non_cached"}


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _kernel_flops():
    """Kernel stand-in op name -> its flops from the call's arguments."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssd_scan import ops as ssd
    return {**flash.META_FLOPS, **ssd.META_FLOPS}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_propagation() -> bool:
    """True inside DTensor's sharding propagation, which runs ops on
    global-shape stand-ins to learn their output metadata."""
    f = sys._getframe(2)
    for _ in range(40):
        if f is None:
            return False
        if f.f_code.co_name in _PROPAGATION:
            return True
        f = f.f_back
    return False


class OpRecorder(TorchDispatchMode):
    """Records the ops one device runs under it (see the module
    docstring): ``records`` holds (op, flops, bytes, collective kind or
    None, collective bytes) per op; ``peak_bytes`` the peak of live local
    bytes.  Start it with :meth:`hold` on the step's arguments."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, float, float, str, float]] = []
        self.live = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}
        self._times = 1

    @contextlib.contextmanager
    def repeat(self, times: int):
        """Count the ops run in the block ``times`` times (a loop's body
        run once, as the reference's accounting multiplies a while loop's
        body by its trip count)."""
        prev, self._times = self._times, self._times * times
        try:
            yield
        finally:
            self._times = prev

    def hold(self, tree) -> int:
        """Count the local storages of ``tree``'s tensors as live; returns
        their bytes."""
        from torch.distributed.tensor import DTensor
        before = self.live
        for t in tree_flatten(tree)[0]:
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._seen:
            return
        n = s.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented        # DTensor runs its local ops here
        out = func(*args, **(kwargs or {}))
        if _in_propagation():
            return out
        name = func.__name__.split(".")[0]
        outs = ([out] if isinstance(out, torch.Tensor) else
                [t for t in tree_flatten(out)[0]
                 if isinstance(t, torch.Tensor)])
        for t in outs:
            self._track(t)
        self.records.append(self._account(func, name, args, outs,
                                          self._times))
        return out

    @staticmethod
    def _account(func, name, args, outs, times):
        res = sum(_nbytes(t) for t in outs)
        flops = byts = coll = 0.0
        kind = None
        if func.namespace == "repro_torch":
            flops = _kernel_flops()[name](args)
            byts = res + sum(_nbytes(a) for a in args
                             if isinstance(a, torch.Tensor))
        elif name in _MATMUL:
            lhs = args[_MATMUL_LHS[name]]
            flops = 2.0 * outs[0].numel() * lhs.shape[_MATMUL[name]]
            byts = res + sum(_nbytes(a) for a in args
                             if isinstance(a, torch.Tensor))
        elif name in _INDEX_UPDATES and len(args) > _INDEX_UPDATES[name]:
            src = args[_INDEX_UPDATES[name]]
            byts = 2.0 * (_nbytes(src) if isinstance(src, torch.Tensor)
                          else res)
        elif name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            coll = res
            byts = 2.0 * res
        elif not (func.is_view or name in _NO_TRAFFIC):
            byts = 2.0 * res
        return (name, times * flops, times * byts, kind, times * coll)


def analyze(records) -> Dict[str, object]:
    """The reference's keys from an :class:`OpRecorder`'s records:
    per-device ``flops``, ``bytes``, ``collective_bytes`` and bytes by
    ``collectives`` kind."""
    flops = byts = 0.0
    coll: Dict[str, float] = {}
    for _, f, b, kind, c in records:
        flops += f
        byts += b
        if kind is not None:
            coll[kind] = coll.get(kind, 0.0) + c
    return {"flops": flops, "bytes": byts,
            "collective_bytes": sum(coll.values()), "collectives": coll}


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_coll_bytes: float,
                   model_flops_global: float, n_chips: int
                   ) -> Dict[str, float]:
    """The reference's formula with the H100's constants."""
    t_compute = per_device_flops / PEAK_FLOPS
    t_memory = per_device_bytes / HBM_BW
    t_coll = per_device_coll_bytes / COLL_BW
    t_bound = max(t_compute, t_memory, t_coll, 1e-12)
    dominant = ("compute" if t_bound == t_compute
                else "memory" if t_bound == t_memory else "collective")
    hlo_flops_global = per_device_flops * n_chips
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bound_s": t_bound,
        "dominant": dominant,
        "model_flops": model_flops_global,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": (model_flops_global / hlo_flops_global
                               if hlo_flops_global else 0.0),
        "mfu_upper_bound": (model_flops_global
                            / (n_chips * PEAK_FLOPS * t_bound)),
    }
