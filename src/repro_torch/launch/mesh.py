"""Device meshes and the process group under them (port of
``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over ranks 0 .. n-1 of
the default process group, with the reference's axis names and shapes:
one pod is (16, 16) ``("data", "model")``, two pods (2, 16, 16) with
``"pod"`` first.  Functions, not module constants, so importing this
module touches no device and starts no group.

A process has one default group, started by :func:`init_distributed`
when none is running: ``nccl`` on the card, ``gloo`` on the CPU and
``fake`` (a ``FakeStore``: rank 0's view, no peers, no data moved) for
dry runs.  The store is a ``HashStore`` for one rank or a fake group and
a ``FileStore`` otherwise, so no network is touched; under ``torchrun``
(``RANK``/``WORLD_SIZE`` set) its own rendezvous store is taken.  A dry
run over both production meshes starts one 512-rank fake world and draws
the 256-rank mesh from its first 256 ranks.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

POD_AXES = ("pod", "data", "model")


def _backend(device: str) -> str:
    return {"cuda": "nccl", "cpu": "gloo", "fake": "fake"}[device]


def init_distributed(device: str = "cuda", *, world_size: int | None = None,
                     rank: int | None = None,
                     store_path: str | None = None) -> None:
    """Start the default process group unless one is running.

    ``device``: ``"cuda"`` (nccl), ``"cpu"`` (gloo) or ``"fake"``.
    ``world_size`` and ``rank`` default to ``WORLD_SIZE``/``RANK`` from
    the environment (``torchrun`` sets them), else one rank.  Several
    processes on gloo or nccl meet at the ``FileStore`` ``store_path``
    (all must name the same file).
    """
    if dist.is_initialized():
        return
    env = "WORLD_SIZE" in os.environ and world_size is None
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    backend = _backend(device)
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    elif env and world_size > 1:
        dist.init_process_group(backend, init_method="env://",
                                world_size=world_size, rank=rank)
        return
    elif store_path is not None:
        store = dist.FileStore(store_path, world_size)
    elif world_size == 1:
        store = dist.HashStore()
    else:
        raise ValueError("init_distributed: several ranks outside torchrun "
                         "need a FileStore path")
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def make_mesh(shape, axes, *, device: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the first ranks of the default
    group (started with one rank if none is running).

    A mesh larger than the world raises, and so does a CUDA mesh larger
    than ``torch.cuda.device_count()``: no rank shares a card and no
    rank falls back to the CPU.
    """
    n = 1
    for s in shape:
        n *= s
    if device == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"make_mesh: a {'x'.join(map(str, shape))} CUDA "
                         f"mesh needs {n} GPUs, "
                         f"{torch.cuda.device_count()} visible")
    init_distributed(device)
    if n > dist.get_world_size():
        raise ValueError(f"make_mesh: a {'x'.join(map(str, shape))} mesh "
                         f"needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    dev = "cpu" if device == "fake" else device
    return DeviceMesh(dev, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "fake") -> DeviceMesh:
    """One pod (16, 16) ``("data", "model")``, or two (2, 16, 16) with
    ``"pod"`` first.  Its default device is the dry run's fake group."""
    if multi_pod:
        return make_mesh((2, 16, 16), POD_AXES, device=device)
    return make_mesh((16, 16), POD_AXES[1:], device=device)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, *,
                   device: str = "cuda") -> DeviceMesh:
    """A small mesh for tests and ``launch.train --mesh``."""
    if pod:
        return make_mesh((pod, data, model), POD_AXES, device=device)
    return make_mesh((data, model), POD_AXES[1:], device=device)
