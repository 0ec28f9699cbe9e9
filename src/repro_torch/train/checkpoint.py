"""Atomic checkpoints in the reference's on-disk layout.

Port of ``repro.train.checkpoint``.  Layout:

    <dir>/step_<N>/               N as 8 digits
        metadata.json             step, tree structure, leaf shapes and
                                  dtypes, extras
        arr_<i>.npy               one file per leaf (np.save)
    <dir>/step_<N>.tmp.<pid>      staging directory, renamed into place

The staging directory is renamed only after every file in it is synced,
so a writer stopped halfway leaves nothing that ``latest_step`` reads.
Leaves are numbered in the order JAX flattens the tree (dict keys sorted,
list and tuple items in order, ``None`` no leaf), so a checkpoint written
by either package restores in the other.  bfloat16 leaves are stored as
2-byte void records with ``"bfloat16"`` in the metadata, as the
reference's numpy (with ``ml_dtypes``) writes them; no ``ml_dtypes`` is
needed here.

Under a mesh the files hold full tensors all the same: ``save`` gathers
each DTensor leaf (``full_tensor``, on every rank), rank 0 writes, and
the other ranks wait at a barrier.  ``restore`` with ``shardings`` lays
each leaf out by its spec on any mesh, which is what makes a restart
elastic across mesh shapes.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _flatten(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _flatten(item)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(item, leaves) for item in like]
        if hasattr(like, "_fields"):
            return type(like)(*items)
        return type(like)(items)
    return next(leaves)


def _treedef(tree) -> str:
    """The structure as JAX prints a ``PyTreeDef``'s body."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(x) for x in tree) + "]"
    if isinstance(tree, tuple):
        body = ", ".join(_treedef(x) for x in tree)
        return f"({body},)" if len(tree) == 1 else f"({body})"
    return "*"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _sync_write(path: Path, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra: Optional[dict] = None, keep: int = 3) -> Path:
    """Write ``tree`` as checkpoint ``step``; keep the newest ``keep``.

    With DTensor leaves every rank of the default group calls it; rank 0
    writes."""
    leaves = _flatten(tree)
    if any(isinstance(t, DTensor) for t in leaves):
        arrays = [_to_numpy(t) for t in leaves]
        final = Path(ckpt_dir) / f"step_{step:08d}"
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, tree, leaves, arrays, extra, keep)
        dist.barrier()
        return final
    return _write(ckpt_dir, step, tree, leaves, None, extra, keep)


def _write(ckpt_dir, step, tree, leaves, arrays, extra, keep) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp.{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    meta = {"step": step, "treedef": f"PyTreeDef({_treedef(tree)})",
            "n_leaves": len(leaves), "leaves": [], "extra": extra or {}}
    for i, leaf in enumerate(leaves):
        arr = _to_numpy(leaf) if arrays is None else arrays[i]
        dtype = ("bfloat16" if isinstance(leaf, torch.Tensor)
                 and leaf.dtype == torch.bfloat16 else str(arr.dtype))
        meta["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
        _sync_write(tmp / f"arr_{i}.npy", lambda f, a=arr: np.save(f, a))
    _sync_write(tmp / "metadata.json",
                lambda f: f.write(json.dumps(meta).encode()))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
    return final


def all_steps(ckpt_dir: str | Path) -> List[int]:
    """Steps with a complete checkpoint (staging directories excluded)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and "tmp" not in p.name
                  and (p / "metadata.json").exists())


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _leaf_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    # (np.ascontiguousarray makes a 0-d array 1-d: reshape it back)
    if dtype == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return bits.view(torch.bfloat16).reshape(arr.shape).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).reshape(
        arr.shape).to(device)


def restore(ckpt_dir: str | Path, step: int, like: Any,
            shardings: Any = None):
    """Checkpoint ``step`` in the structure of ``like``.

    Each leaf lands on the device of ``like``'s leaf (a tensor; any other
    leaf means the CPU) with the stored dtype; shapes must match.
    ``shardings``: a matching tree of ``sharding.rules.NamedSharding``
    (``None`` where a leaf stays a plain tensor); each such leaf becomes
    a DTensor laid out by it, every rank reading the file and keeping its
    own shards.  Returns (tree, metadata).
    """
    path = Path(ckpt_dir) / f"step_{step:08d}"
    meta = json.loads((path / "metadata.json").read_text())
    like_leaves = _flatten(like)
    if meta["n_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, expected "
            f"{len(like_leaves)}: architecture mismatch?")
    shard_leaves = (_flatten_shardings(shardings, like)
                    if shardings is not None else [None] * len(like_leaves))
    out = []
    for i, (ref, sh) in enumerate(zip(like_leaves, shard_leaves)):
        arr = np.load(path / f"arr_{i}.npy")
        if list(arr.shape) != list(ref.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        device = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        t = _leaf_tensor(arr, meta["leaves"][i]["dtype"], device)
        if sh is not None:
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t, sh.mesh, sh.placements,
                                  src_data_rank=None)
        out.append(t)
    return _unflatten(like, iter(out)), meta


def _flatten_shardings(shardings, like) -> List[Any]:
    """``shardings``'s leaves in ``like``'s leaf order (a ``None`` in
    ``shardings`` stands for a whole subtree of plain leaves)."""
    if shardings is None:
        return [None] * len(_flatten(like))
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in _flatten_shardings(shardings[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for s, item in zip(shardings, like)
                for x in _flatten_shardings(s, item)]
    return [shardings]


def restore_extra(ckpt_dir: str | Path, step: int) -> dict:
    path = Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((path / "metadata.json").read_text())["extra"]
