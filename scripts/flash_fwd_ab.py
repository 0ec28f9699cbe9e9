#!/usr/bin/env python3
"""Time the flash-attention forward kernel of two checkouts on one card.

    python3 scripts/flash_fwd_ab.py PARENT_DIR

PARENT_DIR holds an earlier checkout of this repository (e.g. unpacked
with ``git archive <commit> | tar -x -C build/parent``).  The script
builds ``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``
of both checkouts with the port's nvcc flags, loads each with ctypes and
times each on the same bf16 inputs, in turns (parent, this tree, this
tree, parent, ...), replayed from CUDA graphs: the serving path's shapes
(stablelm-3b's prefill, B 1, H 32, hd 80, causal, S 2048 and 4096) and
whisper-medium's encoder and cross attention.  The forward of a checkout
whose entry point takes an ``lse`` pointer before the stream is called
with null, as serving calls it, and once more with a buffer, as training
does (the parent too, when its entry point takes one).  It prints one line a shape with the medians and each round's
times, and the card's name and power limit.  Needs one CUDA card and
nvcc.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
# (label, B, H, KV, Sq, Sk, hd, causal)
SHAPES = (("stablelm-3b prefill S=2048", 1, 32, 32, 2048, 2048, 80, True),
          ("stablelm-3b prefill S=4096", 1, 32, 32, 4096, 4096, 80, True),
          ("whisper-medium encoder", 8, 16, 16, 1500, 1500, 64, False),
          ("whisper-medium cross", 8, 16, 16, 447, 1500, 64, False))
ROUNDS = 5      # each round: parent, tree, tree, parent
INNER = 20      # launches a graph replay


def _load(checkout: Path, tag: str):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out = ROOT / "build" / f"flash_fwd_ab_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(checkout / SRC)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).flash_attention_fwd
    text = (checkout / SRC).read_text()
    with_lse = "void* lse, void* stream" in text
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_void_p] * (2 if with_lse else 1))
    fn.restype = ctypes.c_int
    return fn, with_lse


def _call(fn, with_lse, q, k, v, o, causal, lse=None):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, B, H,
            KV, Sq, Sk, hd, int(causal), 0]
    for t in (q, k, v, o):
        args += list(t.stride()[:3])
    if with_lse:
        args.append(None if lse is None else lse.data_ptr())
    args.append(torch.cuda.current_stream().cuda_stream)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"launch failed with {err}")


def _replay_ms(run) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(INNER):
            run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / INNER


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    parent, tree = _load(Path(sys.argv[1]).resolve(), "parent"), _load(
        ROOT, "tree")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for label, b, h, kv, sq, sk, hd, causal in SHAPES:
        def bshd(n, s):
            return torch.randn((b, s, n, hd), generator=gen, device="cuda"
                               ).to(torch.bfloat16).transpose(1, 2)
        q, k, v, o = bshd(h, sq), bshd(kv, sk), bshd(kv, sk), bshd(h, sq)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
        runs = {"parent": lambda: _call(*parent, q, k, v, o, causal),
                "tree": lambda: _call(*tree, q, k, v, o, causal),
                "tree+lse": lambda: _call(*tree, q, k, v, o, causal, lse)}
        order = ["parent", "tree", "tree+lse", "tree", "parent"]
        if parent[1]:
            runs["parent+lse"] = lambda: _call(*parent, q, k, v, o, causal,
                                               lse)
            order += ["parent+lse", "tree+lse", "parent+lse"]
        times = {name: [] for name in runs}
        for _ in range(ROUNDS):
            for name in order:
                times[name].append(_replay_ms(runs[name]))
        med = {name: statistics.median(ts) for name, ts in times.items()}
        with_lse = (f", with lse {med['tree+lse']:.4f}"
                    + (f" against the parent's {med['parent+lse']:.4f} "
                       f"({med['tree+lse'] / med['parent+lse']:.4f})"
                       if "parent+lse" in med else ""))
        print(f"[flash_fwd_ab] {label}: replayed ms, median of "
              f"{len(times['parent'])}: parent {med['parent']:.4f}, this "
              f"tree {med['tree']:.4f} ({med['tree'] / med['parent']:.4f} "
              f"of the parent){with_lse}; rounds "
              + "; ".join(f"{n} " + " ".join(f"{t:.4f}" for t in ts)
                          for n, ts in times.items()), flush=True)
    print(f"[flash_fwd_ab] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
