#!/usr/bin/env python3
"""Time builds of the flash-attention backward kernels against each other
on one card.

    python3 scripts/flash_bwd_ab.py SOURCE [SOURCE ...]

Each SOURCE is an earlier checkout of this repository (e.g. unpacked with
``git archive <commit> | tar -x -C build/parent``) or a variant of
``flash_attention_bwd.cu`` (a file beside the headers it includes).  The
script builds each one's
``src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu``,
and this tree's, with the port's nvcc flags, and loads each with ctypes.
It holds each build against ``attention_bwd_ref`` on small masked cases
(every head dim, ragged, windowed, Sq != Sk, GQA; bf16 within 2e-2 of
max(1, |plain|), two calls bit-equal) and then times all of them on the
same bf16 inputs (o and lse from this tree's forward), in turns (this
tree, the sources, then in reverse), replayed from CUDA graphs:
stablelm-3b's training shape, whisper-medium's encoder, decoder self
attention and cross attention, and hd 128 over 8 kv heads at S 2048.  It
prints one line a shape with the medians, each round's times and each
build's largest difference from this tree's gradients, and the card's
name and power limit.  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
# (label, B, H, KV, Sq, Sk, hd, causal)
SHAPES = (("stablelm-3b", 8, 32, 32, 2048, 2048, 80, True),
          ("whisper-medium encoder", 8, 16, 16, 1500, 1500, 64, False),
          ("whisper-medium decoder self", 8, 16, 16, 447, 447, 64, True),
          ("whisper-medium cross", 8, 16, 16, 447, 1500, 64, False),
          ("hd 128, 8 kv heads", 2, 32, 8, 2048, 2048, 128, True))
# (B, H, KV, Sq, Sk, hd, causal, window): the correctness cases.
CHECKS = [(1, 8, 2, s, s, hd, True, 0) for s in (1, 37, 129, 300)
          for hd in (32, 64, 80, 112, 128)] + [
    (1, 4, 2, 129, 300, 64, True, 40), (1, 4, 4, 300, 129, 64, True, 0),
    (2, 8, 2, 200, 200, 80, False, 0), (1, 8, 8, 500, 500, 128, True, 100),
    (1, 8, 1, 256, 256, 112, False, 0)]
TOL = 2e-2
ROUNDS = 5      # each round: every build, then every build in reverse
INNER = 10      # calls a graph replay


def _build(name: str, src: Path):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as build

    out = ROOT / "build" / f"flash_bwd_ab_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 24 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call(fn, q, k, v, o, lse, do, grads, delta, causal, window=0):
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    tensors = (q, k, v, o, do, *grads)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), do.data_ptr(),
             *(g.data_ptr() for g in grads), delta.data_ptr(), 1, B, H, KV,
             Sq, Sk, hd, int(causal), window,
             *(st for t in tensors for st in t.stride()[:3]),
             torch.cuda.current_stream().cuda_stream)
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


def _inputs(gen, b, h, kv, sq, sk, hd, causal, window=0):
    """q, k, v, o, lse, dO, the delta scratch, and a maker of (B, S, n,
    hd) bf16 tensors seen as (B, n, S, hd) views."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bhsd)

    def bshd(n, s):
        return torch.randn((b, s, n, hd), generator=gen, device="cuda"
                           ).to(torch.bfloat16).transpose(1, 2)
    q, k, v, do, o = (bshd(h, sq), bshd(kv, sk), bshd(kv, sk), bshd(h, sq),
                      bshd(h, sq))
    lse = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    flash_attention_bhsd(q, k, v, causal=causal, window=window, out=o,
                         lse=lse)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
    return q, k, v, o, lse, do, delta, bshd


def _check(fns, gen) -> None:
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    worst = dict.fromkeys(fns, 0.0)
    for case in CHECKS:
        b, h, kv, sq, sk, hd, causal, window = case
        q, k, v, o, lse, do, delta, bshd = _inputs(gen, *case)
        want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                 window=window)
        for name, fn in fns.items():
            runs = []
            for _ in range(2):
                grads = (bshd(h, sq), bshd(kv, sk), bshd(kv, sk))
                _call(fn, q, k, v, o, lse, do, grads, delta, causal, window)
                runs.append(grads)
            torch.cuda.synchronize()
            for what, g1, g2, w in zip(("dq", "dk", "dv"), *runs, want):
                scale = max(1.0, float(w.float().abs().max()))
                err = float((g1.float() - w.float()).abs().max()) / scale
                worst[name] = max(worst[name], err)
                if not torch.equal(g1, g2) or not err <= TOL:
                    raise SystemExit(f"{name} {case} {what}: off by {err:.4g}"
                                     f" of max(1, |plain|), or two calls "
                                     f"differ")
    print("[flash_bwd_ab] checked on "
          f"{len(CHECKS)} cases, worst over max(1, |plain|): "
          + ", ".join(f"{n} {w:.3g}" for n, w in worst.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    sources = {"tree": ROOT / SRC}
    for arg in sys.argv[1:]:
        path = Path(arg).resolve()
        sources[path.stem if path.suffix == ".cu" else path.name] = (
            path if path.suffix == ".cu" else path / SRC)
    with ThreadPoolExecutor(len(sources)) as pool:
        fns = dict(zip(sources, pool.map(lambda kv: _build(*kv),
                                         sources.items())))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _check(fns, gen)
    names = list(fns)
    for label, b, h, kv, sq, sk, hd, causal in SHAPES:
        q, k, v, o, lse, do, delta, bshd = _inputs(gen, b, h, kv, sq, sk, hd,
                                                   causal)
        grads = {name: (bshd(h, sq), bshd(kv, sk), bshd(kv, sk))
                 for name in names}
        runs = {name: (lambda fn=fns[name], gr=grads[name]: _call(
            fn, q, k, v, o, lse, do, gr, delta, causal)) for name in names}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        diff = {name: max(float((a.float() - t.float()).abs().max())
                          for a, t in zip(grads[name], grads["tree"]))
                for name in names[1:]}
        times = {name: [] for name in names}
        for _ in range(ROUNDS):
            for name in names + names[::-1]:
                times[name].append(_replay_ms(runs[name]))
        med = {name: statistics.median(ts) for name, ts in times.items()}
        print(f"[flash_bwd_ab] {label} (B={b} H={h} KV={kv} Sq={sq} "
              f"Sk={sk} hd={hd} causal={causal}): replayed ms, median of "
              f"{2 * ROUNDS}: "
              + ", ".join(f"{n} {med[n]:.4f}" + (
                  "" if n == "tree" else
                  f" (this tree {med['tree'] / med[n]:.4f} of it; largest "
                  f"|tree - {n}| over dq, dk, dv {diff[n]:.4g})")
                  for n in names)
              + "; rounds " + "; ".join(
                  f"{n} " + " ".join(f"{t:.4f}" for t in ts)
                  for n, ts in times.items()), flush=True)
        del q, k, v, do, o, lse, delta, grads, runs
        torch.cuda.empty_cache()
    print(f"[flash_bwd_ab] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
