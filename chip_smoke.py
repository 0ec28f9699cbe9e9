#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (or a few):

  1. device: the card's name and power limit; build every CUDA kernel
     from this checkout's sources, timed.
  2. kernel against plain: the flex_score pick kernel and its plain
     PyTorch version on the same CUDA tensors, bit for bit, at
     N in {4000, 4097, 100000} (random, tied, all-infeasible, cap < 1 and
     best-fit tasks); times per decision at N = 4000 beside the bound.
  3. the slice end to end: ``Experiment(ts, cfg, "flex-f")`` at the
     paper's cluster scale (4000 nodes), through the kernel for 24 slots
     and through the policy's plain hooks for the first 8; the kernel's
     launch count must equal the decisions made, and the placements must
     be identical.
  4. small run against the CPU: the same replayed-noise flex-f run on the
     card and on the CPU (which the tests hold against the JAX reference).
  5. profile: where one decision's time goes (host clock, and the
     device's kernel time from torch.profiler), with and without the
     kernel.

Wavefront admission (the batched kernels), in order after phase 2 and
after phase 3:

  a. the batched argmax and top-K kernels against their plain PyTorch
     versions, bit for bit, at N in {4000, 4097, 100000} x Q in {1, 33,
     4096} x K in {1, 8} (and one K = 40, which takes two passes), on
     random and tied tables with a fifth of the tasks fitting nowhere;
     times per sweep at N = 4000, Q = 4096 beside the bound.
  b. the wavefront study: phase 3's configuration with
     ``admission_mode="wavefront"``; placements and admit slots must equal
     phase 3's sequential kernel run, and the top-K kernel must launch
     once per sweep.
  c. the ``wavefront_topk=0`` loop, 4 slots deep, against the first 4
     slots of phase 3's sequential run: the batched argmax kernel on a
     path.
  d. one dedup-heavy queue (64 distinct shapes, Q = 4096, N = 4000)
     through the score-bucket dedup, against the sequential scan.
  e. the small replayed-noise wavefront run on the card against the CPU.
  f. profile: where one full-width wavefront queue's time goes.

Then the kernels' JSON line, and last ``{"ok": true, "device": ...}``.
Any failure raises and the script exits non-zero.  Without a GPU it exits
1 before doing anything.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

SMALL = dict(n_nodes=16, n_slots=12, arrivals_per_slot=64, retry_capacity=32)
# The paper's cluster: 4000 nodes, 24 h of 5-minute slots.  The horizon is
# cut from 288 slots to 24 to fit the run's time limit.
FULL = dict(n_nodes=4000, n_slots=24, arrivals_per_slot=4096,
            retry_capacity=1024)
PAPER_SLOTS = 288
OFFERED_LOAD = 1.6
# Depth of phase 3's plain-path run, cut to fit the time limit: it is
# held against the kernel run's first PLAIN_SLOTS slots.
PLAIN_SLOTS = 8
# Phase a's sizes, and the width of the synthetic queues of phases a, d, f
# (the study's compacted queues hold about 4,100-5,100 tasks a slot).
BATCH_NS = (4000, 4097, 100000)
BATCH_QS = (1, 33, 4096)
QUEUE = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernel against plain
# ---------------------------------------------------------------------------

def _tables(n: int, gen: torch.Generator, dev, tied: bool):
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    est, res, src = u(n, 2) * 0.8, u(n, 2) * 0.1, u(n)
    if tied:   # few distinct values: many rows share a score exactly
        est, res, src = (torch.floor(x * 4) / 4 for x in (est * 1.25,
                                                          res * 10, src))
        res = res / 8
    return est.contiguous(), res.contiguous(), src.contiguous()


def _tasks(count: int, gen: torch.Generator, dev):
    """(r, penalty, cap, w_load, w_src) rows; every fifth kind forced."""
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    out = []
    for k in range(count):
        r = u(2) * 0.2
        penalty, cap, w_load, w_src = 1.0 + u(1)[0], 1.0, 1.0, 0.25
        kind = k % 5
        if kind == 1:
            r = r + 2.0                      # fits nowhere
        elif kind == 2:
            cap = 0.5                        # cap < 1
        elif kind == 3:
            w_load, w_src = -1.0, 0.0        # best fit
        elif kind == 4:
            w_load, w_src = 0.5 + u(1)[0], u(1)[0]
        out.append((r, penalty, cap, w_load, w_src))
    return out


def _median_ms(fn, reps: int, inner: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls of
    ``fn`` replayed from a CUDA graph, per call: device time without the
    Python launch path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _event_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``reps`` eager calls of ``fn``, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _eager_ms(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def kernel_vs_plain(dev) -> dict:
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.kernels.flex_score.ops import pack_task
    from repro_torch.kernels.flex_score.ref import pick_node_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    worst = 0.0
    for n in (4000, 4097, 100000):
        for tied in (False, True):
            est, res, src = _tables(n, gen, dev, tied)
            k_idx, k_score, p_idx, p_score = [], [], [], []
            for r, penalty, cap, w_load, w_src in _tasks(100, gen, dev):
                task = pack_task(r, penalty, cap, w_load, w_src, dev)
                i, s = fs.flex_score_pick(est, res, src, task)
                k_idx.append(i[0])
                k_score.append(s[0])
                pi, ps, _ = pick_node_ref(est, res, src, r, penalty, w_load,
                                          w_src, cap=cap)
                p_idx.append(pi)
                p_score.append(ps)
            torch.cuda.synchronize()
            k_idx, p_idx = torch.stack(k_idx), torch.stack(p_idx)
            k_score, p_score = torch.stack(k_score), torch.stack(p_score)
            if not torch.equal(k_idx, p_idx):
                bad = (k_idx != p_idx).nonzero()[:5].flatten().tolist()
                raise AssertionError(
                    f"flex_score N={n} tied={tied}: kernel and plain pick "
                    f"different nodes at tasks {bad}")
            if not torch.equal(k_score.view(torch.int32),
                               p_score.view(torch.int32)):
                raise AssertionError(
                    f"flex_score N={n} tied={tied}: scores differ in bits")
            worst = max(worst, float((k_score - p_score).abs().max()))
            log(f"[kernel] flex_score N={n} tied={tied}: 100 tasks, index "
                f"and score bit-equal to the plain version "
                f"({int((k_idx < 0).sum())} with no feasible node)")

    n = FULL["n_nodes"]
    est, res, src = _tables(n, gen, dev, tied=False)
    r = torch.full((2,), 0.05, device=dev)
    penalty = torch.full((), 1.3, device=dev)
    task = pack_task(r, penalty, 1.0, 1.0, 0.25, dev)
    kernel = lambda: fs.flex_score_pick(est, res, src, task)
    plain = lambda: pick_node_ref(est, res, src, r, penalty, 1.0, 0.25)
    ms = _median_ms(kernel, reps=20, inner=100)
    plain_ms = _median_ms(plain, reps=20, inner=100)
    eager_ms = _eager_ms(kernel, 2000)
    n_bytes = (2 * n * 2 + n + 6) * 4 + 8   # est, reserved, src, task; out
    n_flops = 9 * n            # 2 fma + 2 add per load pair, max, fma, mul
    bound_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ops = n_flops / FP32_FLOPS * 1e3
    log(f"[kernel] flex_score N={n}: {ms * 1e3:.3f} us per decision "
        f"(graph replay), plain {plain_ms * 1e3:.3f} us, eager call "
        f"{eager_ms * 1e3:.3f} us; bound {max(bound_bytes, bound_ops) * 1e6:.1f}"
        f" ns ({n_bytes} B at 3.35 TB/s)")
    return dict(name="flex_score_pick", route="cuda",
                source="src/repro_torch/kernels/flex_score/csrc/flex_score.cu",
                replaces="src/repro/kernels/flex_score/flex_score.py:40",
                launches=0, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bound_bytes, bound_ops),
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                library_ms=None)


# ---------------------------------------------------------------------------
# phase a: the batched kernels against plain
# ---------------------------------------------------------------------------

def _task_rows(q: int, gen: torch.Generator, dev):
    """(r (Q, 2), penalty, cap, w_load, w_src (Q,)) in _tasks' five kinds,
    row by row."""
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    kind = torch.arange(q, device=dev) % 5
    r = u(q, 2) * 0.2 + (kind == 1)[:, None] * 2.0      # fits nowhere
    penalty = 1.0 + u(q)
    cap = torch.where(kind == 2, 0.5, 1.0)               # cap < 1
    w_load = torch.where(kind == 3, -1.0,                # best fit
                         torch.where(kind == 4, 0.5 + u(q), 1.0))
    w_src = torch.where(kind == 3, 0.0, torch.where(kind == 4, u(q), 0.25))
    return r, penalty, cap, w_load, w_src


def _plain_rows(fn, src, rows, *args, chunk: int = 256):
    """A plain batched version over ``chunk`` task rows at a time (its
    (Q, N, R) float64 intermediates would not fit at once at N = 100000),
    concatenated."""
    outs = []
    for lo in range(0, src.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        outs.append(fn(*args, src[sl], *(x[sl] for x in rows)))
    return [torch.cat(parts) for parts in zip(*outs)]


def _batch_bound(n: int, q: int, out_bytes: int):
    """(bound ms, what bounds it) of one sweep: est, reserved, src_frac and
    the task rows read once, the outputs written once; 4 R + 5 float32
    operations per task and node (R = 2)."""
    n_bytes = (2 * n * 2 + q * n + q * 6) * 4 + out_bytes
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = 13 * q * n / FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def batch_kernels_vs_plain(dev) -> list:
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.kernels.flex_score.ops import _task_mat
    from repro_torch.kernels.flex_score.ref import (pick_node_batch_ref,
                                                    pick_node_batch_topk_ref)

    def plain_pick(est, res, src, r, p, c, wl, ws):
        return pick_node_batch_ref(est, res, src, r, p, wl, ws, c)[:2]

    def plain_topk(k):
        def fn(est, res, src, r, p, c, wl, ws):
            return pick_node_batch_topk_ref(est, res, src, r, p, wl, ws, c,
                                            k)[:2]
        return fn

    def same(name, got, want):
        (gi, gs), (wi, ws) = got, want
        if not torch.equal(gi, wi):
            bad = (gi != wi).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: kernel and plain pick different "
                                 f"nodes at {bad}")
        if not torch.equal(gs.view(torch.int32), ws.view(torch.int32)):
            raise AssertionError(f"{name}: scores differ in bits")
        return float((gs - ws).abs().max()) if gs.numel() else 0.0

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    worst = {"pick": 0.0, "topk": 0.0}
    for n in BATCH_NS:
        for tied in (False, True):
            est, res, _ = _tables(n, gen, dev, tied)
            for q in BATCH_QS:
                src = torch.rand((q, n), generator=gen, device=dev)
                if tied:
                    src = torch.floor(src * 4) / 4
                rows = _task_rows(q, gen, dev)
                mat = _task_mat(*rows)
                got = fs.flex_score_batch_pick(est, res, src, mat)
                want = _plain_rows(plain_pick, src, rows, est, res)
                worst["pick"] = max(worst["pick"], same(
                    f"batch_pick N={n} Q={q} tied={tied}", got, want))
                col0 = got[0]
                ks = (1, 8, 40) if (n, q) == (BATCH_NS[1], BATCH_QS[1]) \
                    else (1, 8)
                for k in ks:
                    got = fs.flex_score_batch_topk(est, res, src, mat, k)
                    want = _plain_rows(plain_topk(k), src, rows, est, res)
                    worst["topk"] = max(worst["topk"], same(
                        f"batch_topk N={n} Q={q} K={k} tied={tied}", got,
                        want))
                    if not torch.equal(got[0][:, 0], col0):
                        raise AssertionError(f"batch_topk K={k}: column 0 "
                                             f"is not the batched argmax")
                torch.cuda.synchronize()
                log(f"[batch] N={n} Q={q} tied={tied}: argmax and top-K "
                    f"(K in {ks}) bit-equal to the plain versions "
                    f"({int((col0 < 0).sum())} tasks fit nowhere)")
            del src

    n, q, k = FULL["n_nodes"], QUEUE, 8
    est, res, _ = _tables(n, gen, dev, tied=False)
    src = torch.rand((q, n), generator=gen, device=dev)
    rows = _task_rows(q, gen, dev)
    mat = _task_mat(*rows)
    out = []
    for name, kernel, plain, out_bytes in (
            ("flex_score_batch_pick",
             lambda: fs.flex_score_batch_pick(est, res, src, mat),
             lambda: pick_node_batch_ref(est, res, src, rows[0], rows[1],
                                         rows[3], rows[4], rows[2]),
             q * 8),
            ("flex_score_batch_topk",
             lambda: fs.flex_score_batch_topk(est, res, src, mat, k),
             lambda: pick_node_batch_topk_ref(est, res, src, rows[0],
                                              rows[1], rows[3], rows[4],
                                              rows[2], k),
             q * k * 8)):
        ms = _median_ms(kernel, reps=20, inner=20)
        plain_ms = _event_ms(plain, reps=5)
        bound_ms, bound_by = _batch_bound(n, q, out_bytes)
        log(f"[batch] {name} N={n} Q={q}{f' K={k}' if 'topk' in name else ''}"
            f": {ms * 1e3:.3f} us per sweep (graph replay), plain "
            f"{plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.3f} us "
            f"({bound_by}), {bound_ms / ms:.3f} of it")
        out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/flex_score/csrc/"
                   "flex_score_batch.cu",
            replaces=("src/repro/kernels/flex_score/flex_score.py:69"
                      if name.endswith("pick") else
                      "src/repro/kernels/flex_score/flex_score.py:114"),
            launches=0,
            max_abs_err=worst["pick" if name.endswith("pick") else "topk"],
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the slice, and a small run against the CPU
# ---------------------------------------------------------------------------

def _check_result(res, cfg, n_tasks: int) -> None:
    m = res.metrics
    for name in ("usage", "requested", "usage_std", "usage_mean",
                 "est_usage"):
        x = getattr(m, name)
        if x.shape != (cfg.n_slots, 2) or not torch.isfinite(x).all():
            raise AssertionError(f"metrics.{name}: shape {tuple(x.shape)} "
                                 f"or non-finite values")
    for name in ("qos", "penalty", "n_running", "n_rejected"):
        if getattr(m, name).shape != (cfg.n_slots,):
            raise AssertionError(f"metrics.{name} has the wrong shape")
    if not (torch.isfinite(m.qos).all() and torch.isfinite(m.penalty).all()):
        raise AssertionError("non-finite qos or penalty")
    for name in ("placement", "admit_slot", "qos_ok_slots", "active_slots"):
        if getattr(res, name).shape != (n_tasks,):
            raise AssertionError(f"{name} has the wrong shape")
    pl = res.placement
    if int(pl.min()) < -1 or int(pl.max()) >= cfg.n_nodes:
        raise AssertionError("placement out of range")


def small_run_against_cpu(dev, mode: str = "sequential") -> None:
    import numpy as np

    from repro_torch.convert import noise_table_from_numpy
    from repro_torch.core import SimConfig, run
    from repro_torch.traces import generate_calibrated

    cfg = SimConfig(**SMALL, use_kernel=True, admission_mode=mode)
    out = {}
    for device in (dev, torch.device("cpu")):
        ts = generate_calibrated(0, cfg.n_nodes, cfg.n_slots, OFFERED_LOAD,
                                 device=device)
        table = np.random.default_rng(0).standard_normal(
            (cfg.n_slots, ts.num_tasks)).astype(np.float32)
        out[device.type] = run(ts, cfg, "flex-f", device=device,
                               noise=noise_table_from_numpy(table,
                                                            device=device))
    gpu, cpu = out["cuda"], out["cpu"]
    _check_result(gpu, cfg, gpu.placement.shape[0])
    for name in ("placement", "admit_slot", "qos_ok_slots", "active_slots"):
        if not torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"small run: {name} differs GPU vs CPU")
    for name in ("usage", "requested", "qos", "penalty", "est_usage"):
        a, b = getattr(gpu.metrics, name).cpu(), getattr(cpu.metrics, name)
        if not torch.allclose(a, b, rtol=1e-6, atol=1e-6):
            raise AssertionError(f"small run: metrics.{name} differs")
    log(f"[small] flex-f {mode} N={cfg.n_nodes} S={cfg.n_slots}, replayed "
        f"noise: GPU placements equal the CPU port's "
        f"({int((gpu.placement >= 0).sum())} admitted)")


def _same_decisions(what: str, res, ref, n_slots=None) -> None:
    """``res``'s placements and admit slots equal ``ref``'s; with
    ``n_slots``, ``res`` ran only the first ``n_slots`` slots of ``ref``'s
    run, so it must hold exactly ``ref``'s decisions of those slots."""
    pl, sl = ref.placement, ref.admit_slot
    if n_slots is not None:
        early = (sl >= 0) & (sl < n_slots)
        pl, sl = torch.where(early, pl, -1), torch.where(early, sl, -1)
    for name, want in (("placement", pl), ("admit_slot", sl)):
        got = getattr(res, name)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {name} differs from the "
                                 f"sequential run in "
                                 f"{int((got != want).sum())} tasks")


def slice_end_to_end(dev):
    """Phase 3; returns (launches of the kernel run, the trace, the kernel
    run's result).  The plain path runs the first PLAIN_SLOTS slots."""
    from repro_torch.api import Experiment, admission
    from repro_torch.core import SimConfig
    from repro_torch.kernels.flex_score import flex_score as fs
    from repro_torch.traces import analysis, generate_calibrated

    cfg = SimConfig(**FULL, use_kernel=True)
    t0 = time.perf_counter()
    ts = generate_calibrated(0, cfg.n_nodes, cfg.n_slots, OFFERED_LOAD,
                             device=dev)
    log(f"[slice] trace: {ts.num_tasks} tasks over {cfg.n_slots} slots, "
        f"offered load {OFFERED_LOAD} ({time.perf_counter() - t0:.2f} s); "
        f"horizon cut from {PAPER_SLOTS} to {cfg.n_slots} slots to fit the "
        f"time limit")
    runs = {}
    for use_kernel in (True, False):
        run_cfg = cfg._replace(use_kernel=use_kernel)
        if not use_kernel:
            run_cfg = run_cfg._replace(n_slots=PLAIN_SLOTS)
        exp = Experiment(ts, run_cfg, "flex-f", device=dev)
        torch.cuda.synchronize()
        fs.reset_launches()
        admission.reset_decisions()
        t0 = time.perf_counter()
        res = exp.run(seeds=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, decisions = fs.LAUNCHES, admission.DECISIONS
        _check_result(res, run_cfg, ts.num_tasks)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            summary = analysis.summarize(ts, res, 0.99)
        runs[use_kernel] = (res, launches, decisions, wall)
        log(f"[slice] flex-f use_kernel={use_kernel}, {run_cfg.n_slots} "
            f"slots: {decisions} decisions in {wall:.2f} s = "
            f"{decisions / wall:.1f} decisions/s, {launches} flex_score "
            f"launches")
        log(f"[slice] summary use_kernel={use_kernel}: "
            + json.dumps(summary, sort_keys=True))
    res_k, launches, decisions, _ = runs[True]
    if decisions == 0 or launches != decisions:
        raise AssertionError(f"flex_score launched {launches} times for "
                             f"{decisions} decisions")
    if runs[False][1] != 0:
        raise AssertionError("the plain path launched the kernel")
    _same_decisions("use_kernel=False", runs[False][0], res_k, PLAIN_SLOTS)
    log(f"[slice] the plain path's placements and admit slots equal the "
        f"kernel run's first {PLAIN_SLOTS} slots")
    return {"flex_score_pick": launches}, ts, res_k


# ---------------------------------------------------------------------------
# phases b-f: wavefront admission
# ---------------------------------------------------------------------------

def _counts() -> dict:
    from repro_torch.api import admission
    from repro_torch.kernels.flex_score import flex_score as fs
    return dict(pick=fs.LAUNCHES, batch=fs.BATCH_LAUNCHES,
                topk=fs.TOPK_LAUNCHES, decisions=admission.DECISIONS,
                rounds=admission.ROUNDS, sweeps=admission.SWEEPS,
                dedup_sweeps=admission.DEDUP_SWEEPS)


def _reset_counts() -> None:
    from repro_torch.api import admission
    from repro_torch.kernels.flex_score import flex_score as fs
    torch.cuda.synchronize()
    fs.reset_launches()
    admission.reset_decisions()


def _timed_run(exp):
    _reset_counts()
    t0 = time.perf_counter()
    res = exp.run(seeds=0)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _counts()


def wavefront_study(dev, ts, res_seq) -> int:
    """Phase b; returns the top-K kernel's launches."""
    from repro_torch.api import Experiment
    from repro_torch.core import SimConfig
    from repro_torch.traces import analysis

    cfg = SimConfig(**FULL, admission_mode="wavefront")
    exp = Experiment(ts, cfg, "flex-f", device=dev)
    torch.cuda.reset_peak_memory_stats()
    res, wall, c = _timed_run(exp)
    peak = torch.cuda.max_memory_allocated()
    _check_result(res, cfg, ts.num_tasks)
    log(f"[wave] flex-f wavefront N={cfg.n_nodes} S={cfg.n_slots} "
        f"(topk={cfg.wavefront_topk}, dedup_buckets={cfg.dedup_buckets}): "
        f"{c['decisions']} decisions in {wall:.2f} s = "
        f"{c['decisions'] / wall:.1f} decisions/s; {c['rounds']} rounds and "
        f"{c['sweeps']} sweeps ({c['rounds'] / cfg.n_slots:.1f} and "
        f"{c['sweeps'] / cfg.n_slots:.1f} per slot, {c['dedup_sweeps']} "
        f"deduplicated); {c['topk']} top-K launches; peak memory "
        f"{peak / 2**20:.1f} MiB")
    if c["sweeps"] == 0 or c["topk"] != c["sweeps"]:
        raise AssertionError(f"top-K kernel launched {c['topk']} times for "
                             f"{c['sweeps']} sweeps")
    if c["pick"] or c["batch"]:
        raise AssertionError("the wavefront study launched another kernel")
    _same_decisions("wavefront study", res, res_seq)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        summary = analysis.summarize(ts, res, 0.99)
    log("[wave] summary: " + json.dumps(summary, sort_keys=True))
    log("[wave] placements and admit slots identical to the sequential "
        "kernel run")
    return c["topk"]


def topk0_loop(dev, ts, res_seq, n_slots: int = 4) -> int:
    """Phase c; returns the batched argmax kernel's launches.  The run's
    decisions must be those of the sequential kernel run's first
    ``n_slots`` slots, which a sequential run of that depth makes."""
    from repro_torch.api import Experiment
    from repro_torch.core import SimConfig

    cfg = SimConfig(**FULL)._replace(n_slots=n_slots,
                                     admission_mode="wavefront",
                                     wavefront_topk=0)
    res, wall, c = _timed_run(Experiment(ts, cfg, "flex-f", device=dev))
    log(f"[topk0] flex-f wavefront_topk=0 N={cfg.n_nodes} S={n_slots}: "
        f"{c['decisions']} decisions in {wall:.2f} s = "
        f"{c['decisions'] / wall:.1f} decisions/s; {c['rounds']} rounds, "
        f"{c['sweeps']} sweeps, {c['batch']} argmax launches")
    if c["sweeps"] == 0 or not c["batch"] == c["sweeps"] == c["rounds"]:
        raise AssertionError("the topk=0 loop must launch the argmax kernel "
                             "once per round")
    if c["topk"] or c["pick"]:
        raise AssertionError("the topk=0 loop launched another kernel")
    _same_decisions("wavefront_topk=0", res, res_seq, n_slots)
    log(f"[topk0] placements and admit slots equal the sequential kernel "
        f"run's first {n_slots} slots")
    return c["batch"]


def _node_table(n: int, seed: int, dev):
    from repro_torch.core.types import NodeState

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    node = NodeState.zeros(n, device=dev)._replace(
        est_usage=u(n, 2) * 0.5, requested=u(n, 2) * 0.9,
        n_tasks=(u(n) * 8).to(torch.int32),
        src_count=(u(n, 64) * 2).to(torch.int32))
    return node, u


def dedup_queue(dev, shapes: int = 64) -> None:
    """Phase d: a queue of ``shapes`` distinct (request, source) rows."""
    q = QUEUE
    from repro_torch.api import admission, get_policy
    from repro_torch.core.types import FlexParams

    node, u = _node_table(FULL["n_nodes"], 3, dev)
    j = torch.arange(q, device=dev) % shapes
    reqs = (u(shapes, 2) * 0.1)[j]
    srcs = j.to(torch.int32)
    prios = torch.zeros(q, dtype=torch.int32, device=dev)
    valid = torch.ones(q, dtype=torch.bool, device=dev)
    params = FlexParams.default(device=dev)
    penalty = torch.full((), 1.2, device=dev)
    policy = get_policy("flex-f")
    out = {}
    for batch_mode in (False, True):
        _reset_counts()
        t0 = time.perf_counter()
        out[batch_mode] = admission.admit_queue(
            policy, node, reqs, srcs, prios, valid, penalty, params,
            use_kernel=True, batch_mode=batch_mode)
        torch.cuda.synchronize()
        out[batch_mode] += (time.perf_counter() - t0, _counts())
    (ns_s, pl_s, t_s, _), (ns_w, pl_w, t_w, c) = out[False], out[True]
    log(f"[dedup] flex-f Q={q} ({shapes} distinct rows) N={FULL['n_nodes']}: "
        f"sequential {t_s:.2f} s, wavefront {t_w:.2f} s; {c['rounds']} "
        f"rounds, {c['sweeps']} sweeps, {c['dedup_sweeps']} deduplicated; "
        f"{int((pl_w >= 0).sum())} placed")
    if c["sweeps"] == 0 or c["dedup_sweeps"] != c["sweeps"]:
        raise AssertionError("the dedup-heavy queue did not take the dedup "
                             "branch on every sweep")
    if not torch.equal(pl_s, pl_w):
        raise AssertionError("dedup queue: placements differ from the "
                             "sequential scan")
    for name in ns_s._fields:
        if not torch.equal(getattr(ns_s, name), getattr(ns_w, name)):
            raise AssertionError(f"dedup queue: node {name} differs")


def profile_wavefront(dev) -> None:
    """Phase f: one full-width queue of distinct tasks, untraced on the
    host clock, then under torch.profiler."""
    q = QUEUE
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import admission, get_policy
    from repro_torch.core.types import FlexParams

    n = FULL["n_nodes"]
    node, u = _node_table(n, 4, dev)
    reqs = u(q, 2) * 0.1
    srcs = (u(q) * 64).to(torch.int32)
    prios = torch.zeros(q, dtype=torch.int32, device=dev)
    valid = torch.ones(q, dtype=torch.bool, device=dev)
    params = FlexParams.default(device=dev)
    penalty = torch.full((), 1.2, device=dev)
    policy = get_policy("flex-f")
    admit = lambda: admission.admit_queue(
        policy, node, reqs, srcs, prios, valid, penalty, params,
        batch_mode=True)
    admit()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    admit()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    c = _counts()
    peak = torch.cuda.max_memory_allocated()
    # Device activity only: with the host's operator events recorded as
    # well, the traced run takes about twenty times the untraced one.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        admit()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"[wprofile] flex-f wavefront Q={q} N={n}: {wall_ms:.1f} ms "
        f"untraced, {c['rounds']} rounds, {c['sweeps']} sweeps "
        f"({wall_ms / c['rounds']:.3f} ms per round); peak memory "
        f"{peak / 2**20:.1f} MiB")
    if busy_ms == 0:
        log("[wprofile] device time not visible to the profiler")
        return
    log(f"[wprofile] device busy {busy_ms:.2f} ms in {launches} kernels "
        f"({launches / c['rounds']:.1f} per round), idle share "
        f"{1 - busy_ms / wall_ms:.4f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[wprofile]   {e.key[:60]}: {e.count} calls, "
            f"{e.self_device_time_total / 1e3:.3f} ms")


def profile_decisions(dev, decisions: int = 256) -> None:
    """Where a decision's time goes: one queue admitted at N = 4000,
    timed untraced on the host clock, then traced by torch.profiler for
    the device's kernel time and the kernels launched per decision."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import admission, get_policy
    from repro_torch.core.types import FlexParams, NodeState

    n = FULL["n_nodes"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    node = NodeState.zeros(n, device=dev)._replace(
        est_usage=u(n, 2) * 0.5, requested=u(n, 2) * 0.9,
        n_tasks=(u(n) * 8).to(torch.int32),
        src_count=(u(n, 64) * 2).to(torch.int32))
    reqs = u(decisions, 2) * 0.1
    srcs = (u(decisions) * 64).to(torch.int32)
    prios = (u(decisions) * 3).to(torch.int32)
    valid = torch.ones(decisions, dtype=torch.bool, device=dev)
    params = FlexParams.default(device=dev)
    penalty = torch.full((), 1.2, device=dev)
    policy = get_policy("flex-f")
    for use_kernel in (True, False):
        admit = lambda: admission.admit_queue(
            policy, node, reqs, srcs, prios, valid, penalty, params,
            use_kernel=use_kernel)
        admit()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / decisions
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            admit()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.self_device_time_total for e in kernels) / decisions
        count = sum(e.count for e in kernels) / decisions
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        if busy_us == 0:
            log(f"[profile] use_kernel={use_kernel}: {wall_us:.1f} us per "
                f"decision; device time not visible to the profiler")
            continue
        log(f"[profile] flex-f admit_queue N={n}, {decisions} decisions, "
            f"use_kernel={use_kernel}: {wall_us:.1f} us per decision "
            f"untraced; device busy {busy_us:.2f} us per decision in "
            f"{count:.1f} kernels (idle share {1 - busy_us / wall_us:.4f})")
        for e in top:
            log(f"[profile]   {e.key[:60]}: {e.count / decisions:.1f} per "
                f"decision, {e.self_device_time_total / e.count:.2f} us each")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; python "
        f"{sys.version.split()[0]}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")
    log(f"[device] nvidia-smi: {card}")
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"[device] built {sorted(build_logs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                log(f"[device]   {name}: {line.strip()}")

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(dev, *args)
        log(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    kernels = [timed("2", kernel_vs_plain),
               *timed("a", batch_kernels_vs_plain)]
    launches, ts, res_seq = timed("3", slice_end_to_end)
    launches["flex_score_batch_topk"] = timed("b", wavefront_study, ts,
                                              res_seq)
    launches["flex_score_batch_pick"] = timed("c", topk0_loop, ts,
                                              res_seq)
    timed("d", dedup_queue)
    timed("4", small_run_against_cpu, "sequential")
    timed("e", small_run_against_cpu, "wavefront")
    timed("5", profile_decisions)
    timed("f", profile_wavefront)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on the path")

    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
