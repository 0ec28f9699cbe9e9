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
     paper's cluster scale (4000 nodes), once through the kernel and once
     through the policy's plain hooks; the kernel's launch count must equal
     the decisions made, and the placements must be identical.
  4. small run against the CPU: the same replayed-noise flex-f run on the
     card and on the CPU (which the tests hold against the JAX reference).
  5. profile: where one decision's time goes (host clock, and the
     device's kernel time from torch.profiler), with and without the
     kernel.

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


def small_run_against_cpu(dev) -> None:
    import numpy as np

    from repro_torch.convert import noise_table_from_numpy
    from repro_torch.core import SimConfig, run
    from repro_torch.traces import generate_calibrated

    cfg = SimConfig(**SMALL, use_kernel=True)
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
    log(f"[small] flex-f N={cfg.n_nodes} S={cfg.n_slots}, replayed noise: "
        f"GPU placements equal the CPU port's "
        f"({int((gpu.placement >= 0).sum())} admitted)")


def slice_end_to_end(dev) -> dict:
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
        exp = Experiment(ts, cfg._replace(use_kernel=use_kernel), "flex-f",
                         device=dev)
        torch.cuda.synchronize()
        fs.reset_launches()
        admission.reset_decisions()
        t0 = time.perf_counter()
        res = exp.run(seeds=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, decisions = fs.LAUNCHES, admission.DECISIONS
        _check_result(res, cfg, ts.num_tasks)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            summary = analysis.summarize(ts, res, 0.99)
        runs[use_kernel] = (res, launches, decisions, wall)
        log(f"[slice] flex-f use_kernel={use_kernel}: {decisions} decisions "
            f"in {wall:.2f} s = {decisions / wall:.1f} decisions/s, "
            f"{launches} flex_score launches")
        log(f"[slice] summary use_kernel={use_kernel}: "
            + json.dumps(summary, sort_keys=True))
    res_k, launches, decisions, _ = runs[True]
    if decisions == 0 or launches != decisions:
        raise AssertionError(f"flex_score launched {launches} times for "
                             f"{decisions} decisions")
    if runs[False][1] != 0:
        raise AssertionError("the plain path launched the kernel")
    res_p = runs[False][0]
    for name in ("placement", "admit_slot"):
        if not torch.equal(getattr(res_k, name), getattr(res_p, name)):
            raise AssertionError(f"{name} differs between use_kernel=True "
                                 f"and use_kernel=False")
    log("[slice] placements and admit slots identical with and without "
        "the kernel")
    return {"flex_score_pick": launches}


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

    kernels = [kernel_vs_plain(dev)]
    launches = slice_end_to_end(dev)
    small_run_against_cpu(dev)
    profile_decisions(dev)
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
