"""The benchmark of the PyTorch port: one cell, run once.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration, a
traffic mix and the chips it needs.  Everything that belongs to one of
them sits in files of its own, found by name under the checkout:

* ``BENCHMARK.json``'s ``configs`` entry gives the configuration's file
  (``flexbench/configs/<name>.json``): the cluster, the policy, its
  parameters, the kernels the cell builds, the reference that judges it
  and the limits of the numbers that reference reads;
* ``flexbench/traffic/<name>.json``: the trace's statistics, the window
  of the source's day that a study runs and any slots past its end;
* ``flexbench/metrics/<name>.py``: one metric's reader, ``read(ctx)``,
  which returns the metric or ``None`` when there is nothing to read;
* ``flexbench/reference/<name>.py``: a plain reference with
  ``check(study, outputs, device, control)``.

A run builds the cell's kernels, generates the trace and the demand
noise from ``--seed``, warms up on a short study of the same shapes, and
then either runs whole studies back to back for ``--seconds`` (ending
with the study in progress) or profiles one whole study (``--trace 1``).
The timed studies' outputs are then judged by the reference, and one
JSON line is printed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from flexbench import devtrace, tracegen

CHECKOUT = Path(__file__).resolve().parent.parent
BENCH_DIR = "flexbench"

# Top-level module names the process may not hold once the window has
# closed: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

TASK_FIELDS = ("arrival", "duration", "request", "mean_usage", "std_usage",
               "peak_usage", "ar_rho", "priority", "src")


class Cell(NamedTuple):
    name: str
    workload: dict   # the BENCHMARK.json entry
    config: dict     # the configuration's file
    traffic: dict    # the traffic mix's file
    bench: dict      # BENCHMARK.json
    base: Path       # the checkout

    @property
    def slots(self) -> int:
        """Slots a study simulates: the trace's, then any past its end."""
        return self.config["cluster"]["n_slots"] + self.traffic.get(
            "drain_slots", 0)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, base: Path = CHECKOUT) -> Cell:
    """The cell ``name`` of ``base``'s ``BENCHMARK.json``, with its files."""
    bench = _json(base / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {base / 'BENCHMARK.json'}; "
                       f"it has {sorted(work)}")
    workload = work[name]
    config = {c["name"]: c for c in bench["configs"]}[workload["config"]]
    return Cell(name, workload, _json(base / config["file"]),
                _json(base / BENCH_DIR / "traffic"
                      / f"{workload['traffic']}.json"), bench, base)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(cell: Cell):
    """The configuration's plain reference module."""
    ref = cell.config["reference"]
    return _module(cell.base / BENCH_DIR / "reference" / f"{ref}.py",
                   f"flexbench_reference_{ref}")


def metrics_of(cell: Cell, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones,
    or with ``trace`` the per-layer ones, that name the cell."""
    entries = cell.bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if cell.name in m.get("workloads", [cell.name])]


def read_metrics(cell: Cell, trace: bool, ctx: dict) -> dict:
    """Each metric's reader on ``ctx``; a metric whose reader finds
    nothing is left out."""
    out = {}
    for m in metrics_of(cell, trace):
        path = cell.base / BENCH_DIR / "metrics" / f"{m['name']}.py"
        value = _module(path, "flexbench_metric_"
                        + m["name"].replace(".", "_").replace("-", "_")
                        ).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def f32(x: float) -> float:
    return float(np.float32(x))


class Setup(NamedTuple):
    exp: object          # the program's Experiment
    seed: int            # the run's seed
    trace: dict          # the trace's arrays
    table: object        # (S, T) demand noise on the device


def setup(cell: Cell, seed: int, device) -> Setup:
    """Build the cell's kernels, make its inputs from ``seed``, build the
    study and warm it up on the cell's own shapes."""
    import torch

    from repro_torch.api import admission
    from repro_torch.api.experiment import Experiment
    from repro_torch.core.noise import ReplayNoise
    from repro_torch.core.types import FlexParams, SimConfig, TaskSet

    t0 = time.perf_counter()
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(cell.config["kernels"])
    build_s = time.perf_counter() - t0

    c = cell.config
    n_nodes, n_slots = c["cluster"]["n_nodes"], c["cluster"]["n_slots"]
    trace = tracegen.generate(cell.traffic, seed, n_nodes, n_slots)
    n_tasks = len(trace["arrival"])
    widest = tracegen.arrivals_per_slot(trace, n_slots)
    if widest > c["cluster"]["arrivals_per_slot"]:
        # the source's deployment decides every arrival; a table that
        # drops some would measure another system
        raise ValueError(f"{widest} tasks arrive in one slot, more than "
                         f"the arrival table's "
                         f"{c['cluster']['arrivals_per_slot']}")
    table = tracegen.noise_table(cell.traffic, seed, cell.slots, n_tasks,
                                 device)
    ts = TaskSet(*(torch.from_numpy(trace[k]).to(device)
                   for k in TASK_FIELDS))

    def study(n_slots: int, cluster=None, params=None):
        """The cell's study over ``n_slots``, with ``cluster`` and
        ``params`` changed where given."""
        cfg = SimConfig(**dict(c["cluster"], **(cluster or {}),
                               n_slots=n_slots))
        return Experiment(ts, cfg, policy=c["policy"],
                          params=FlexParams.default(
                              **dict(c["params"], **(params or {})),
                              device=device),
                          device=device, noise=lambda s: ReplayNoise(table))

    exp = study(cell.slots)
    t_gen = time.perf_counter()
    admission.reset_decisions()
    for w in c["warmup"]:
        # a short study of the cell's shapes; where the cell's own first
        # slots do not reach a pass, a study tuned to reach it
        study(w["slots"], w.get("cluster"), w.get("params")).run(seeds=seed)
        _sync(device)
    t_end = time.perf_counter()
    print(f"flexbench: set-up: kernels {build_s:.3f} s, trace, noise and "
          f"transfer {t_gen - t0 - build_s:.3f} s, warm-up "
          f"{t_end - t_gen:.3f} s ({admission.DECISIONS} decisions, "
          f"{admission.SWEEPS} sweeps); {n_tasks} tasks, at most {widest} "
          f"a slot", file=sys.stderr)
    return Setup(exp, seed, trace, table)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(su: Setup, seconds: float, device):
    """Whole studies back to back until ``seconds`` have passed, ending
    with the study in progress: (results, seconds, decisions)."""
    from repro_torch.api import admission

    results, ends = [], []
    admission.reset_decisions()
    t0 = time.perf_counter()
    while True:
        results.append(su.exp.run(seeds=su.seed))
        _sync(device)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    print("flexbench: studies ended at " + ", ".join(f"{t:.3f}" for t in ends)
          + " s", file=sys.stderr)
    return results, ends[-1], admission.DECISIONS


def traced(su: Setup, device):
    """One whole study under ``torch.profiler``: (result, window s,
    device events, host events, the study's admission counters)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import admission

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    admission.reset_decisions()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = su.exp.run(seeds=su.seed)
        _sync(device)
        window_s = time.perf_counter() - t0
    counters = dict(decisions=admission.DECISIONS, queues=admission.QUEUES,
                    rounds=admission.ROUNDS, sweeps=admission.SWEEPS,
                    dedup_sweeps=admission.DEDUP_SWEEPS)
    dev, host = devtrace.events(prof)
    return res, window_s, dev, host, counters


OUTPUT_FIELDS = ("placement", "admit_slot", "qos_ok_slots", "active_slots")
SERIES_FIELDS = ("qos", "penalty", "usage", "requested", "est_usage",
                 "usage_std", "n_running", "n_rejected", "n_reclaimed")


def outputs(res) -> tuple:
    """The study's outputs as numpy arrays, in ``Outputs`` order."""
    return tuple(x.cpu().numpy() for x in
                 [getattr(res, f) for f in OUTPUT_FIELDS]
                 + [getattr(res.metrics, f) for f in SERIES_FIELDS])


def repeat_mismatch(results) -> int:
    """Leaves of later studies that differ from the first study's."""
    import torch

    flat = lambda r: list(r[1:]) + list(r.metrics)
    first = flat(results[0])
    return sum(int(not torch.equal(a, b)) for r in results[1:]
               for a, b in zip(first, flat(r)))


def judge(cell: Cell, su: Setup, res, device, control: bool = False):
    """Judge the study ``res`` against the reference: (its numbers, the
    work it judged)."""
    ref = reference(cell)
    c = cell.config
    study = ref.Study(su.trace, su.table.to(device),
                      dict(c["cluster"], n_slots=cell.slots, **c["judge"]),
                      {k: f32(v) for k, v in c["params"].items()})
    return ref.check(study, ref.Outputs(*outputs(res)), device=device,
                     control=control)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the process may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    print(f"flexbench: set-up began {time.perf_counter() - t_start:.3f} s "
          f"after the process started", file=sys.stderr)
    su = setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    ctx = {"cell": cell.name, "config": cell.config, "traffic": cell.traffic,
           "slots": cell.slots,
           "n_nodes": cell.config["cluster"]["n_nodes"],
           "peaks": _json(cell.base / BENCH_DIR / "peaks.json"),
           "setup_s": setup_s}
    if trace:
        res, window_s, dev, host, counters = traced(su, device)
        results = [res]
        ctx.update(counters=counters, trace={
            "window_s": window_s, "busy_s": devtrace.busy_ns(dev) / 1e9,
            "device": dev})
    else:
        results, elapsed, decisions = window(su, seconds, device)
        ctx["window"] = {"seconds": elapsed, "studies": len(results),
                         "decisions": decisions}
    info = device_info(device, cell.workload["chips"])
    mismatch = repeat_mismatch(results)
    # the window's memory goes back before the reference runs on the device
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, work = judge(cell, su, results[0], device)
    del results
    numbers["count_mismatch"] += mismatch
    ctx["work"] = work
    print(f"flexbench: worst decision {json.dumps(work['worst'])}",
          file=sys.stderr)
    limits = cell.config["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    studies = ctx["window"]["studies"] if not trace else 1
    line = {"correct": correct, "attempted": studies,
            "failed": 0 if correct else studies,
            "metrics": read_metrics(cell, trace, ctx), "device": info}
    if trace:
        tr = ctx["trace"]
        line["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": devtrace.top_ops(dev),
                             "idle_gaps": devtrace.idle_gaps(dev, host)}
    line["checks"] = checks
    return line


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"flexbench: {args.workload} needs {chips} CUDA device(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run(cell, args.seed, args.seconds, bool(args.trace),
               torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"flexbench: the process holds {', '.join(found)} after the "
              f"window; no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0
