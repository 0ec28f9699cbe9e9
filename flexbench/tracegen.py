"""The benchmark's traffic: a statistical twin of the Google cluster trace.

A copy of the program's trace-twin generator (``generate_calibrated`` and
the numpy it calls), so that the yardstick's traffic stays fixed when the
program's copy changes.  Everything here is numpy on the host; the same
arrays go to the program (as a ``TaskSet``) and to the plain reference.

A traffic file (``flexbench/traffic/<name>.json``) gives the parameters:
the source's day and its offered load, the seed whose draw (at its
calibrated count) is the day's set of tasks, the window of the day that a
study runs, and the class statistics.  Every ``--seed`` gets the window's
tasks in an order of its own (``generate``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

NUM_RESOURCES = 2
NUM_SRC_BUCKETS = 64

# Field order of one class's statistics in a traffic file.
CLASS_FIELDS = ("frac", "req_mean", "req_sigma", "use_ratio_cpu",
                "use_ratio_mem", "cv_cpu", "cv_mem", "peak_ratio_cpu",
                "peak_ratio_mem", "dur_mean", "ar_rho")
CLASS_NAMES = ("batch", "production", "system")


def _classes(params: dict) -> list:
    return [params["classes"][name] for name in CLASS_NAMES]


def _expected_request_slots(params: dict) -> float:
    """E[request * duration] per task (for offered-load calibration)."""
    e = 0.0
    for c in _classes(params):
        req = c["req_mean"] * np.exp(c["req_sigma"] ** 2 / 2.0)
        e += c["frac"] * req * c["dur_mean"]
    return e


def n_tasks_for_offered_load(n_nodes: int, n_slots: int, offered_load: float,
                             params: dict) -> int:
    """Task count so that mean admitted request ~= offered_load * capacity."""
    per_task = _expected_request_slots(params)
    return int(round(offered_load * n_nodes * n_slots / per_task))


def generate_arrays(seed: int, n_tasks: int, n_slots: int,
                    params: dict) -> Dict[str, np.ndarray]:
    """The trace's struct-of-arrays, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    classes = _classes(params)

    fracs = np.array([c["frac"] for c in classes])
    fracs = fracs / fracs.sum()
    prio = rng.choice(len(fracs), size=n_tasks, p=fracs).astype(np.int32)

    request = np.zeros((n_tasks, NUM_RESOURCES), np.float32)
    mean_usage = np.zeros_like(request)
    std_usage = np.zeros_like(request)
    peak_usage = np.zeros_like(request)
    duration = np.zeros(n_tasks, np.int32)
    ar_rho = np.zeros(n_tasks, np.float32)

    for cls_id, c in enumerate(classes):
        m = prio == cls_id
        n = int(m.sum())
        if n == 0:
            continue
        req = np.exp(rng.normal(np.log(c["req_mean"]), c["req_sigma"],
                                (n, 2)))
        req = np.clip(req, 0.005, 0.5).astype(np.float32)
        request[m] = req

        ratio = np.stack([
            np.clip(rng.normal(c["use_ratio_cpu"],
                               0.15 * c["use_ratio_cpu"], n), 0.05, 1.5),
            np.clip(rng.normal(c["use_ratio_mem"],
                               0.15 * c["use_ratio_mem"], n), 0.05, 1.2),
        ], axis=1).astype(np.float32)
        mean_usage[m] = req * ratio
        cv = np.array([c["cv_cpu"], c["cv_mem"]], np.float32)
        std_usage[m] = mean_usage[m] * cv
        peak = np.array([c["peak_ratio_cpu"], c["peak_ratio_mem"]],
                        np.float32)
        peak_usage[m] = np.minimum(req * peak, 1.0)

        duration[m] = np.clip(rng.geometric(1.0 / c["dur_mean"], n), 1,
                              max(2, n_slots)).astype(np.int32)
        ar_rho[m] = c["ar_rho"]

    t = np.arange(n_slots)
    rate = 1.0 + params["diurnal_amp"] * np.sin(2 * np.pi * t
                                                / max(n_slots, 1))
    rate = rate / rate.sum()
    arrival = rng.choice(n_slots, size=n_tasks, p=rate).astype(np.int32)

    src = (rng.zipf(params["zipf_a"], n_tasks)
           % NUM_SRC_BUCKETS).astype(np.int32)

    return dict(arrival=arrival, duration=duration, request=request,
                mean_usage=mean_usage, std_usage=std_usage,
                peak_usage=peak_usage, ar_rho=ar_rho, priority=prio, src=src)


def calibrated_count(seed: int, n_nodes: int, n_slots: int,
                     offered_load: float, params: dict) -> int:
    """The task count that hits ``offered_load`` on ``seed``'s draws.

    The analytic count ignores horizon truncation, so generate once,
    measure the realized request-slot mass, and correct the count.
    """
    n0 = n_tasks_for_offered_load(n_nodes, n_slots, offered_load, params)
    a = generate_arrays(seed, n0, n_slots, params)
    eff_dur = np.minimum(a["duration"], n_slots - a["arrival"])
    realized = float(
        (a["request"].mean(axis=1) * eff_dur).sum()) / (n_nodes * n_slots)
    return max(1, int(round(n0 * offered_load / max(realized, 1e-6))))


def generate(traffic: dict, seed: int, n_nodes: int,
             n_slots: int) -> Dict[str, np.ndarray]:
    """The trace of one run: a window of ``n_slots`` slots of the source's
    day, in an order drawn from ``seed``.

    The day (``day_slots`` slots at ``offered_load``) is calibrated and
    drawn from ``traffic``'s calibration seed as the source draws it; the
    tasks that arrive in the window ``[first_slot, first_slot + n_slots)``
    are kept with their own sizes and lifetimes, and their arrival slots
    are counted from the window's start.  So the window's arrival rate,
    diurnal phase and lifetimes are the day's.  Every seed gets the same
    tasks, so the seed changes the order in which they queue and, with
    the demand noise drawn from it, how they run; not how much work a
    study is.
    """
    params = traffic["trace"]
    base, day = params["calibration_seed"], params["day_slots"]
    first = params["first_slot"]
    if first + n_slots > day:
        raise ValueError(f"a window of {n_slots} slots from slot {first} "
                         f"leaves the day of {day}")
    n = calibrated_count(base, n_nodes, day, params["offered_load"], params)
    tasks = generate_arrays(base, n, day, params)
    keep = np.flatnonzero((tasks["arrival"] >= first)
                          & (tasks["arrival"] < first + n_slots))
    tasks = {k: v[keep] for k, v in tasks.items()}
    tasks["arrival"] = tasks["arrival"] - np.int32(first)
    perm = order(seed, len(keep))
    return {k: v[perm] for k, v in tasks.items()}


def order(seed: int, n_tasks: int) -> np.ndarray:
    """The order in which ``seed`` puts a window's ``n_tasks`` tasks."""
    return np.random.default_rng(seed).permutation(n_tasks)


def arrivals_per_slot(trace: Dict[str, np.ndarray], n_slots: int) -> int:
    """The most tasks that arrive in one slot of ``trace``."""
    return int(np.bincount(trace["arrival"], minlength=n_slots).max())


def noise_table(traffic: dict, seed: int, n_slots: int, n_tasks: int,
                device):
    """(n_slots, n_tasks) float32 standard normals of the demand process,
    in the order of ``generate(traffic, seed, ...)``'s tasks.

    Each task's column is its own, as a trace records each task's usage:
    drawn on ``device`` in one call from the calibration seed, in the
    window's order, then put in the seed's order with the tasks.  So
    every seed runs the same demand; the seed changes only the order.
    """
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(traffic["trace"]["calibration_seed"]))
    table = torch.randn((n_slots, n_tasks), generator=gen,
                        dtype=torch.float32, device=device)
    perm = torch.from_numpy(order(seed, n_tasks)).to(device)
    return table[:, perm].contiguous()
