"""The plain reference against the port on the CPU, its bfloat16 control,
and runs with the timed path broken underneath: each must come out as
not correct."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flexbench import harness, tracegen
from flexbench.conftest import make_checkout
from flexbench.reference import flexsim

ROOT = Path(__file__).resolve().parent.parent
LIMITS = {name: json.loads((ROOT / "flexbench" / "configs"
                            / f"{name}.json").read_text())["limits"]
          for name in ("flexf-4000", "flexf-reclaim-4000")}

# (configuration, traffic, cluster, drain slots, cluster changes): the two
# cells' settings at 48 nodes, and one whose reclaim pass does reclaim
# (the paper's estimator sees the load fall as soon as the arrivals end).
# At 48 nodes the day's first 6 slots are offered ten times the load, so
# that tasks are refused within them.
SMALL = dict(n_nodes=48, n_slots=6, arrivals_per_slot=400,
             retry_capacity=40)
LOADED = {"offered_load": 16.0}
CASES = {
    "study": ("flexf-4000", "study-1run", SMALL, None, {}),
    "reclaim": ("flexf-reclaim-4000", "study-1run-drain", SMALL, 3, {}),
    "reclaim-current": ("flexf-reclaim-4000", "study-1run-drain",
                        dict(SMALL, reclaim_margin=0.0), 3,
                        {"estimator": "current"}),
}


def _study(tmp_path, case):
    config, traffic, cluster, drain, extra = CASES[case]
    base = make_checkout(tmp_path, config, traffic, "t.cell",
                         dict(cluster, **extra), drain, LOADED)
    cell = harness.load_cell("t.cell", base)
    dev = torch.device("cpu")
    su = harness.setup(cell, 2 ** 32 + 17, dev)
    res = su.exp.run(seeds=su.seed)
    return cell, su, res


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_agrees_with_the_port(tmp_path, case):
    cell, su, res = _study(tmp_path, case)
    numbers, work = harness.judge(cell, su, res, torch.device("cpu"))
    limits = LIMITS[CASES[case][0]]
    assert numbers["decision_gap"] <= 1e-6
    assert numbers["series_gap"] <= 1e-6
    assert numbers["count_mismatch"] == 0
    assert numbers["qos_ok_mismatch"] == 0
    assert all(numbers[k] <= limits[k] for k in limits)
    assert len(work["queues"]) == cell.slots
    if case != "study":
        assert sum(work["reclaim"]) > 0
    if case == "reclaim-current":
        assert int(res.metrics.n_reclaimed[-1]) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_bfloat16_control_is_not_correct(tmp_path, case):
    cell, su, res = _study(tmp_path, case)
    numbers, _ = harness.judge(cell, su, res, torch.device("cpu"),
                               control=True)
    ctl = numbers["control"]
    limits = LIMITS[CASES[case][0]]
    assert any(ctl[k] > limits[k] for k in limits), ctl
    assert ctl["decision_gap"] > limits["decision_gap"]


def test_the_judge_reads_a_moved_placement(tmp_path):
    cell, su, res = _study(tmp_path, "study")
    out = harness.outputs(res)
    place = out[0].copy()
    k = int(np.flatnonzero(place >= 0)[len(place) // 3])
    place[k] = (place[k] + 1) % cell.config["cluster"]["n_nodes"]
    c = cell.config
    study = flexsim.Study(su.trace, su.table,
                          dict(c["cluster"], n_slots=cell.slots,
                               **c["judge"]),
                          {k2: harness.f32(v) for k2, v in
                           c["params"].items()})
    numbers, _ = flexsim.check(study, flexsim.Outputs(place, *out[1:]))
    assert (numbers["decision_gap"] > 0 or numbers["series_gap"] > 1e-6
            or numbers["count_mismatch"] > 0)


def test_every_seed_gets_the_same_tasks_in_another_order():
    traffic = json.loads((ROOT / "flexbench" / "traffic"
                          / "study-1run.json").read_text())
    traces = [tracegen.generate(traffic, s, 32, 4)
              for s in (1, 2 ** 31 + 3, 2 ** 40)]
    key = lambda t: sorted(zip(t["arrival"], t["duration"],
                               t["request"][:, 0], t["src"]))
    assert key(traces[0]) == key(traces[1]) == key(traces[2])
    assert not np.array_equal(traces[0]["request"], traces[1]["request"])
    again = tracegen.generate(traffic, 2 ** 31 + 3, 32, 4)
    assert all(np.array_equal(again[k], traces[1][k]) for k in again)
    # and the same demand: each task's noise goes with it
    n = len(traces[0]["arrival"])
    back = [np.argsort(tracegen.order(s, n)) for s in (1, 2 ** 31 + 3)]
    tabs = [tracegen.noise_table(traffic, s, 4, n, "cpu").numpy()[:, b]
            for s, b in zip((1, 2 ** 31 + 3), back)]
    assert np.array_equal(tabs[0], tabs[1])
    assert np.array_equal(traces[0]["request"][back[0]],
                          traces[1]["request"][back[1]])


# --- faults planted in the timed path ---------------------------------

def _no_commit(*args, **kw):
    """A decision step that returns the node state unchanged."""


def _half_alloc(demand, request, placement, active, *args, **kw):
    """Node usage from the first half of the running tasks only."""
    keep = torch.arange(active.shape[-1]) < active.shape[-1] // 2
    return _ORIG_ALLOC(demand, request, placement, active & keep, *args,
                       **kw)


def _moved(*args, **kw):
    """Placements altered where they are made: each one node further."""
    out = _ORIG_ADMIT(*args, **kw)
    n = args[0].shape[-2]
    return torch.where(out >= 0, (out + 1) % n, out)


_ORIG_ALLOC = None
_ORIG_ADMIT = None


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_tasks",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    global _ORIG_ALLOC, _ORIG_ADMIT
    from repro_torch.core import allocation
    from repro_torch.kernels.flex_score import ops, ref

    if fault == "state_unchanged":
        monkeypatch.setattr(ref, "commit_one", _no_commit)
    elif fault == "half_the_tasks":
        _ORIG_ALLOC = allocation.wfs_allocate
        monkeypatch.setattr(allocation, "wfs_allocate", _half_alloc)
    else:
        _ORIG_ADMIT = ops.flex_admit_queue
        monkeypatch.setattr(ops, "flex_admit_queue", _moved)
    config, traffic, cluster, drain, _ = CASES["study"]
    base = make_checkout(tmp_path, config, traffic, "t.cell", cluster, drain,
                         LOADED)
    cell = harness.load_cell("t.cell", base)
    line = harness.run(cell, 3, 0.1, False, torch.device("cpu"), 0.0)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] == line["attempted"]
