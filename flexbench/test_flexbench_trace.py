"""The trace readers' arithmetic on a synthetic trace."""
import json
from pathlib import Path

import pytest

from flexbench import devtrace, harness
from flexbench.devtrace import Event

ROOT = Path(__file__).resolve().parent.parent
PEAKS = json.loads((ROOT / "flexbench" / "peaks.json").read_text())
MS = 1_000_000  # ns

# Device: the queue kernel over [0, 4) ms, a sum overlapping it over
# [2, 6), a copy over [8, 9), two top-K kernels over [12, 13) and
# [13, 15); the host: an operator over [6, 8) and one over [9, 12).
DEV = [Event("void flex_admit_kernel<2, 256, true>(float const*)", 0,
             4 * MS),
       Event("indexing_backward_kernel<float>", 2 * MS, 4 * MS),
       Event("Memcpy DtoH (Device -> Pinned)", 8 * MS, 1 * MS),
       Event("void flex_batch_topk_kernel<2>(float const*)", 12 * MS, MS),
       Event("flex_batch_topk_merge(float const*)", 13 * MS, 2 * MS)]
HOST = [Event("aten::item", 6 * MS, 2 * MS),
        Event("aten::nonzero", 9 * MS, 3 * MS),
        Event("cudaStreamSynchronize", 9 * MS, 1 * MS)]


def ctx(work=None, dev=DEV, window_s=0.020):
    return {"slots": 10, "n_nodes": 4000, "peaks": PEAKS,
            "trace": {"window_s": window_s,
                      "busy_s": devtrace.busy_ns(dev) / 1e9, "device": dev},
            "counters": {"sweeps": 30},
            "work": work or {"queues": [4096, 0, 600],
                             "reclaim": [4096, 0]}}


def read(name, c):
    path = ROOT / "flexbench" / "metrics" / f"{name}.py"
    return harness._module(path, f"t_{name}").read(c)


def test_busy_time_is_the_union_of_device_intervals():
    assert devtrace.merged(DEV) == [(0, 6 * MS), (8 * MS, 9 * MS),
                                    (12 * MS, 15 * MS)]
    assert devtrace.busy_ns(DEV) == 10 * MS
    assert read("busy_ms_per_slot", ctx()) == pytest.approx(10 / 10)
    assert read("idle_share", ctx()) == pytest.approx(100 * (1 - 10 / 20))


def test_launches_leave_out_copies_and_fills():
    assert read("launches_per_slot", ctx()) == pytest.approx(4 / 10)


def test_queue_kernel_roofline_counts_each_queue_once():
    n, hbm, fp = 4000, PEAKS["hbm_bytes_per_s"], PEAKS["fp32_flops_per_s"]
    # 4096 tasks: bound by operations; 600: by bytes; 0: no queue
    least = 14 * 4096 * n / fp + (560 * n + 33 * 600) / hbm
    assert 14 * 600 * n / fp < (560 * n + 33 * 600) / hbm
    assert read("queue_kernel_roofline", ctx()) == pytest.approx(
        100 * least / 4e-3)


def test_topk_kernel_roofline_counts_each_pass_once():
    least = 13 * 4096 * 4000 / PEAKS["fp32_flops_per_s"]
    assert read("topk_kernel_roofline", ctx()) == pytest.approx(
        100 * least / 3e-3)


@pytest.mark.parametrize("name", ["queue_kernel_roofline",
                                  "topk_kernel_roofline", "busy_ms_per_slot",
                                  "launches_per_slot", "idle_share"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert read(name, ctx(dev=[], work={"queues": [], "reclaim": []})) \
        is None
    assert read(name, {"slots": 1}) is None


def test_sweeps_per_slot_reads_the_counter():
    assert read("sweeps_per_slot", ctx()) == pytest.approx(3.0)


def test_the_breakdown_names_ops_and_gaps():
    ops = devtrace.top_ops(DEV)
    assert ops[0] == ["void flex_admit_kernel<2, 256, true>(float const*)",
                      pytest.approx(0.004)]
    assert len(ops) == 5
    gaps = devtrace.idle_gaps(DEV, HOST)
    assert gaps == [["aten::nonzero", pytest.approx(0.003)],
                    ["aten::item", pytest.approx(0.002)]]


def test_end_to_end_readers():
    c = {"window": {"seconds": 4.0, "decisions": 36000, "studies": 3},
         "setup_s": 12.5}
    assert read("decisions_per_s", c) == pytest.approx(9000.0)
    assert read("setup_s", c) == 12.5
    assert read("decisions_per_s", {}) is None
