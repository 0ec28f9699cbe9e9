"""The benchmark's cells and its result line, on the CPU at a tiny size."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flexbench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_follows_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["flexbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("flexbench/") and (ROOT / c["file"]).exists()
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
        assert json.loads((ROOT / c["file"]).read_text())["source"] == \
            c["source"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "flexbench" / "metrics" / f"{m['name']}.py").exists()
    for n in names + CELLS:
        assert NAME.match(n)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    ref = harness.reference(cell)
    assert callable(ref.check)
    assert {"decision_gap", "series_gap", "count_mismatch"} <= set(
        cell.config["limits"]) <= {"decision_gap", "series_gap",
                                   "count_mismatch", "qos_ok_mismatch"}
    e2e = harness.metrics_of(cell, trace=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness.metrics_of(cell, trace=True)
    for m in e2e + harness.metrics_of(cell, trace=True):
        path = ROOT / "flexbench" / "metrics" / f"{m['name']}.py"
        assert callable(harness._module(path, "m").read)


def test_a_cell_defined_only_in_a_temporary_folder_runs(tiny_study):
    cell = harness.load_cell("tiny.study", tiny_study)
    line = harness.run(cell, 2 ** 33 + 5, 0.2, False, torch.device("cpu"),
                       0.0)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"decisions_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_a_traced_run_gives_the_trace_keys(tiny_reclaim):
    cell = harness.load_cell("tiny.reclaim", tiny_reclaim)
    line = harness.run(cell, 7, 0.2, True, torch.device("cpu"), 0.0)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run has no device events: every device reader finds nothing
    assert set(line["metrics"]) <= {"sweeps_per_slot"}
    assert line["correct"] is True


RUN_TINY = """
import json, sys, time, torch
sys.path[:0] = [{src!r}, {root!r}]
from flexbench import harness
cell = harness.load_cell("tiny.study", __import__("pathlib").Path({base!r}))
line = harness.run(cell, 11, 0.1, False, torch.device("cpu"), time.perf_counter())
print(json.dumps({{"correct": line["correct"],
                   "held": harness.forbidden_modules(),
                   "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_the_harness_process_loads_neither_jax_nor_the_jax_package(
        tiny_study):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-c", RUN_TINY.format(src=str(ROOT / "src"),
                                               root=str(ROOT),
                                               base=str(tiny_study))],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["held"] == []
    tops = set(res["tops"])
    # compared whole: the port's name begins with the JAX package's
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("held", ["jax", "repro.core"])
def test_a_process_holding_jax_prints_no_result(monkeypatch, capsys, held):
    import types
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run", lambda *a, **k: {
        "correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, held, types.ModuleType(held))
    rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert held.split(".")[0] in out.err


def test_harness_sources_import_nothing_of_the_jax_side():
    for path in (ROOT / "flexbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & {"jax", "jaxlib", "flax", "repro",
                                    "benchmarks", "chip_smoke"}, path


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((ROOT / "flexbench" / "reference"
                      / "flexsim.py").read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "typing", "numpy", "torch"}


def _run_py(cwd, extra_env=None):
    env = dict(os.environ, PYTHONPATH="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "flexbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=120)


def test_no_cuda_device_means_no_result():
    out = _run_py(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "flexbench", tmp_path / "flexbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
