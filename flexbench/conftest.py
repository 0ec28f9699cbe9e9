"""Fixtures of the benchmark's CPU tests: a tiny cell in a checkout of
its own, made of the benchmark's files and a small configuration."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

# The paper's cluster cut to a size a CPU test runs in a second: 16 nodes,
# 4 slots of at most 48 arrivals, 16 retries.
TINY_CLUSTER = {"n_nodes": 16, "n_slots": 4, "arrivals_per_slot": 48,
                "retry_capacity": 16}


def make_checkout(base: Path, config: str, traffic: str, cell: str,
                  cluster=None, drain_slots=None, trace=None) -> Path:
    """A checkout at ``base`` holding the benchmark's metrics, reference
    and peaks, and one cell ``cell``: the repository's configuration
    ``config`` cut to ``cluster`` under its traffic mix ``traffic``, with
    the mix's ``trace`` changed where given."""
    bench_dir = base / "flexbench"
    for part in ("metrics", "reference"):
        shutil.copytree(ROOT / "flexbench" / part, bench_dir / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "flexbench" / "peaks.json", bench_dir / "peaks.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "flexbench" / "configs"
                       / f"{config}.json").read_text())
    conf["cluster"].update(cluster or TINY_CLUSTER)
    conf["cluster"]["reclaim_pool"] = min(conf["cluster"]["reclaim_pool"],
                                          conf["cluster"]["arrivals_per_slot"])
    conf["name"] = "tiny"
    (bench_dir / "configs").mkdir()
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(conf))
    traf = json.loads((ROOT / "flexbench" / "traffic"
                       / f"{traffic}.json").read_text())
    if drain_slots is not None:
        traf["drain_slots"] = drain_slots
    traf["trace"].update(trace or {})
    (bench_dir / "traffic").mkdir()
    (bench_dir / "traffic" / "tiny-mix.json").write_text(json.dumps(traf))
    entry = next(c for c in bench["configs"] if c["name"] == config)
    bench["configs"] = [dict(entry, name="tiny",
                             file="flexbench/configs/tiny.json")]
    bench["workloads"] = [{"name": cell, "config": "tiny",
                           "traffic": "tiny-mix", "chips": 1,
                           "why": "a CPU test's cell"}]
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = [cell]
    (base / "BENCHMARK.json").write_text(json.dumps(bench))
    return base


@pytest.fixture
def tiny_study(tmp_path):
    return make_checkout(tmp_path, "flexf-4000", "study-1run", "tiny.study")


@pytest.fixture
def tiny_reclaim(tmp_path):
    return make_checkout(tmp_path, "flexf-reclaim-4000", "study-1run-drain",
                         "tiny.reclaim", drain_slots=2)
