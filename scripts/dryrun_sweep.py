"""The dry run's whole sweep: every (arch x production mesh) of
``repro_torch.launch.dryrun`` in a process of its own, ``--jobs`` at a
time, on the host with no GPU visible; then one line per cell record and
the roofline table (``repro_torch.launch.report``).

From the repository root:

    python3 scripts/dryrun_sweep.py [--archs mixtral-8x7b,zamba2-7b]
        [--jobs 8] [--timeout 600] [--out artifacts/dryrun_torch]

Exits 1 if a cell failed or a process did not finish in ``--timeout``
seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MESHES = (("pod16x16", "--single-pod-only"),
          ("pods2x16x16", "--multi-pod-only"))


def _one(arch: str, flag: str, out: Path, timeout: float) -> tuple:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, flag, "--out", str(out)], env=env, capture_output=True,
            text=True, timeout=timeout)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("[")]
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        lines, rc = [f"[FAIL] {arch} {flag}: over {timeout} s"], -1
    return arch, flag, rc, time.perf_counter() - t0, lines


def _line(rec: dict) -> str:
    head = f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:12s}"
    if not rec["ok"]:
        return f"{head} FAIL {rec.get('error', '?')[:160]}"
    r, m = rec["roofline"], rec["memory"]
    return (f"{head} ok accum {rec['accum']:3d} "
            f"t_compute {r['t_compute_s'] * 1e3:11.2f} ms "
            f"t_memory {r['t_memory_s'] * 1e3:11.2f} ms "
            f"t_collective {r['t_collective_s'] * 1e3:12.2f} ms "
            f"{r['dominant']:10s} useful {r['useful_flops_ratio']:.3f} "
            f"mfu<= {r['mfu_upper_bound']:.4f} peak "
            f"{m['peak_bytes_per_device'] / 2 ** 30:8.2f} GiB "
            f"(build {rec['build_s']} s, run {rec['run_s']} s)")


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.report import render

    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ARCH_IDS))
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    out = Path(args.out)
    archs = args.archs.split(",")
    jobs = [(a, flag) for a in archs for _, flag in MESHES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        done = list(pool.map(lambda j: _one(*j, out, args.timeout), jobs))
    failed = 0
    for arch, flag, rc, wall, lines in done:
        failed += rc != 0
        print(f"[sweep] {arch} {flag}: exit {rc} in {wall:.1f} s")
        for ln in lines:
            print(f"[sweep]   {ln}")
    mesh_names = [name for name, _ in MESHES]
    recs = []
    for f in sorted(out.glob("*.json")):
        rec = json.loads(f.read_text())
        if rec["arch"] in archs and rec["mesh"] in mesh_names:
            recs.append(rec)
            print(f"[cell] {_line(rec)}")
    n_ok = sum(r["ok"] for r in recs)
    print(f"[sweep] {len(recs)} cells, {n_ok} ok, {len(recs) - n_ok} failed,"
          f" {len(jobs)} processes ({args.jobs} at a time) in "
          f"{time.perf_counter() - t0:.1f} s")
    table = render(str(out))
    (out / "ROOFLINE_TABLE_torch.md").write_text(table)
    print(table)
    return 1 if failed or n_ok < len(recs) else 0


if __name__ == "__main__":
    sys.exit(main())
