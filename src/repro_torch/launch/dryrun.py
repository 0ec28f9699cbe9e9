"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on
``meta`` tensors, as one device of the mesh sees it (port of
``repro.launch.dryrun``).

Where the reference lowers and compiles each cell for 512 placeholder
TPU devices, this runs the cell's step once (train, prefill or decode)
on ``meta`` DTensors under a fake process group (``launch.mesh``: one
512-rank ``FakeStore`` world; the single-pod mesh is its first 256
ranks), as rank 0, and records what rank 0 runs (``roofline.
OpRecorder``).  Nothing is allocated and no data moves.  The records
keep the reference's keys: ``memory.peak_bytes_per_device`` (the peak of
live local bytes, the step's arguments included), ``hlo`` (the analyzed
ops: per-device flops, bytes, collective bytes by kind) and
``roofline``.  The hand-written kernels run as stand-ins on the meta
tensors, charged with the kernels' own flops and bytes
(``roofline`` module docstring), so the attention and SSD terms are the
card's path's.  The collective bytes are DTensor's own redistributions,
not GSPMD's.  Every family runs its cells; a cell that raises records
its error, and any failed cell makes the CLI exit 1.

Usage:
  python -m repro_torch.launch.dryrun                 # every cell, both meshes
  python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k
  python -m repro_torch.launch.dryrun --multi-pod-only / --single-pod-only
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import init_distributed, make_production_mesh
from repro_torch.launch.specs import build_cell, model_flops

WORLD = 512     # both production meshes draw from one fake world


def run_cell(cfg, shape, mesh, mesh_name: str, out_dir: Path,
             accum=None) -> dict:
    cell_id = f"{cfg.name}__{shape.name}__{mesh_name}"
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
           "kind": shape.kind, "n_chips": mesh.size(), "ok": False}
    try:
        t0 = time.time()
        step, args, meta = build_cell(cfg, shape, mesh, accum=accum)
        rec.update(meta)
        rec["build_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        recorder = roofline.OpRecorder()
        arg_bytes = recorder.hold(args)
        kw = {"repeat": recorder.repeat} if shape.kind == "train" else {}
        with recorder:
            out = step(*args, **kw)
        rec["run_s"] = round(time.time() - t0, 2)
        del out
        rec["memory"] = {"argument_bytes": int(arg_bytes),
                         "peak_bytes_per_device": int(recorder.peak_bytes)}
        an = roofline.analyze(recorder.records)
        rec["n_ops"] = len(recorder.records)
        rec["hlo"] = {k: (v if not isinstance(v, dict) else
                          {kk: float(vv) for kk, vv in v.items()})
                      for k, v in an.items()}
        mf = model_flops(cfg, shape, rec["total_params"],
                         rec["active_params"])
        rec["model_flops"] = mf
        rec["roofline"] = roofline.roofline_terms(
            an["flops"], an["bytes"], an["collective_bytes"], mf,
            mesh.size())
        rec["ok"] = True
    except Exception as e:  # record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=12)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell_id}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--shape", default=None, help="single shape name")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    init_distributed("fake", world_size=WORLD, rank=0)
    out_dir = Path(args.out)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(("pod16x16", make_production_mesh(multi_pod=False)))
    if not args.single_pod_only:
        meshes.append(("pods2x16x16", make_production_mesh(multi_pod=True)))

    archs = [args.arch] if args.arch else ARCH_IDS
    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            if args.shape and shape.name != args.shape:
                continue
            for mesh_name, mesh in meshes:
                t0 = time.time()
                rec = run_cell(cfg, shape, mesh, mesh_name, out_dir,
                               accum=args.accum)
                status = "OK " if rec["ok"] else "FAIL"
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
                if rec["ok"]:
                    r = rec["roofline"]
                    extra = (f"bound={r['dominant']:<10} "
                             f"mfu<={r['mfu_upper_bound']:.3f} "
                             f"peak={rec['memory']['peak_bytes_per_device'] / 2**30:.2f}GiB")
                else:
                    extra = rec["error"][:120]
                print(f"[{status}] {arch:24s} {shape.name:12s} "
                      f"{mesh_name:12s} {time.time() - t0:7.1f}s {extra}",
                      flush=True)
    print(f"dry-run complete: {n_ok} ok, {n_fail} failed", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
