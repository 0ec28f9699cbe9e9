"""Render ROOFLINE_TABLE.md from the port's dry-run records (port of
``repro.launch.report``).

  PYTHONPATH=src python -m repro_torch.launch.report \
      [--dir artifacts/dryrun_torch] [--out ROOFLINE_TABLE_torch.md]
"""
from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path


def render(art_dir: str) -> str:
    lines = [
        "# Roofline table (generated from the PyTorch port's dry-run "
        "records)",
        "",
        "Terms in seconds per step (per GPU, from the aten ops and "
        "collectives one device runs on its shards; H100 constants in "
        "`repro_torch/launch/roofline.py`); `mfu<=` = MODEL_FLOPS / "
        "(GPUs * peak * max-term).",
        "",
    ]
    for mesh in ("pod16x16", "pods2x16x16"):
        rows = []
        for f in sorted(glob.glob(f"{art_dir}/*__{mesh}.json")):
            r = json.load(open(f))
            if not r.get("ok"):
                rows.append(f"| {r['arch']} | {r['shape']} | FAIL: "
                            f"{r.get('error', '?')[:60]} |||||||")
                continue
            ro = r["roofline"]
            m = r["memory"]
            rows.append(
                f"| {r['arch']} | {r['shape']} | {ro['t_compute_s']:.3g} "
                f"| {ro['t_memory_s']:.3g} | {ro['t_collective_s']:.3g} "
                f"| {ro['dominant']} | {ro['mfu_upper_bound']:.4f} "
                f"| {ro['useful_flops_ratio']:.3f} "
                f"| {m['peak_bytes_per_device'] / 2**30:.2f} |")
        if rows:
            lines += [
                f"## mesh {mesh} "
                f"({'256 GPUs' if mesh == 'pod16x16' else '512 GPUs, 2 pods'})",
                "",
                "| arch | shape | t_compute | t_memory | t_collective "
                "| bound | mfu<= | useful | peak GiB |",
                "|---|---|---|---|---|---|---|---|---|",
                *rows,
                "",
            ]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--out", default="ROOFLINE_TABLE_torch.md")
    args = ap.parse_args()
    Path(args.out).write_text(render(args.dir))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
