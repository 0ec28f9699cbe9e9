"""Time one run of the slot simulator from a given source tree, on the card.

Runs ``chip_smoke.py``'s phase 3 cluster and trace (4000 nodes, flex-f)
from the ``repro_torch`` package under ``--src`` (this checkout's by
default): the sequential study through the queue kernel, the first 2
slots through the plain hooks, and the wavefront study (``topk=8``),
each once to warm up and once timed on the host clock.  Prints one JSON
line.  To compare two trees, run it for each in turn in one call, for
example parent, change, change, parent:

    python3 scripts/study_ab.py --src build/parent/src --tag parent
    python3 scripts/study_ab.py --tag change
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--seq-slots", type=int, default=6)
    ap.add_argument("--plain-slots", type=int, default=2)
    ap.add_argument("--wave-slots", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    from repro_torch.api import Experiment, admission
    from repro_torch.core import SimConfig
    from repro_torch.traces import generate_calibrated

    if not torch.cuda.is_available():
        print("study_ab: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    base = dict(n_nodes=4000, arrivals_per_slot=4096, retry_capacity=1024)
    ts = generate_calibrated(0, 4000, 24, 1.6, device=dev)
    out = {"tag": args.tag, "src": args.src}
    for name, cfg in (
            ("sequential", SimConfig(**base, n_slots=args.seq_slots,
                                     use_kernel=True)),
            ("plain", SimConfig(**base, n_slots=args.plain_slots)),
            ("wavefront", SimConfig(**base, n_slots=args.wave_slots,
                                    admission_mode="wavefront"))):
        exp = Experiment(ts, cfg, "flex-f", device=dev)
        exp.run(seeds=0)
        torch.cuda.synchronize()
        admission.reset_decisions()
        t0 = time.perf_counter()
        res = exp.run(seeds=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = dict(decisions=admission.DECISIONS,
                   decisions_per_s=admission.DECISIONS / wall,
                   ms_per_slot=wall * 1e3 / cfg.n_slots,
                   placed=int((res.placement >= 0).sum()))
        if name == "plain":
            row["us_per_decision"] = wall * 1e6 / admission.DECISIONS
        if name == "wavefront":
            row.update(rounds=admission.ROUNDS, sweeps=admission.SWEEPS,
                       ms_per_round=wall * 1e3 / admission.ROUNDS)
        out[name] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
