"""The readings that the limits of a cell's checks are set from.

    python3 flexbench/readings.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--out readings.json]

For each seed, one process builds the cell as a run does, runs one whole
study and judges it against the plain reference: the program's
readings.  On the control seeds the same pass also reads the control,
the reference in bfloat16 put in the program's place.  The limits in the
configuration's file lie between the largest reading of the program and
the smallest of the control.  Prints one JSON object per seed and writes
them all to ``--out``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from flexbench import harness  # noqa: E402


def main(argv) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        su = harness.setup(cell, seed, dev)
        setup_s = time.perf_counter() - t0
        from repro_torch.api import admission
        admission.reset_decisions()
        t0 = time.perf_counter()
        res = su.exp.run(seeds=su.seed)
        torch.cuda.synchronize(dev)
        study_s = time.perf_counter() - t0
        decisions = admission.DECISIONS
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers, work = harness.judge(cell, su, res, dev,
                                      control=seed in control)
        row = {"seed": seed, "setup_s": setup_s, "study_s": study_s,
               "decisions": decisions, "tasks": len(su.trace["arrival"]),
               "judge_s": time.perf_counter() - t0, "numbers": numbers,
               "queues": work["queues"], "reclaim": work["reclaim"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del su, res
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
