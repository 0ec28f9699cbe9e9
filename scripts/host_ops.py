"""Count the PyTorch operator calls of one run's admission, on the CPU.

For the ``repro_torch`` package under ``--src`` (this checkout's by
default), admits one queue of ``--tasks`` tasks on a ``--nodes``-node
table three ways, each once to warm up and once counted: wavefront
rounds (``topk=8``), and the plain hooks of flex-f and of least-fit one
decision at a time.  The count is of the operators the program calls
(a ``TorchDispatchMode``), not of those an operator calls inside itself,
such as the CPU's casts of mixed-precision operands.  Prints one JSON
line: the calls per round or per decision, in all and less views (the
calls that do work), and the rounds.  The count does not depend on the
machine, so it compares two trees without the card; it is a count of
host calls, not a device figure.  For example, parent against change:

    python3 scripts/host_ops.py --src build/parent/src --tag parent
    python3 scripts/host_ops.py --tag change
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--tasks", type=int, default=256)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.api import admission, get_policy
    from repro_torch.core.types import FlexParams, NodeState

    torch.set_num_threads(1)
    gen = torch.Generator().manual_seed(4)
    u = lambda *shape: torch.rand(shape, generator=gen)
    n, q = args.nodes, args.tasks
    node = NodeState.zeros(n, device="cpu")._replace(
        est_usage=u(n, 2) * 0.5, requested=u(n, 2) * 0.9,
        n_tasks=(u(n) * 8).to(torch.int32),
        src_count=(u(n, 64) * 2).to(torch.int32))
    queue = (u(q, 2) * 0.1, (u(q) * 64).to(torch.int32),
             torch.zeros(q, dtype=torch.int32), torch.ones(q, dtype=torch.bool))
    params = FlexParams.default(device="cpu")
    penalty = torch.tensor(1.2)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = self.views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls += 1
            self.views += bool(func.is_view)
            return func(*args, **(kwargs or {}))

    def counted(name, per, **kw):
        policy = get_policy(name)
        admission.admit_queue(policy, node, *queue, penalty, params, **kw)
        admission.reset_decisions()
        with Count() as c:
            admission.admit_queue(policy, node, *queue, penalty, params, **kw)
        div = per()
        return dict(calls=c.calls / div, work=(c.calls - c.views) / div)

    out = {"tag": args.tag, "src": args.src, "nodes": n, "tasks": q}
    out["wavefront_round"] = counted("flex-f", lambda: admission.ROUNDS,
                                     batch_mode=True)
    out["wavefront_round"]["rounds"] = admission.ROUNDS
    for name in ("flex-f", "least-fit"):
        out[f"plain_decision_{name}"] = counted(name, lambda: q)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
