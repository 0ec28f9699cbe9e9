"""Run some of ``chip_smoke.py``'s phases alone, for work on one of them.

Builds the kernels, then runs the named phases in the order given, with
the settings ``chip_smoke.main`` runs them under.  It prints no result
line and stands in for no run of ``chip_smoke.py``: the phases that
others feed (3 to u) are not offered, except as phase 6's feeders (``6``
runs phases 3, b, f and 6).  Phases 2, a and 6 alone build only the
flex_score kernels.  Needs a CUDA card and nvcc.  From the repository
root:

    python3 scripts/chip_phase.py x y
    python3 scripts/chip_phase.py y z
    python3 scripts/chip_phase.py 2 a 6
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _queue_phase(dev):
    """Phase 2: the pick kernel, then the queue kernel."""
    return cs.queue_kernel_vs_plain(dev, cs.kernel_vs_plain(dev))


def _study_phase(dev):
    """Phase 6 with the phases that feed it: 3, b and f."""
    _, ts, res_seq, seq_rate, res_plain = cs.slice_end_to_end(dev)
    _, res_wave = cs.wavefront_study(dev, ts, res_seq)
    round_ms = cs.profile_wavefront(dev)
    return cs.batched_study(dev, ts, res_seq, seq_rate, res_plain, res_wave,
                            round_ms)


PHASES = {"g": cs.flash_vs_plain, "k": cs.ssd_vs_plain,
          "v": cs.ssd_bwd_vs_plain, "x": cs.flash_bwd_vs_plain,
          "w": cs.train_end_to_end, "y": cs.train_attention_families,
          "z": cs.train_on_mesh, "2": _queue_phase,
          "a": cs.batch_kernels_vs_plain, "6": _study_phase}
FLEX_PHASES = {"2", "a", "6"}


def main(names) -> int:
    if (not names or any(n not in PHASES for n in names)
            or ("z" in names and "y" not in names[:names.index("z")])):
        print(f"usage: chip_phase.py PHASE... (of {', '.join(PHASES)}; z "
              f"after y, whose runs it repeats on a mesh)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phase: no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"[device] nvidia-smi: {cs.card_line()}")
    t0 = time.perf_counter()
    flex_only = set(names) <= FLEX_PHASES
    cs._log_build(_build.build_all(
        [n for n in _build.sources() if n.startswith("flex_score")]
        if flex_only else None), t0)
    out = {}
    for name in names:
        t1 = time.perf_counter()
        args = (out["y"][2],) if name == "z" else ()
        out[name] = PHASES[name](torch.device("cuda"), *args)
        cs.log(f"[time] phase {name}: {time.perf_counter() - t1:.1f} s")
    cs.log(f"chip_phase: phases {', '.join(names)} alone, not a smoke run")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
