"""What ``chip_smoke.SSD_BWD_HILO_TOL`` is there to catch.

Runs phase v of ``chip_smoke.py`` (the SSD backward against its plain
version) on a copy of this checkout whose bf16 backward keeps only the hi
half of every hi + lo bf16 pair (``split`` in ``csrc/ssd_tc.cuh`` writes
lo = 0), so that every product of a computed float32 operand runs in plain
bf16.  Every tolerance is opened in the copy, so each case logs its
errors.  Exits 0 when some bf16 case's da or ddt lies above
``SSD_BWD_HILO_TOL`` (the bound catches the cut), 1 when none does.

Needs a CUDA card and nvcc.  From the repository root:

    python3 scripts/ssd_bwd_lo_cut.py
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = "src/repro_torch/kernels/ssd_scan/csrc/ssd_tc.cuh"
LO = "  lo = pack(v0 - __low2float(h2), v1 - __high2float(h2));"
PHASE_V = ("import sys, torch; sys.path.insert(0, 'src'); "
           "import chip_smoke as cs; cs.SSD_BWD_HILO_TOL = 1.0; "
           "cs.SSD_BWD_TOL = dict.fromkeys(cs.SSD_BWD_TOL, 1.0); "
           "cs.ssd_bwd_vs_plain(torch.device('cuda'))")


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "repo"
        shutil.copytree(ROOT, copy,
                        ignore=shutil.ignore_patterns(".git", "build"))
        header = copy / HEADER
        text = header.read_text()
        if text.count(LO) != 1:
            raise SystemExit(f"{HEADER}: the line that makes lo is not "
                             f"found once")
        header.write_text(text.replace(LO, "  lo = pack(0.f, 0.f);"))
        run = subprocess.run([sys.executable, "-c", PHASE_V], cwd=copy,
                             capture_output=True, text=True)
    sys.stdout.write(run.stdout)
    sys.stderr.write(run.stderr)
    if run.returncode:
        return run.returncode
    worst = 0.0
    for line in run.stdout.splitlines():
        m = re.search(r"bfloat16: .*\bda ([^,]+), ddt (\S+) of", line)
        if m:
            worst = max(worst, float(m[1]), float(m[2]))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SSD_BWD_HILO_TOL
    caught = worst > SSD_BWD_HILO_TOL
    print(f"lo halves cut: da and ddt up to {worst:.2e} of max(1, max "
          f"|plain|); SSD_BWD_HILO_TOL {SSD_BWD_HILO_TOL:.3g}: "
          f"{'caught' if caught else 'not caught'}")
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
