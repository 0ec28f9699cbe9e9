"""The port imports neither JAX nor anything of the JAX package, nor
``ml_dtypes`` (which the card's machine does not have)."""
import importlib
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"

# Each entry package is imported first into a clean module table (torch
# stays loaded), then every module: an import cycle shows as an
# ImportError on one of these orders.
FIRST = ["repro_torch", "repro_torch.core", "repro_torch.api",
         "repro_torch.estimators", "repro_torch.traces",
         "repro_torch.kernels.flex_score", "repro_torch.convert",
         "repro_torch.configs", "repro_torch.models", "repro_torch.serving",
         "repro_torch.launch", "repro_torch.kernels.flash_attention",
         "repro_torch.kernels.ssd_scan", "repro_torch.train",
         "repro_torch.faults", "repro_torch.migration", "repro_torch.guard"]

_CHECK = r"""
import importlib, pkgutil, sys
for first in sys.argv[1:]:
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    importlib.import_module(first)
    import repro_torch
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    for name in names:
        importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
                or m == "repro" or m.startswith("repro.")
                or m == "ml_dtypes" or m.startswith("ml_dtypes."))
print(len(names), leaked)
"""


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _CHECK, *FIRST],
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.strip().split(" ", 1)
    assert int(count) == len(_modules()) >= 70
    assert leaked == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_names_no_jax_or_reference_package(path):
    text = path.read_text()
    for pattern in (r"^\s*import\s+jax", r"^\s*from\s+jax",
                    r"^\s*from\s+repro[.\s]", r"^\s*import\s+repro[.\s]"):
        assert not re.search(pattern, text, re.M), (path, pattern)


def test_every_module_imports_here():
    for name in _modules():
        importlib.import_module(name)
