"""The PyTorch port and chip_smoke.py stand alone: importing every module
of radnerf_tpu_torch, and loading chip_smoke.py as a module (without
running main), pulls in neither JAX nor any module of radnerf_tpu."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import radnerf_tpu_torch
for m in pkgutil.walk_packages(radnerf_tpu_torch.__path__,
                               "radnerf_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "radnerf_tpu"))
print("modules", len([m for m in sys.modules
                      if m.startswith("radnerf_tpu_torch")]))
print("BAD", bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[-1] == "BAD []", res.stdout
    n_modules = int(lines[-2].split()[1])
    # the package, its sub-packages and modules, the examples included: a
    # module that stops importing lowers the count
    assert n_modules >= 82
