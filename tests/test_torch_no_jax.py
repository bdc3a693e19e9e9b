"""fabber_core_tpu_torch never imports jax: every module of the port
imports in a fresh interpreter without jax entering sys.modules, and no
source file of the port has an import statement naming jax."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "fabber_core_tpu_torch"

_PROBE = """
import pkgutil, sys
import fabber_core_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    nmods = int(proc.stdout.split()[0])
    assert nmods >= 25, proc.stdout


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
