"""fabber_core_tpu_torch never imports jax nor the JAX package: every
module of the port (the generic mode's models/kernelgen.py, the
examples/ plugin, the C API's backend and builder, the tools, .fab
files and the self-test harness among them) imports in a fresh
interpreter without jax or fabber_core_tpu entering sys.modules, no
source file of the port, nor chip_smoke.py, has an import statement
naming either, and the port's C shim and C host import only the
port."""

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "fabber_core_tpu"))
print(len(names), bad, " ".join(names))
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
    names = proc.stdout.split()
    for mod in ("models.kernelgen", "examples.fwdmodel_exp",
                "ops.fused_loop_nl", "ops.fused_vb", "capi", "capi_backend",
                "fabfile", "selftest", "tools.mvntool", "tools.fabber_var",
                "tools.niftidiff"):
        assert f"fabber_core_tpu_torch.{mod}" in names, proc.stdout


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []


def test_port_sources_have_no_jax_package_import():
    """Neither `import fabber_core_tpu` nor `from fabber_core_tpu.` (nor
    `from fabber_core_tpu import`) in the port or chip_smoke.py."""
    pat = re.compile(r"^\s*(import\s+fabber_core_tpu\b(?!_torch)"
                     r"|from\s+fabber_core_tpu(\.|\s))", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert offenders == []
    assert pat.search("from fabber_core_tpu.models import x")
    assert pat.search("import fabber_core_tpu")
    assert not pat.search("from fabber_core_tpu_torch.models import x")


def test_port_c_sources_import_only_the_port():
    """The shim embeds an interpreter and imports the backend by name:
    the port's own (fabber_core_tpu_torch.capi_backend), never the JAX
    package's; the C host runs no import of its own."""
    shim = (PKG / "capi" / "fabber_capi_torch.cc").read_text()
    imports = re.findall(r'PyImport_ImportModule\("([^"]+)"\)', shim)
    assert imports == ["fabber_core_tpu_torch.capi_backend"]
    host = (PKG / "capi" / "test_host.c").read_text()
    assert "PyImport_ImportModule" not in host
    assert not re.search(r"import\s+(jax|fabber_core_tpu)\b", host)
