"""Build and bind the port's CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc into a plain-C shared
library under <repo>/build/kernels/, named by a hash of the sources and
flags (so an edited source rebuilds and a fresh checkout builds from
nothing), and loaded with ctypes. Every pointer and the stream pass as
ctypes.c_void_p; each C entry point returns cudaGetLastError() after its
launch and a non-zero value raises here.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..exceptions import FabberError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("spectral_stats.cu", "spectral_core.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""   # nvcc's output (incl. -Xptxas -v) of this process's build


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise FabberError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                      "are built from csrc/ at first use")


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfabber_spectral_{h.hexdigest()[:16]}.so"


def build():
    """Compile the kernels if this source hash has no library yet.
    Returns the library path; raises with nvcc's stderr on failure."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise FabberError(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fabber_spectral_stats.argtypes = [
            i32, vp, vp, vp, i32, i64, vp, vp, vp, vp]
        lib.fabber_spectral_stats.restype = i32
        lib.fabber_spectral_core.argtypes = [
            i32, i32, vp, vp, vp, vp, vp, i64] + [vp] * 7 + [vp]
        lib.fabber_spectral_core.restype = i32
        _lib = lib
    return _lib


def _raise_on(err, name):
    if err != 0:
        raise FabberError(f"{name} launch failed: CUDA error {err}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def launch_stats(p, data, tconsts, aconsts, m0, rtqr, dtqr):
    lib = load()
    nt, nv = data.shape
    with torch.cuda.device(data.device):
        err = lib.fabber_spectral_stats(
            p, data.data_ptr(), tconsts.data_ptr(), aconsts.data_ptr(),
            nt, nv, m0.data_ptr(), rtqr.data_ptr(), dtqr.data_ptr(),
            _stream(data.device))
    _raise_on(err, "spectral_stats")


def launch_core(p, n_iters, m0, rtqr, dtqr, pm, consts, outs):
    lib = load()
    nv = m0.shape[-1]
    with torch.cuda.device(m0.device):
        err = lib.fabber_spectral_core(
            p, n_iters, m0.data_ptr(), rtqr.data_ptr(), dtqr.data_ptr(),
            pm.data_ptr(), consts.data_ptr(), nv,
            *(o.data_ptr() for o in outs), _stream(m0.device))
    _raise_on(err, "spectral_core")
