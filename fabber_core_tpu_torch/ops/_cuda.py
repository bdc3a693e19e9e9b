"""Build and bind the port's CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc, one process per
source, all started together (10.9 s on an H100 host for the first
four sources, against 29.3 s for one nvcc over them), and linked into one plain-C shared
library under <repo>/build/kernels/, named by a hash of the sources,
the shared header and the flags (so an edited source rebuilds and a
fresh checkout builds from nothing). The library is loaded with ctypes.
Every pointer and the stream pass as ctypes.c_void_p; each C entry
point returns cudaGetLastError() after its launch and a non-zero value
raises here.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..exceptions import FabberError
from .fused_spectral import PREBUILT_MAX_P
from .fused_whole import SMEM_BYTES as MAX_BLOCK_SMEM

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("spectral_stats.cu", "spectral_core.cu", "spectral_fused.cu",
           "fused_nl_loop.cu", "fused_vb_iter.cu", "fused_whole.cu",
           "fused_loop.cu", "fused_nlls.cu", "fused_ar_loop.cu")
HEADERS = ("vb_device.cuh", "detectors.cuh", "spectral_device.cuh",
           "fused_nl_loop.cuh", "fused_vb_iter.cuh", "fused_nlls.cuh",
           "dual.cuh", "tile.cuh", "whole_device.cuh", "coop_device.cuh",
           "fulltime.cuh",
           "fused_whole_body.inc", "fused_ar_loop_body.inc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source on top of NVCC_FLAGS: nvcc contracts no multiply-add
# of its own in the NLLS kernel, which writes its fused ones explicitly,
# so its fresh and two-phase modes compute the same bits (csrc/
# fused_nlls.cu), nor in the AR(1) kernel, which computes its plain
# version's float32 arithmetic (csrc/fused_ar_loop.cu)
SOURCE_FLAGS = {"fused_nlls.cu": ["-fmad=false"],
                "fused_ar_loop.cu": ["-fmad=false"]}

# Shared memory of an H100 (sm_90) SM and the runtime's reservation per
# block (the most one block may take is csrc/tile.cuh kMaxBlockSmem).
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1_024
# The staged tile's plan (tile_plan). One warp per block: a block's
# shared memory is freed when its one warp is done, so a straggler holds
# its own tile only (NVIDIA H100 80GB HBM3, T=100, probes/tile_vb.py:
# kernel 8 fresh Marquardt 34.86 ms at 32 lanes a block against 40.11 at
# 128, kernel 6 the same at every width). The tile is staged where at
# least TILE_MIN_WARPS such blocks fit an SM's shared memory: in the
# probe's T sweep five fit at T=300 and both kernels ran faster staged
# (kernel 6 17.69 against 18.38 ms, kernel 8 63.07 against 83.55), three
# at T=440 and both ran slower, with too few warps to hide latency.
TILE_VB = 32
TILE_MIN_WARPS = 5
STREAM_THREADS = 128       # the kernels' kThreads (streamed blocks)
# Kernel 1's staged widths, widest first (tile_plan's widths): each lane
# makes one pass of each kind, so no straggler holds a block's tile, and
# wider blocks ran faster (NVIDIA H100 80GB HBM3, T=106, P=3, 16,777,216
# voxels, probes/stats_tile.py: 16-byte tile copies 3.31 ms at 128 lanes
# a block against 3.54 at 64 and 3.68 at 32).
STATS_WIDTHS = (128, 64, 32)

# csrc/detectors.cuh DetectorKind
DETECTOR_CODES = {"maxits": 0, "pointzeroone": 1, "freduce": 2,
                  "trialmode": 3, "lm": 4}

_lib = None
build_log = ""   # nvcc's output (incl. -Xptxas -v) of this process's build
# libraries of generated model functors: build key -> loaded library
_gen_libs = {}
gen_build_log = {}   # source hash -> (seconds, nvcc's output)


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
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfabber_kernels_{h.hexdigest()[:16]}.so"


def _keep_log(out, text):
    """nvcc's output beside the library it built (<library>.log), so a
    later process that loads the library can still read it."""
    tmp = out.with_suffix(f".log.tmp{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, out.with_suffix(".log"))


def _kept_log(out):
    log = out.with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _compile_link(units, out):
    """Compile units ((name, .cu path, extra flags) each) with one nvcc
    process per unit, all started together, and link them into the
    shared library out (a temporary file, then os.replace). Returns
    nvcc's output, a "== name (nvcc S s)" head per unit; raises with
    nvcc's output when a unit or the link fails."""
    nvcc = _nvcc()
    objs, procs = [], []
    t0 = time.perf_counter()
    for name, src, flags in units:
        obj = out.parent / f"{out.stem}.{Path(name).stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-c", "-o",
               str(obj), str(src)]
        objs.append(obj)
        # nvcc's output to a file, so a full pipe stalls no compiler and
        # each source's seconds are its own
        text = obj.with_suffix(".txt")
        with open(text, "w") as fh:
            procs.append((name, cmd, text, subprocess.Popen(
                cmd, stdout=fh, stderr=subprocess.STDOUT)))
    secs = {}
    while len(secs) < len(procs):
        for name, _, _, proc in procs:
            if name not in secs and proc.poll() is not None:
                secs[name] = time.perf_counter() - t0
        time.sleep(0.05)
    logs, failed = [], []
    for name, cmd, text, proc in procs:
        output = text.read_text()
        text.unlink()
        logs.append(f"== {name} (nvcc {secs[name]:.1f} s)\n{output}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{output}")
    log = "\n".join(logs)
    if failed:
        for obj in objs:
            obj.unlink(missing_ok=True)
        raise FabberError("\n".join(failed))
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", str(tmp), *(str(o) for o in objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise FabberError(f"nvcc link failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stderr}")
    _keep_log(out, log)
    os.replace(tmp, out)
    return log


def build():
    """Compile the kernels if this source hash has no library yet.
    Returns the library path; raises with nvcc's stderr on failure.
    build_log holds nvcc's output, also when an earlier process built
    the library."""
    global build_log
    out = library_path()
    if out.exists():
        build_log = _kept_log(out) or build_log
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        build_log = _compile_link(
            [(name, CSRC / name, SOURCE_FLAGS.get(name, []))
             for name in SOURCES], out)
    except FabberError as e:
        build_log = str(e)
        raise
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float)
        lib.fabber_spectral_stats.argtypes = [
            i32, vp, vp, vp, i32, i64, vp, vp, vp, i32, vp]
        lib.fabber_spectral_stats.restype = i32
        lib.fabber_stats_occupancy.argtypes = [i32] * 3
        lib.fabber_stats_occupancy.restype = i32
        lib.fabber_spectral_core.argtypes = [
            i32, i32, vp, vp, vp, vp, vp, i32, f32, i32, i32, i32,
            i64] + [vp] * 7 + [vp]
        lib.fabber_spectral_core.restype = i32
        lib.fabber_fused_nl_loop.argtypes = [
            i32, i32, i32, vp, f32, i32, i32, f32, vp,
            i32, f32, i32, i32, i32, vp,
            vp, vp, vp, vp, vp, vp, i32, i64] + [vp] * 7 + [i32, vp]
        lib.fabber_fused_nl_loop.restype = i32
        lib.fabber_nl_occupancy.argtypes = [i32] * 6
        lib.fabber_nl_occupancy.restype = i32
        lib.fabber_fused_vb_iter.argtypes = [
            i32, i32, i32, vp, f32, i32,
            vp, vp, vp, vp, vp, vp, vp, i32, i64] + [vp] * 7 + [i32, vp]
        lib.fabber_fused_vb_iter.restype = i32
        lib.fabber_vb_iter_occupancy.argtypes = [i32] * 6
        lib.fabber_vb_iter_occupancy.restype = i32
        lib.fabber_nl_has_instance.argtypes = [i32, i32, i32]
        lib.fabber_nl_has_instance.restype = i32
        lib.fabber_spectral_fused.argtypes = [
            i32, i32, vp, vp, vp, i32, vp, vp, i32, f32, i32, i32, i32,
            i64] + [vp] * 7 + [i32, vp]
        lib.fabber_spectral_fused.restype = i32
        lib.fabber_fused_occupancy.argtypes = [i32] * 4
        lib.fabber_fused_occupancy.restype = i32
        lib.fabber_fused_whole.argtypes = [
            i32, i32, i32, f32, vp, i32, f32, i32, i32, i32, vp, vp, vp,
            i32, vp, vp, i64] + [vp] * 7 + [i32, vp]
        lib.fabber_fused_whole.restype = i32
        lib.fabber_whole_occupancy.argtypes = [i32] * 5
        lib.fabber_whole_occupancy.restype = i32
        lib.fabber_fused_vb_loop.argtypes = [
            i32, i32, i32, f32, vp, vp, vp, vp, vp, vp, i64] + [vp] * 5 \
            + [vp]
        lib.fabber_fused_vb_loop.restype = i32
        lib.fabber_loop_occupancy.argtypes = [i32] * 2
        lib.fabber_loop_occupancy.restype = i32
        lib.fabber_whole_has_instance.argtypes = [i32, i32]
        lib.fabber_whole_has_instance.restype = i32
        lib.fabber_fused_nlls.argtypes = [
            i32, i32, vp, f32, vp, i32, i32, i32, f32, vp, vp, vp, vp, i32,
            i64] + [vp] * 6 + [i32, vp]
        lib.fabber_fused_nlls.restype = i32
        lib.fabber_nlls_occupancy.argtypes = [i32] * 6
        lib.fabber_nlls_occupancy.restype = i32
        lib.fabber_nlls_has_instance.argtypes = [i32, i32]
        lib.fabber_nlls_has_instance.restype = i32
        lib.fabber_fused_ar_loop.argtypes = [
            i32, i32, i32, vp, i32, f32, i32, i32, i32, f32, f32, vp, vp, vp,
            vp, vp, i64] + [vp] * 10 + [vp]
        lib.fabber_fused_ar_loop.restype = i32
        lib.fabber_ar_has_instance.argtypes = [i32, i32]
        lib.fabber_ar_has_instance.restype = i32
        _lib = lib
    return _lib


# The head of a library built from a generated model functor: the
# kernel's header and the functor.
_GEN_HEAD = """// generated by fabber_core_tpu_torch/ops/_cuda.py build_generated: the
// {what} ({header}) with a model functor generated
// from a model (models/kernelgen.py) at P = {p}{qtext}.
{roll}#include "dual.cuh"
#include "{header}"

namespace {{
using namespace fabber::gen;
{source}
}}  // namespace
"""

# the C entry points of kernel 6 at the functor's P and the run's Q, its
# three MODEs
_GEN_NL_LOOP = """
// fabber_fused_nl_loop's arguments (fused_nl_loop.cu) without the kind,
// P and Q, which the library is built for, and with supp [NS,V] (device,
// null when NS = 0).
extern "C" int fabber_gen_nl_loop(
    const int* tcodes_host, int n_iters, int need_f, float locked_sd,
    const float* consts_host, int det_kind, float det_tol, int det_max_its,
    int det_max_trials, int det_init_save, const float* det_consts_host,
    const float* centre0, const float* pm, const float* pp, const float* pd0,
    const float* data, const float* supp, const float* qw, int nt,
    long long V, float* means, float* prec, float* cov, float* b, float* c,
    float* fkqk, float* ftr, int vb, void* stream) {{
  VBParamsFor<{p}, {q}> k;
  NLDetConstsFor<{q}> dc;
  const long long smem = nl_smem(vb, nt, {q});
  if (smem < 0 ||
      !nl_setup({p}, {q}, tcodes_host, 0.f, n_iters, need_f, locked_sd,
                consts_host, det_kind, det_tol, det_max_its, det_max_trials,
                det_init_save, det_consts_host, pd0, nt, V, &k, &dc) ||
      (GenModel::NS > 0 && supp == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* const ins[7] = {{centre0, pm, pp, pd0, data, supp, qw}};
  float* const outs[7] = {{means, prec, cov, b, c, fkqk, ftr}};
  return launch<GenModel, {q}>(k, dc, vb, smem, ins, outs,
                               static_cast<cudaStream_t>(stream));
}}

// fabber_nl_occupancy (fused_nl_loop.cu) for this library's functor and Q
extern "C" int fabber_gen_occupancy(int mode, int vb, int nt) {{
  const long long smem = nl_smem(vb, nt, {q});
  if (smem < 0 || mode < 0 || mode > 2) return -1;
  return occupancy<GenModel, {q}>(mode, vb, smem);
}}
"""

# the C entry points of kernel 6's full-time form (fused_nl_loop.cuh
# fused_nl_loop_full_kernel) at the full-time functor's P and the run's Q,
# its three MODEs
_GEN_NL_LOOP_FULL = """
// fabber_gen_nl_loop's arguments with the functor's constants cst (device,
// null when it has none) and no vb: a warp serves a voxel, its state in
// shared memory (FullLayout).
extern "C" int fabber_gen_nl_loop_full(
    const int* tcodes_host, int n_iters, int need_f, float locked_sd,
    const float* consts_host, int det_kind, float det_tol, int det_max_its,
    int det_max_trials, int det_init_save, const float* det_consts_host,
    const float* centre0, const float* pm, const float* pp, const float* pd0,
    const float* data, const float* supp, const float* qw, const float* cst,
    int nt, long long V, float* means, float* prec, float* cov, float* b,
    float* c, float* fkqk, float* ftr, void* stream) {{
  VBParamsFor<{p}, {q}> k;
  NLDetConstsFor<{q}> dc;
  if (!nl_setup({p}, {q}, tcodes_host, 0.f, n_iters, need_f, locked_sd,
                consts_host, det_kind, det_tol, det_max_its, det_max_trials,
                det_init_save, det_consts_host, pd0, nt, V, &k, &dc) ||
      (GenModel::NS > 0 && supp == nullptr) ||
      (GenModel::NCONST > 0 && cst == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* const ins[8] = {{centre0, pm, pp, pd0, data, supp, qw, cst}};
  float* const outs[7] = {{means, prec, cov, b, c, fkqk, ftr}};
  return launch_full<GenModel, {q}>(k, dc, ins, outs,
                                    static_cast<cudaStream_t>(stream));
}}

// the blocks per SM of MODE (0, 1, 2), -1 where refused
extern "C" int fabber_gen_full_occupancy(int mode) {{
  VBParamsFor<{p}, {q}> k = {{}};
  NLDetConstsFor<{q}> dc = {{}};
  k.nt = GenModel::NT;
  if (mode < 0 || mode > 2) return -1;
  dc.d.kind = mode == 0 ? fabber::kMaxits
                        : (mode == 1 ? fabber::kPointZeroOne
                                     : fabber::kTrialMode);
  int occ = 0;
  return launch_full<GenModel, {q}>(k, dc, nullptr, nullptr, nullptr,
                                    &occ) == 0 ? occ : -1;
}}

// the dynamic shared memory of a block (FullLayout), as fulltime_smem
extern "C" long long fabber_gen_full_smem() {{
  return FullLayout<GenModel, {q}>::bytes;
}}
"""

# the C entry points of kernel 7 at the functor's P and the run's Q, with
# and without its LM branch; the dt is the functor's own
_GEN_VB_ITER = """
// fabber_fused_vb_iter's arguments (fused_vb_iter.cu) without the kind,
// P, Q and dt, which the library and its functor are built for.
extern "C" int fabber_gen_vb_iter(
    const int* tcodes_host, int need_f, const float* centre, const float* pm,
    const float* pp, const float* phi, const float* data, const float* qw,
    const float* alpha, int nt, long long V, float* means, float* prec,
    float* cov, float* nkqk, float* ntr, float* fkqk, float* ftr, int vb,
    void* stream) {{
  const long long smem = iter_smem(vb, nt, {q});
  VBParamsFor<{p}, {q}> k;
  if (!iter_setup({p}, {q}, tcodes_host, 0.f, need_f, nt, V, smem, &k))
    return (int)cudaErrorInvalidValue;
  const float* const ins[7] = {{centre, pm, pp, phi, data, qw, alpha}};
  float* const outs[7] = {{means, prec, cov, nkqk, ntr, fkqk, ftr}};
  return launch<GenModel, {q}>(k, alpha != nullptr, vb, smem, ins, outs,
                               static_cast<cudaStream_t>(stream));
}}

// fabber_vb_iter_occupancy (fused_vb_iter.cu) for this library's functor
// and Q
extern "C" int fabber_gen_vb_iter_occupancy(int lm, int vb, int nt) {{
  const long long smem = iter_smem(vb, nt, {q});
  if (smem < 0) return -1;
  return occupancy<GenModel, {q}>(lm != 0, vb, smem);
}}

// 1 where this library compiled the cooperative form (kIterCoop), else 0
extern "C" int fabber_gen_vb_iter_coop() {{ return kIterCoop ? 1 : 0; }}
"""

# the C entry points of kernel 8 at the functor's P, every mode, with and
# without Marquardt damping; the dt is the functor's own
_GEN_NLLS = """
// fabber_fused_nlls's arguments (fused_nlls.cu) without the kind, P and
// dt, which the library and its functor are built for.
extern "C" int fabber_gen_nlls(
    const int* tcodes_host, const float* consts_host, int mode,
    int marquardt, int max_its, float dof, const float* params0,
    const float* data, const float* w, const float* state_in, int nt,
    long long V, float* params_out, float* cost_out, float* its_out,
    float* prec_out, float* cov_out, float* state_out, int vb,
    void* stream) {{
  const long long smem = nlls_smem(vb, nt);
  float* const outs[6] = {{params_out, cost_out, its_out, prec_out,
                          cov_out, state_out}};
  NLLSParamsFor<{p}> k;
  if (!nlls_setup({p}, tcodes_host, 0.f, consts_host, mode, max_its, dof,
                  state_in, nt, V, smem, outs, &k))
    return (int)cudaErrorInvalidValue;
  const float* const ins[4] = {{params0, data, w, state_in}};
  return launch<GenModel>(k, mode, marquardt, vb, smem, ins, outs,
                          static_cast<cudaStream_t>(stream), nullptr);
}}

// fabber_nlls_occupancy (fused_nlls.cu) for this library's functor
extern "C" int fabber_gen_nlls_occupancy(int mode, int marquardt, int vb,
                                         int nt) {{
  const long long smem = nlls_smem(vb, nt);
  if (smem < 0 || mode < kFresh || mode > kResume) return -1;
  return occupancy<GenModel>(mode, marquardt, vb, smem);
}}
"""

# kernel -> (what it is, its header, the entry points' template, the
# source whose SOURCE_FLAGS its library takes too)
GEN_KERNELS = {
    "nl_loop": ("whole-loop kernel", "fused_nl_loop.cuh", _GEN_NL_LOOP,
                "fused_nl_loop.cu"),
    "nl_loop_full": ("whole-loop kernel's full-time form",
                     "fused_nl_loop.cuh", _GEN_NL_LOOP_FULL,
                     "fused_nl_loop.cu"),
    "vb_iter": ("per-iteration VB kernel", "fused_vb_iter.cuh",
                _GEN_VB_ITER, "fused_vb_iter.cu"),
    "nlls": ("NLLS kernel", "fused_nlls.cuh", _GEN_NLLS, "fused_nlls.cu"),
}


def tile_plan(nt, nq, widths=(TILE_VB,), extra=0):
    """(staged, VB, smem bytes) of a launch of a kernel that stages its
    data tile (kernels 1, 3, 4, 6, 7 and 8, csrc/tile.cuh) at nt samples
    and nq weights per sample (Q groups for kernels 6 and 7, 1 for kernel
    8, the P + QP + Q design rows for kernel 4, the 2P + 1 for kernels 1
    and 3): blocks of the first VB of widths (TILE_VB; kernels 1 and 3
    STATS_WIDTHS) with a [nt, VB] tile and [nt, nq] weights, 4 (nt VB +
    nt nq) bytes (and extra floats: a per-shape spectral instance's
    factor and constants), whose blocks leave at least TILE_MIN_WARPS
    warps per SM; else the streamed form (False, STREAM_THREADS, 0)."""
    for vb in widths:
        smem = 4 * (nt * vb + nt * nq + extra)
        blocks = SMEM_PER_SM // (smem + SMEM_RESERVED)
        if blocks * (vb // 32) >= TILE_MIN_WARPS:
            return True, vb, smem
    return False, STREAM_THREADS, 0


def launch_vb(nt, nq, vb=None, widths=(TILE_VB,), extra=0):
    """The vb argument of a kernel 1, 3, 4, 6, 7 or 8 C entry point (nq and
    widths as tile_plan's): 0 streams, > 0 stages in blocks of vb lanes.
    None takes tile_plan's choice; an int forces it (the tests' and
    chip_smoke.py's means to time or check a form; a value the entry
    point refuses raises at the launch)."""
    if vb is not None:
        return int(vb)
    staged, pvb, _ = tile_plan(nt, nq, widths, extra)
    return pvb if staged else 0


def generated_source(source, p, q, kernel="nl_loop"):
    """The .cu of a generated functor (GenModel source) in kernel's
    template (GEN_KERNELS) at P, Q (q None for kernel 8, which has no
    noise groups)."""
    what, header, body, _ = GEN_KERNELS[kernel]
    qtext = "" if q is None else f", Q = {q}"
    return (_GEN_HEAD.format(what=what, header=header, p=p, qtext=qtext,
                             source=source, roll=_roll_define(p, q or 1))
            + body.format(p=p, q=q))


def _gen_flags(kernel):
    """nvcc's flags of a generated build: NVCC_FLAGS and those of the
    kernel's own source (kernel 8's -fmad=false, so its fresh and
    two-phase modes compute the same bits there too)."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(GEN_KERNELS[kernel][3], [])


def generated_key(source, p, q, kernel="nl_loop"):
    """The hash naming a generated functor's build: its .cu (source,
    kernel template, P, Q), the headers and the flags."""
    h = hashlib.sha256(generated_source(source, p, q, kernel).encode())
    h.update(" ".join(_gen_flags(kernel)).encode())
    for name in HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _header_consts(names, header="vb_device.cuh"):
    text = (CSRC / header).read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
                 for name in names)


@functools.cache
def gen_limits(kernel="nl_loop"):
    """(largest P, largest Q) of a model functor generated for kernel
    (GEN_KERNELS), read from csrc/vb_device.cuh, the header its kernels
    compile with: kWideMaxP, kWideMaxQ, and for kernel 7 ("vb_iter") its
    cooperative form's kCoopMaxP (past kMaxP or kMaxQ the per-shape
    instances' body: rolled loops past rolled_loops' sizes, where kernel 7
    takes its cooperative form)."""
    return _header_consts(
        ("kCoopMaxP" if kernel == "vb_iter" else "kWideMaxP", "kWideMaxQ"))


# kernel 6's full-time form (fused_nl_loop.cuh FullLayout): a warp serves
# a voxel, so its state and the functor's planes share one block's shared
# memory, at most MAX_BLOCK_SMEM (csrc/tile.cuh kMaxBlockSmem)
COOP_CHUNK = 32            # coop_device.cuh kCoopChunk


def fulltime_smem(p, q, nt, fn_floats):
    """Bytes of a block of kernel 6's full-time form (fused_nl_loop.cuh
    FullLayout, which the generated unit reports as fabber_gen_full_smem)
    at P, Q, the functor's nt samples and its fn_floats shared floats: the
    per-group sums, the chunk's Jacobian rows, weights and residuals, five
    packed matrices, nine P-vectors, four Q-vectors, the voxel's samples,
    the model's (P + 1) x nt signal and Jacobian, and the functor's
    planes."""
    ntri = p * (p + 1) // 2
    floats = (q * (ntri + p + 1) + p * (COOP_CHUNK + 1) + q * COOP_CHUNK
              + COOP_CHUNK + 5 * ntri + 9 * p + 4 * q + nt + (p + 1) * nt
              + fn_floats)
    return 4 * floats


# the largest P, and per-group sums Q P(P+1)/2, of a nonlinear unit built
# with its loops unrolled (rolled_loops); past them kernel 7 takes its
# cooperative form. Unrolled, exp num-exps 5 (P = 10) ran kernel 6 in
# 52.1-53.3 ms, 7 in 12.8-13.1 and 8 in 287.4-287.7 at 4,000,000 voxels,
# T=100; rolled, 1,418.9-1,421.0, 276.7-277.6 and 9,296.2-9,302.6 (NVIDIA
# H100 80GB HBM3, 700 W; probes/wide_nl.py --rolled), nvcc 10.9-30.8 s a
# unit unrolled.
ROLL_P = 16
ROLL_SUMS = 600


def rolled_loops(p, q=1):
    """True where a unit of kernels 6-8 at (P, Q) (a per-shape instance
    or a generated functor; kernel 8 at Q = 1) is built with
    FABBER_ROLL_LOOPS (csrc/vb_device.cuh FABBER_UNROLL): past ROLL_P, or
    past ROLL_SUMS per-group sums J'Q_qJ. Unrolled, a lane's packed state
    is the registers' (and ptxas's spills, at static offsets) and nvcc's
    time grows as P^3; rolled, local memory indexed by the loop counters,
    25-32 times slower at P = 10, and nvcc's time that of P = 1. Kernel 7
    compiles its cooperative form in such a unit, and says so
    (vb_iter_coop)."""
    return p > ROLL_P or q * p * (p + 1) // 2 > ROLL_SUMS


def vb_iter_coop(kind, p, nq, lib=None):
    """True where kernel 7's unit compiled its cooperative form
    (csrc/fused_vb_iter.cuh kIterCoop: fused_vb_iter_coop_kernel, a warp
    per voxel with its state in shared memory, which takes vb 0), as the
    unit says: the per-shape instance of the functor kind at (P, Q)
    (fabber_inst_vb_iter_coop), or lib, a generated functor's library
    (fabber_gen_vb_iter_coop). The prebuilt library's instances are per
    lane."""
    if lib is not None:
        return bool(lib.fabber_gen_vb_iter_coop())
    if has_nl_instance(kind, p, nq):
        return False
    return bool(_nl_entry(kind, p, nq, "vb_iter_coop")[0]())


def _roll_define(p, q):
    return "#define FABBER_ROLL_LOOPS\n" if rolled_loops(p, q) else ""


def build_generated(source, p, q, kernel="nl_loop"):
    """Build (once per source, kernel, P, Q, headers and flags) and load
    kernel (GEN_KERNELS: "nl_loop" kernel 6, "vb_iter" kernel 7, "nlls"
    kernel 8, whose q is None) with a generated model functor: writes
    build/kernels/gen/<hash>.cu, compiles it with nvcc for sm_90a into
    libfabber_gen_<hash>.so (a temporary file, then os.replace) and loads
    it with its own ctypes.CDLL. Returns the library; raises with nvcc's
    stderr when the build fails. gen_build_log[hash] keeps the build's
    seconds and nvcc's output (ptxas's register and spill lines; the
    seconds are nan where an earlier process built the library)."""
    max_p, max_q = gen_limits(kernel)
    if not 1 <= p <= max_p or not 1 <= (q or 1) <= max_q:
        raise FabberError(f"a functor generated for {kernel!r} takes P <= "
                          f"{max_p} and Q <= {max_q}, not P={p}, Q={q} "
                          "(csrc/vb_device.cuh kWideMaxP or kernel 7's "
                          "kCoopMaxP, kWideMaxQ)")
    if (q is None) != (kernel == "nlls"):
        raise ValueError(f"kernel {kernel!r} with q={q!r}: the NLLS kernel "
                         "takes no Q, the VB kernels one")
    cu = generated_source(source, p, q, kernel)
    key = generated_key(source, p, q, kernel)
    if key in _gen_libs:
        return _gen_libs[key]
    gdir = BUILD_DIR / "gen"
    src = gdir / f"{key}.cu"
    out = gdir / f"libfabber_gen_{key}.so"
    if not out.exists():
        nvcc = _nvcc()
        gdir.mkdir(parents=True, exist_ok=True)
        tmp_src = src.with_suffix(f".tmp{os.getpid()}.cu")
        tmp_src.write_text(cu)
        os.replace(tmp_src, src)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *_gen_flags(kernel), "-I", str(CSRC), "-shared",
               "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        gen_build_log[key] = (time.perf_counter() - t0,
                              proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise FabberError(f"nvcc failed ({proc.returncode}) on a "
                              f"generated model functor:\n{' '.join(cmd)}"
                              f"\n{proc.stderr}")
        _keep_log(out, proc.stdout + proc.stderr)
        os.replace(tmp, out)
    elif key not in gen_build_log:
        gen_build_log[key] = (float("nan"), _kept_log(out))
    lib = ctypes.CDLL(str(out))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    if kernel == "nl_loop_full":
        lib.fabber_gen_nl_loop_full.argtypes = [
            vp, i32, i32, f32, vp, i32, f32, i32, i32, i32, vp,
            vp, vp, vp, vp, vp, vp, vp, vp, i32, i64] + [vp] * 7 + [vp]
        lib.fabber_gen_nl_loop_full.restype = i32
        lib.fabber_gen_full_occupancy.argtypes = [i32]
        lib.fabber_gen_full_occupancy.restype = i32
        lib.fabber_gen_full_smem.argtypes = []
        lib.fabber_gen_full_smem.restype = i64
    elif kernel == "nl_loop":
        lib.fabber_gen_nl_loop.argtypes = [
            vp, i32, i32, f32, vp, i32, f32, i32, i32, i32, vp,
            vp, vp, vp, vp, vp, vp, vp, i32, i64] + [vp] * 7 + [i32, vp]
        lib.fabber_gen_nl_loop.restype = i32
        lib.fabber_gen_occupancy.argtypes = [i32, i32, i32]
        lib.fabber_gen_occupancy.restype = i32
    elif kernel == "vb_iter":
        lib.fabber_gen_vb_iter.argtypes = [vp, i32] + [vp] * 7 + [
            i32, i64] + [vp] * 7 + [i32, vp]
        lib.fabber_gen_vb_iter.restype = i32
        lib.fabber_gen_vb_iter_occupancy.argtypes = [i32, i32, i32]
        lib.fabber_gen_vb_iter_occupancy.restype = i32
        lib.fabber_gen_vb_iter_coop.argtypes = []
        lib.fabber_gen_vb_iter_coop.restype = i32
    else:
        lib.fabber_gen_nlls.argtypes = [vp, vp, i32, i32, i32, f32] + [
            vp] * 4 + [i32, i64] + [vp] * 6 + [i32, vp]
        lib.fabber_gen_nlls.restype = i32
        lib.fabber_gen_nlls_occupancy.argtypes = [i32] * 4
        lib.fabber_gen_nlls_occupancy.restype = i32
    _gen_libs[key] = lib
    return lib


# Per-shape instances (build_instance): family -> its sources, and where
# its limits stand (the header or source holding kWideMaxP / kWideMaxQ;
# kernel 9's nq limit is its prebuilt kAMaxQ). Each source compiles with
# FABBER_INST_P (and FABBER_INST_Q; the nonlinear family also
# FABBER_INST_KIND, its functor, and past rolled_loops' sizes
# FABBER_ROLL_LOOPS) defined into entry points of its own names
# (fabber_inst_*), for that one shape. The nonlinear family builds one
# unit at a time: the source of the one kernel (GEN_KERNELS' key) a launch
# asks for.
INSTANCE_FAMILIES = {
    "spectral": (("spectral_stats.cu", "spectral_core.cu",
                  "spectral_fused.cu"), "spectral_device.cuh"),
    "whole": (("fused_whole.cu", "fused_loop.cu"), "whole_device.cuh"),
    "ar": (("fused_ar_loop.cu",), "fused_ar_loop.cu"),
    "nl": (("fused_nl_loop.cu", "fused_vb_iter.cu", "fused_nlls.cu"),
           "vb_device.cuh"),
}
_inst_libs = {}
inst_build_log = {}   # build key -> (seconds, nvcc's output)

_INST_HEAD = """// generated by fabber_core_tpu_torch/ops/_cuda.py build_instance: the
// entry points of csrc/{source} for one shape, P = {p}{qtext}.
#define FABBER_INST_P {p}
{qdef}#include "{source}"
"""
# the functor of a nonlinear instance (FABBER_INST_KIND): models/base.py's
# KERNEL_POLY and KERNEL_EXP codes
NL_KINDS = {0: "PolyModel", 1: "ExpSum"}
# the nonlinear family's kernels (GEN_KERNELS' keys: "nl_loop" kernel 6,
# "vb_iter" kernel 7, "nlls" kernel 8) and the entry points of each one's
# unit
NL_ENTRIES = {"nl_loop": ("fused_nl_loop", "nl_occupancy"),
              "vb_iter": ("fused_vb_iter", "vb_iter_occupancy",
                          "vb_iter_coop"),
              "nlls": ("fused_nlls", "nlls_occupancy")}


@functools.cache
def instance_limits(family, kernel=None):
    """(largest P, largest Q) of a per-shape instance of family, read
    from the csrc file that fixes them (kWideMaxP, or kernel 7's
    kCoopMaxP for the nonlinear kernel "vb_iter"; kWideMaxQ, or kernel
    9's kAMaxQ; the spectral family has one noise group)."""
    text = (CSRC / INSTANCE_FAMILIES[family][1]).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))
    max_q = {"spectral": lambda: 1, "whole": lambda: const("kWideMaxQ"),
             "ar": lambda: const("kAMaxQ"),
             "nl": lambda: const("kWideMaxQ")}[family]()
    return const("kCoopMaxP" if kernel == "vb_iter"
                 else "kWideMaxP"), max_q


def instance_buildable(family, p, q=1, kind=None, kernel=None):
    """True where build_instance can compile family (the nonlinear one's
    kernel) at (P, Q): within instance_limits; the spectral and AR families
    past the prebuilt library's P (every smaller shape is prebuilt there);
    the nonlinear family for a functor kind of NL_KINDS (an exp sum at
    even P) at any shape (the library serves its prebuilt ones)."""
    max_p, max_q = instance_limits(family, kernel)
    if family == "nl" and (kind not in NL_KINDS or (kind == 1 and p % 2)):
        return False
    low = 1 if family in ("whole", "nl") else 9
    return low <= p <= max_p and 1 <= q <= max_q


def instance_sources(family, p, q=1, kind=None, kernel=None):
    """{unit name: .cu text} of family's per-shape instance at (P, Q) (and
    functor kind, the nonlinear family's): one small unit per source of
    the family (of the nonlinear family the source of the one kernel
    asked for, NL_ENTRIES; kernel 8's at Q = 1), defining the shape and
    including the source."""
    stems = [Path(src).stem for src in INSTANCE_FAMILIES[family][0]]
    if family == "nl":
        if kernel not in NL_ENTRIES:
            raise ValueError(f"a nonlinear kernel of {tuple(NL_ENTRIES)}, "
                             f"not {kernel!r}")
        # kernel 8 has no noise groups
        stems = [Path(GEN_KERNELS[kernel][3]).stem]
        q = 1 if kernel == "nlls" else q
    qtext = "" if family == "spectral" else f", Q = {q}"
    qdef = "" if family == "spectral" else f"#define FABBER_INST_Q {q}\n"
    if family == "nl":
        qtext += f", {NL_KINDS[kind]}"
        qdef += f"#define FABBER_INST_KIND {kind}\n" + _roll_define(p, q)
    return {stem: _INST_HEAD.format(source=f"{stem}.cu", p=p, qtext=qtext,
                                    qdef=qdef)
            for stem in stems}


def instance_key(family, p, q=1, kind=None, kernel=None):
    """The hash naming a per-shape build: its units (family, shape; the
    nonlinear family's kernel, kind, P and Q, Q dropped for kernel 8), the
    family's sources and every header, and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name, text in sorted(instance_sources(family, p, q, kind,
                                              kernel).items()):
        h.update(name.encode())
        h.update(text.encode())
    for name in INSTANCE_FAMILIES[family][0] + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


# argtypes of the per-shape entry points (of the nonlinear family, those
# of the kernel's unit)
def _inst_argtypes(lib, family, kernel=None):
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    if family == "spectral":
        entries = {
            "fabber_inst_spectral_stats": [i32, vp, vp, vp, i32, i64, vp, vp,
                                           vp, i32, vp],
            "fabber_inst_stats_occupancy": [i32] * 3,
            "fabber_inst_spectral_core": [i32, i32, vp, vp, vp, vp, vp, i32,
                                          f32, i32, i32, i32, i64]
            + [vp] * 7 + [vp],
            "fabber_inst_spectral_fused": [i32, i32, vp, vp, vp, i32, vp, vp,
                                           i32, f32, i32, i32, i32, i64]
            + [vp] * 7 + [i32, vp],
            "fabber_inst_fused_occupancy": [i32] * 4}
    elif family == "nl":
        entries = {
            "fabber_inst_fused_nl_loop": [
                i32, i32, i32, vp, f32, i32, i32, f32, vp, i32, f32, i32,
                i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, i64]
            + [vp] * 7 + [i32, vp],
            "fabber_inst_nl_occupancy": [i32] * 6,
            "fabber_inst_fused_vb_iter": [
                i32, i32, i32, vp, f32, i32, vp, vp, vp, vp, vp, vp, vp, i32,
                i64] + [vp] * 7 + [i32, vp],
            "fabber_inst_vb_iter_occupancy": [i32] * 6,
            "fabber_inst_vb_iter_coop": [],
            "fabber_inst_fused_nlls": [
                i32, i32, vp, f32, vp, i32, i32, i32, f32, vp, vp, vp, vp,
                i32, i64] + [vp] * 6 + [i32, vp],
            "fabber_inst_nlls_occupancy": [i32] * 6}
        entries = {f"fabber_inst_{e}": entries[f"fabber_inst_{e}"]
                   for e in NL_ENTRIES[kernel]}
    elif family == "whole":
        entries = {
            "fabber_inst_fused_whole": [i32, i32, i32, f32, vp, i32, f32, i32,
                                        i32, i32, vp, vp, vp, i32, vp, vp,
                                        i64] + [vp] * 7 + [i32, vp, vp],
            "fabber_inst_whole_occupancy": [i32] * 5,
            "fabber_inst_fused_vb_loop": [i32, i32, i32, f32, vp, vp, vp, vp,
                                          vp, vp, i64] + [vp] * 5 + [vp, vp],
            "fabber_inst_loop_occupancy": [i32] * 2}
    else:
        entries = {
            "fabber_inst_fused_ar_loop": [i32, i32, i32, vp, i32, f32, i32,
                                          i32, i32, f32, f32, vp, vp, vp, vp,
                                          vp, i64] + [vp] * 10 + [vp, vp]}
    for name, args in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32


def build_instance(family, p, q=1, kind=None, kernel=None):
    """Build (once per family, shape, sources, headers and flags) and load
    the per-shape instance of family ("spectral": kernels 1, 2 and 3 at P
    9-25; "whole": kernels 4 and 5 at any (P, Q) up to (20, 4); "ar":
    kernel 9 at P 9-16, nq 1-2; "nl": the unit of one kernel of
    NL_ENTRIES, 6, 7 or 8, with the functor kind (NL_KINDS) at any (P, Q)
    up to (42, 35),
    kernel 7 up to (143, 35), kernel 8 at P; instance_limits): writes one
    small .cu per source of the family (of "nl" the unit's) into
    build/kernels/inst/ (instance_sources),
    compiles them with nvcc for sm_90a, one process each, all started
    together, and links them into libfabber_inst_<hash>.so (a temporary
    file, then os.replace), loaded with its own ctypes.CDLL. Returns the
    library; raises with nvcc's output when the build fails (nothing runs
    in its place). inst_build_log[hash] keeps the build's seconds and
    nvcc's output (a "== unit (nvcc S s)" head per unit, then ptxas's
    register and spill lines; the seconds are nan where an earlier
    process built the library)."""
    if not instance_buildable(family, p, q, kind, kernel):
        raise FabberError(f"no per-shape {family} instance at P={p}, Q={q}"
                          + ("" if kind is None else f", kind {kind}")
                          + ("" if kernel is None else f", kernel {kernel}")
                          + f" (limits {instance_limits(family, kernel)})")
    key = instance_key(family, p, q, kind, kernel)
    if key in _inst_libs:
        return _inst_libs[key]
    idir = BUILD_DIR / "inst"
    out = idir / f"libfabber_inst_{key}.so"
    if not out.exists():
        idir.mkdir(parents=True, exist_ok=True)
        units = []
        for stem, text in instance_sources(family, p, q, kind,
                                           kernel).items():
            src = idir / f"{key}.{stem}.cu"
            tmp_src = src.with_suffix(f".tmp{os.getpid()}.cu")
            tmp_src.write_text(text)
            os.replace(tmp_src, src)
            units.append((f"{stem}.cu", src,
                          SOURCE_FLAGS.get(f"{stem}.cu", [])))
        t0 = time.perf_counter()
        try:
            log = _compile_link(units, out)
        except FabberError as e:
            inst_build_log[key] = (time.perf_counter() - t0, str(e))
            raise FabberError(f"the per-shape {family} instance at P={p}, "
                              f"Q={q} did not build:\n{e}") from None
        inst_build_log[key] = (time.perf_counter() - t0, log)
    elif key not in inst_build_log:
        inst_build_log[key] = (float("nan"), _kept_log(out))
    lib = ctypes.CDLL(str(out))
    _inst_argtypes(lib, family, kernel)
    _inst_libs[key] = lib
    return lib


def build_instances(shapes, with_library=True):
    """Build the per-shape instances shapes ((family, p, q) each, and the
    functor kind and kernel for "nl") and, with
    with_library, the prebuilt library, concurrently (a thread per build,
    each waiting on its nvcc processes). Returns {shape: library}; the
    first failure raises once all have ended."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(shapes) + 1) as pool:
        main = pool.submit(build) if with_library else None
        futs = {shape: pool.submit(build_instance, *shape)
                for shape in shapes}
    if main is not None:
        main.result()
    return {shape: f.result() for shape, f in futs.items()}


def launch_gen_nl_loop(lib, tcodes, n_iters, need_f, locked_sd, consts,
                       detector, det_consts, centre0, pm, pp, pd0, data,
                       supp, qw, outs, vb):
    """launch_nl_loop for a library of build_generated; supp: the [S,V]
    suppdata plane or None."""
    nt, nv = data.shape
    consts = consts.contiguous()
    dc = 0 if det_consts is None else det_consts.contiguous().data_ptr()

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    with torch.cuda.device(data.device):
        err = lib.fabber_gen_nl_loop(
            _int_array(tcodes), n_iters, int(need_f), locked_sd,
            consts.data_ptr(), *detector_args(detector), dc,
            centre0.data_ptr(), pm.data_ptr(), pp.data_ptr(), ptr(pd0),
            data.data_ptr(), ptr(supp), qw.data_ptr(), nt, nv,
            *(o.data_ptr() for o in outs), vb, _stream(data.device))
    _raise_on(err, "fused_nl_loop (generated functor)")


def launch_gen_nl_loop_full(lib, tcodes, n_iters, need_f, locked_sd,
                            consts, detector, det_consts, centre0, pm, pp,
                            pd0, data, supp, qw, cst, outs):
    """launch_gen_nl_loop for a full-time functor's library (kernel
    "nl_loop_full"): cst, the functor's constant buffer on the device, or
    None."""
    nt, nv = data.shape
    consts = consts.contiguous()
    dc = 0 if det_consts is None else det_consts.contiguous().data_ptr()

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    with torch.cuda.device(data.device):
        err = lib.fabber_gen_nl_loop_full(
            _int_array(tcodes), n_iters, int(need_f), locked_sd,
            consts.data_ptr(), *detector_args(detector), dc,
            centre0.data_ptr(), pm.data_ptr(), pp.data_ptr(), ptr(pd0),
            data.data_ptr(), ptr(supp), qw.data_ptr(), ptr(cst), nt, nv,
            *(o.data_ptr() for o in outs), _stream(data.device))
    _raise_on(err, "fused_nl_loop (full-time functor)")


def launch_gen_vb_iter(lib, tcodes, need_f, centre, pm, pp, phi, data, qw,
                       alpha, outs, vb):
    """launch_vb_iter for a library of build_generated (kernel
    "vb_iter")."""
    nt, nv = data.shape
    with torch.cuda.device(data.device):
        err = lib.fabber_gen_vb_iter(
            _int_array(tcodes), int(need_f), centre.data_ptr(),
            pm.data_ptr(), pp.data_ptr(), phi.data_ptr(), data.data_ptr(),
            qw.data_ptr(), 0 if alpha is None else alpha.data_ptr(), nt, nv,
            *(o.data_ptr() for o in outs), vb, _stream(data.device))
    _raise_on(err, "fused_vb_iter (generated functor)")


def launch_gen_nlls(lib, tcodes, consts, mode, marquardt, max_its, dof,
                    params0, data, w, state, outs, vb):
    """launch_nlls for a library of build_generated (kernel "nlls")."""
    nt, nv = data.shape

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    with torch.cuda.device(data.device):
        err = lib.fabber_gen_nlls(
            _int_array(tcodes), _float_array(consts), mode, int(marquardt),
            max_its, dof, params0.data_ptr(), data.data_ptr(), w.data_ptr(),
            ptr(state), nt, nv, *(ptr(o) for o in outs), vb,
            _stream(data.device))
    _raise_on(err, "fused_nlls (generated functor)")


def has_nl_instance(kind, p, q):
    """True when the nonlinear kernels are compiled for this model
    functor kind, P and Q (csrc/vb_device.cuh FABBER_NL_INSTANCES)."""
    return bool(load().fabber_nl_has_instance(kind, p, q))


def has_whole_instance(p, q):
    """True when the fixed-design kernels (kernels 4 and 5) are compiled
    for P and Q (csrc/whole_device.cuh FABBER_WHOLE_INSTANCES)."""
    return bool(load().fabber_whole_has_instance(p, q))


def has_nlls_instance(kind, p):
    """True when the NLLS kernel is compiled for this model functor kind
    and P (every (kind, P) of csrc/vb_device.cuh FABBER_NL_INSTANCES)."""
    return bool(load().fabber_nlls_has_instance(kind, p))


def has_ar_instance(p, nq):
    """True when the AR(1) kernel (kernel 9) is compiled for P and nq
    echo groups (csrc/fused_ar_loop.cu FABBER_AR_INSTANCES)."""
    return bool(load().fabber_ar_has_instance(p, nq))


def _raise_on(err, name):
    if err != 0:
        raise FabberError(f"{name} launch failed: CUDA error {err}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# the largest P of the prebuilt spectral kernels (kernels 1-3; larger P
# are per-shape instances, build_instance)
SPECTRAL_PREBUILT_P = PREBUILT_MAX_P


def _spectral_entry(p, name):
    """The entry point name of kernel 1, 2 or 3 at P: the prebuilt
    library's up to SPECTRAL_PREBUILT_P, else the per-shape instance's
    (built at its first use)."""
    if p <= SPECTRAL_PREBUILT_P:
        return getattr(load(), f"fabber_{name}")
    return getattr(build_instance("spectral", p), f"fabber_inst_{name}")


def _on(t, dev):
    """A host constant vector on the device: a per-shape instance reads
    its constants from a device buffer."""
    return t.to(device=dev, dtype=torch.float32).contiguous()


def launch_stats(p, data, tconsts, aconsts, m0, rtqr, dtqr, vb):
    """vb: 0 streamed, > 0 staged in blocks of vb lanes (launch_vb)."""
    fn = _spectral_entry(p, "spectral_stats")
    nt, nv = data.shape
    if p > SPECTRAL_PREBUILT_P:
        aconsts = _on(aconsts, data.device)
    with torch.cuda.device(data.device):
        err = fn(p, data.data_ptr(), tconsts.data_ptr(), aconsts.data_ptr(),
                 nt, nv, m0.data_ptr(), rtqr.data_ptr(), dtqr.data_ptr(), vb,
                 _stream(data.device))
    _raise_on(err, "spectral_stats")
    return p > SPECTRAL_PREBUILT_P


def stats_occupancy(p, vb, nt):
    """Blocks per SM of kernel 1's P instance in form vb at nt samples
    (a per-shape instance past SPECTRAL_PREBUILT_P, built if need be); -1
    where refused, P past the per-shape limit too."""
    if p > SPECTRAL_PREBUILT_P and not instance_buildable("spectral", p):
        return -1
    return int(_spectral_entry(p, "stats_occupancy")(p, vb, nt))


def detector_args(detector):
    """(kind, tol, max_its, max_trials, init_save) of a convergence
    detector object for a launch; None is maxits."""
    if detector is None:
        return 0, 0.0, 0, 0, 0
    name = type(detector).name
    tol = getattr(detector, "min_fchange",
                  getattr(detector, "max_fchange", 0.0))
    init_save = bool(detector.init_state(1, torch.float32).save[0])
    return (DETECTOR_CODES[name], float(tol), int(detector.max_its),
            int(getattr(detector, "max_trials", 0)), int(init_save))


def launch_core(p, n_iters, m0, rtqr, dtqr, pm, consts, detector, outs):
    fn = _spectral_entry(p, "spectral_core")
    nv = m0.shape[-1]
    if p > SPECTRAL_PREBUILT_P:
        consts = _on(consts, m0.device)
    with torch.cuda.device(m0.device):
        err = fn(
            p, n_iters, m0.data_ptr(), rtqr.data_ptr(), dtqr.data_ptr(),
            pm.data_ptr(), consts.data_ptr(), *detector_args(detector), nv,
            *(o.data_ptr() for o in outs), _stream(m0.device))
    _raise_on(err, "spectral_core")
    return p > SPECTRAL_PREBUILT_P


def launch_spectral_fused(p, n_iters, data, tconsts, aconsts, pm, consts,
                          detector, outs, vb):
    """vb: 0 streamed, > 0 staged in blocks of vb lanes (launch_vb)."""
    fn = _spectral_entry(p, "spectral_fused")
    nt, nv = data.shape
    if p > SPECTRAL_PREBUILT_P:
        aconsts, consts = _on(aconsts, data.device), _on(consts, data.device)
    with torch.cuda.device(data.device):
        err = fn(
            p, n_iters, data.data_ptr(), tconsts.data_ptr(),
            aconsts.data_ptr(), nt, pm.data_ptr(), consts.data_ptr(),
            *detector_args(detector), nv, *(o.data_ptr() for o in outs),
            vb, _stream(data.device))
    _raise_on(err, "spectral_fused")
    return p > SPECTRAL_PREBUILT_P


def fused_occupancy(p, kind, vb, nt):
    """Blocks per SM of kernel 3's P instance for the detector kind
    (DETECTOR_CODES: 0 maxits, 1-3 pointzeroone, freduce, trialmode) in
    form vb at nt samples (stats_occupancy's rule past the prebuilt P); -1
    where refused."""
    if p > SPECTRAL_PREBUILT_P and not instance_buildable("spectral", p):
        return -1
    return int(_spectral_entry(p, "fused_occupancy")(p, kind, vb, nt))


def launch_whole(p, nq, n_iters, locked_sd, consts, detector, det_consts,
                 data, tconsts, pm, pp, outs, vb):
    """consts: [Q*P*P + 4Q] float32 host tensor; detector: a convergence
    detector object or None (maxits); det_consts: [Q+1] float32 host
    tensor (lb_coeff, f_const) or None; vb: 0 streamed, > 0 staged in
    blocks of vb lanes (launch_vb). A (P, Q) outside the prebuilt list
    launches its per-shape instance (build_instance, at its first use),
    with D'Q_qD on the device."""
    nt, nv = data.shape
    dc = 0 if det_consts is None else det_consts.data_ptr()
    args = (p, nq, n_iters, locked_sd, consts.data_ptr(),
            *detector_args(detector), dc, data.data_ptr(),
            tconsts.data_ptr(), nt, pm.data_ptr(), pp.data_ptr(), nv,
            *(o.data_ptr() for o in outs), vb)
    with torch.cuda.device(data.device):
        inst = not has_whole_instance(p, nq)
        if not inst:
            err = load().fabber_fused_whole(*args, _stream(data.device))
        else:
            dtqd = _on(consts[:nq * p * p], data.device)
            err = build_instance("whole", p, nq).fabber_inst_fused_whole(
                *args, dtqd.data_ptr(), _stream(data.device))
    _raise_on(err, "fused_whole")
    return inst


def launch_vb_loop(p, nq, n_iters, locked_sd, consts, m0, rtqr, dtqr, pm,
                   pp, outs):
    """A (P, Q) outside the prebuilt list launches its per-shape
    instance (launch_whole's rule)."""
    nv = m0.shape[-1]
    args = (p, nq, n_iters, locked_sd, consts.data_ptr(), m0.data_ptr(),
            rtqr.data_ptr(), dtqr.data_ptr(), pm.data_ptr(), pp.data_ptr(),
            nv, *(o.data_ptr() for o in outs))
    with torch.cuda.device(m0.device):
        inst = not has_whole_instance(p, nq)
        if not inst:
            err = load().fabber_fused_vb_loop(*args, _stream(m0.device))
        else:
            dtqd = _on(consts[:nq * p * p], m0.device)
            err = build_instance("whole", p, nq).fabber_inst_fused_vb_loop(
                *args, dtqd.data_ptr(), _stream(m0.device))
    _raise_on(err, "fused_vb_loop")
    return inst


def _int_array(values):
    return (ctypes.c_int * len(values))(*values)


def launch_nl_loop(km, nq, tcodes, n_iters, need_f, locked_sd, consts,
                   detector, det_consts, centre0, pm, pp, pd0, data, qw,
                   outs, vb):
    """consts: [4Q] float32 host tensor (pack_nl_consts); detector: a
    convergence detector object or None (maxits); det_consts: [Q+2]
    float32 host tensor (lb_coeff, f_const, f_const_init) or None; pd0:
    the initial posterior variances [P,V] (freduce) or None; vb: 0
    streamed, > 0 staged in blocks of vb lanes (launch_vb). A (kind, P,
    Q) outside FABBER_NL_INSTANCES launches its per-shape instance
    (build_instance "nl", at its first use); returns True then."""
    nt, nv = data.shape
    consts = consts.contiguous()
    dc = 0 if det_consts is None else det_consts.contiguous().data_ptr()
    with torch.cuda.device(data.device):
        fn, inst = _nl_entry(km.kind, km.nparams, nq, "fused_nl_loop")
        err = fn(
            km.kind, km.nparams, nq, _int_array(tcodes), km.dt, n_iters,
            int(need_f), locked_sd, consts.data_ptr(),
            *detector_args(detector), dc, centre0.data_ptr(),
            pm.data_ptr(), pp.data_ptr(),
            0 if pd0 is None else pd0.data_ptr(), data.data_ptr(),
            qw.data_ptr(), nt, nv, *(o.data_ptr() for o in outs), vb,
            _stream(data.device))
    _raise_on(err, "fused_nl_loop")
    return inst


def launch_vb_iter(km, nq, tcodes, need_f, centre, pm, pp, phi, data, qw,
                   alpha, outs, vb):
    """alpha: the lm detector's [V] damping (the LM branch) or None; vb:
    0 streamed, > 0 staged in blocks of vb lanes (launch_vb; 0 for the
    cooperative form, vb_iter_coop). A (kind, P, Q) outside
    FABBER_NL_INSTANCES launches its per-shape instance (the cooperative
    form past rolled_loops' sizes); returns True then."""
    nt, nv = data.shape
    with torch.cuda.device(data.device):
        fn, inst = _nl_entry(km.kind, km.nparams, nq, "fused_vb_iter")
        err = fn(
            km.kind, km.nparams, nq, _int_array(tcodes), km.dt, int(need_f),
            centre.data_ptr(), pm.data_ptr(), pp.data_ptr(), phi.data_ptr(),
            data.data_ptr(), qw.data_ptr(),
            0 if alpha is None else alpha.data_ptr(), nt, nv,
            *(o.data_ptr() for o in outs), vb, _stream(data.device))
    _raise_on(err, "fused_vb_iter")
    return inst


def _float_array(values):
    return (ctypes.c_float * len(values))(*values)


def launch_nlls(km, tcodes, consts, mode, marquardt, max_its, dof, params0,
                data, w, state, outs, vb):
    """consts: the 7 optimizer constants (ops/fused_nlls.py); mode: 0
    fresh, 1 phase 1, 2 resume; w: the [T] 0/1 weights on the device;
    state: [4,V] or None; outs: (params, cost, its, prec, cov, state_out)
    with None for what the mode does not write; vb: 0 streamed, > 0
    staged in blocks of vb lanes (launch_vb). A (kind, P) outside
    FABBER_NL_INSTANCES launches its per-shape instance (at Q = 1);
    returns True then."""
    nt, nv = data.shape

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    with torch.cuda.device(data.device):
        fn, inst = _nl_entry(km.kind, km.nparams, None, "fused_nlls")
        err = fn(
            km.kind, km.nparams, _int_array(tcodes), km.dt,
            _float_array(consts), mode, int(marquardt), max_its, dof,
            params0.data_ptr(), data.data_ptr(), w.data_ptr(), ptr(state),
            nt, nv, *(ptr(o) for o in outs), vb, _stream(data.device))
    _raise_on(err, "fused_nlls")
    return inst


def _nl_entry(kind, p, nq, name):
    """(the C entry point name of kernel 6, 7 or 8 (nq None) for the
    functor kind at (P, Q), whether it is a per-shape instance's): the
    prebuilt library's where FABBER_NL_INSTANCES holds the shape, else
    the per-shape instance's (build_instance "nl" of the one unit whose
    entry point it is, built at its first use; kernel 8 at Q = 1)."""
    if (has_nl_instance(kind, p, nq) if nq is not None
            else has_nlls_instance(kind, p)):
        return getattr(load(), f"fabber_{name}"), False
    kernel = next(k for k, names in NL_ENTRIES.items() if name in names)
    lib = build_instance("nl", p, nq or 1, kind, kernel)
    return getattr(lib, f"fabber_inst_{name}"), True


def nl_occupancy(kind, p, nq, mode, vb, nt):
    """Blocks per SM of kernel 6's (kind, P, Q) instance in MODE mode (0
    maxits, 1 pointzeroone/freduce, 2 trialmode/lm) and form vb at nt
    samples (cudaOccupancyMaxActiveBlocksPerMultiprocessor; a per-shape
    instance built if need be); -1 where refused."""
    if not (has_nl_instance(kind, p, nq)
            or instance_buildable("nl", p, nq, kind, "nl_loop")):
        return -1
    return int(_nl_entry(kind, p, nq, "nl_occupancy")[0](
        kind, p, nq, mode, vb, nt))


def whole_occupancy(p, nq, mode, vb, nt):
    """Blocks per SM of kernel 4's (P, Q) instance in MODE mode (0
    maxits, 1 pointzeroone, 2 trialmode/lm) and form vb at nt samples;
    -1 where refused."""
    if has_whole_instance(p, nq):
        return int(load().fabber_whole_occupancy(p, nq, mode, vb, nt))
    return int(build_instance("whole", p, nq).fabber_inst_whole_occupancy(
        p, nq, mode, vb, nt))


def loop_occupancy(p, nq):
    """Blocks per SM of kernel 5's (P, Q) instance; -1 where refused."""
    if has_whole_instance(p, nq):
        return int(load().fabber_loop_occupancy(p, nq))
    return int(build_instance("whole", p, nq).fabber_inst_loop_occupancy(
        p, nq))


def vb_iter_occupancy(kind, p, nq, lm, vb, nt):
    """Blocks per SM of kernel 7's (kind, P, Q) instance, with or without
    its LM branch, in form vb at nt samples (nl_occupancy's rule past the
    prebuilt list; the cooperative form, vb_iter_coop, at vb = 0 only);
    -1 where refused."""
    if not (has_nl_instance(kind, p, nq)
            or instance_buildable("nl", p, nq, kind, "vb_iter")):
        return -1
    return int(_nl_entry(kind, p, nq, "vb_iter_occupancy")[0](
        kind, p, nq, int(lm), vb, nt))


def gen_occupancy(lib, mode, vb, nt):
    """nl_occupancy for a library of build_generated (kernel
    "nl_loop")."""
    return int(lib.fabber_gen_occupancy(mode, vb, nt))


def gen_full_occupancy(lib, mode):
    """Blocks per SM of a full-time functor's kernel in MODE (0, 1, 2)."""
    return lib.fabber_gen_full_occupancy(mode)


def gen_vb_iter_occupancy(lib, lm, vb, nt):
    """vb_iter_occupancy for a library of build_generated (kernel
    "vb_iter")."""
    return int(lib.fabber_gen_vb_iter_occupancy(int(lm), vb, nt))


def gen_nlls_occupancy(lib, mode, marquardt, vb, nt):
    """nlls_occupancy for a library of build_generated (kernel "nlls")."""
    return int(lib.fabber_gen_nlls_occupancy(mode, int(marquardt), vb, nt))


def nlls_occupancy(kind, p, mode, marquardt, vb, nt):
    """Blocks per SM of kernel 8's (kind, P) instance in mode (0 fresh, 1
    phase 1, 2 resume), with or without Marquardt damping, in form vb at
    nt samples (nl_occupancy's rule past the prebuilt list); -1 where
    refused."""
    if not (has_nlls_instance(kind, p)
            or instance_buildable("nl", p, 1, kind, "nlls")):
        return -1
    return int(_nl_entry(kind, p, None, "nlls_occupancy")[0](
        kind, p, mode, int(marquardt), vb, nt))


def launch_ar_loop(p, nq, n_iters, consts, detector, elbo, m0, rmr, dmr, pm,
                   pp, outs):
    """consts: [3nq*P*P + 2 + 6nq] float32 host tensor (pack_ar_consts);
    detector: a pointzeroone / freduce detector object or None (maxits);
    elbo: (f_const, lb_coeff) or None; outs: the eight planes, then f
    and its under a detector. A (P, nq) outside the prebuilt list launches
    its per-shape instance (build_instance, at its first use), with D'M_sD
    on the device."""
    nv = m0.shape[-1]
    f_const, lb_coeff = elbo if elbo is not None else (0.0, 0.0)
    ptrs = [o.data_ptr() for o in outs] + [0] * (10 - len(outs))
    args = (p, nq, n_iters, consts.data_ptr(), *detector_args(detector),
            f_const, lb_coeff, m0.data_ptr(), rmr.data_ptr(), dmr.data_ptr(),
            pm.data_ptr(), pp.data_ptr(), nv, *ptrs)
    with torch.cuda.device(m0.device):
        inst = not has_ar_instance(p, nq)
        if not inst:
            err = load().fabber_fused_ar_loop(*args, _stream(m0.device))
        else:
            dmd = _on(consts[:3 * nq * p * p], m0.device)
            err = build_instance("ar", p, nq).fabber_inst_fused_ar_loop(
                *args, dmd.data_ptr(), _stream(m0.device))
    _raise_on(err, "fused_ar_loop")
    return inst
