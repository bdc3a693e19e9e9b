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
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..exceptions import FabberError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("spectral_stats.cu", "spectral_core.cu", "spectral_fused.cu",
           "fused_nl_loop.cu", "fused_vb_iter.cu", "fused_whole.cu",
           "fused_nlls.cu", "fused_ar_loop.cu")
HEADERS = ("vb_device.cuh", "detectors.cuh", "spectral_device.cuh",
           "fused_nl_loop.cuh", "dual.cuh", "tile.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source on top of NVCC_FLAGS: the NLLS kernel contracts no
# multiply-add, so its fresh and two-phase modes compute the same bits
# (csrc/fused_nlls.cu); the AR(1) kernel neither, so it computes its
# plain version's float32 arithmetic bit for bit (csrc/fused_ar_loop.cu)
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

# csrc/detectors.cuh DetectorKind
DETECTOR_CODES = {"maxits": 0, "pointzeroone": 1, "freduce": 2,
                  "trialmode": 3, "lm": 4}

_lib = None
build_log = ""   # nvcc's output (incl. -Xptxas -v) of this process's build
# generated model functors: source hash -> (library, nq, nparams, nsupp)
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
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{out.stem}.{Path(name).stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, []), "-I",
               str(CSRC), "-c", "-o", str(obj), str(CSRC / name)]
        objs.append(obj)
        procs.append((name, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for name, cmd, proc in procs:
        stdout, stderr = proc.communicate()
        logs.append(f"== {name}\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stderr}")
    build_log = "\n".join(logs)
    if failed:
        raise FabberError("\n".join(failed))
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", str(tmp), *(str(o) for o in objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise FabberError(f"nvcc link failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stderr}")
    _keep_log(out, build_log)
    os.replace(tmp, out)
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float)
        lib.fabber_spectral_stats.argtypes = [
            i32, vp, vp, vp, i32, i64, vp, vp, vp, vp]
        lib.fabber_spectral_stats.restype = i32
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
            vp, vp, vp, vp, vp, vp, vp, i32, i64] + [vp] * 7 + [vp]
        lib.fabber_fused_vb_iter.restype = i32
        lib.fabber_nl_has_instance.argtypes = [i32, i32, i32]
        lib.fabber_nl_has_instance.restype = i32
        lib.fabber_spectral_fused.argtypes = [
            i32, i32, vp, vp, vp, i32, vp, vp, i32, f32, i32, i32, i32,
            i64] + [vp] * 7 + [vp]
        lib.fabber_spectral_fused.restype = i32
        lib.fabber_fused_whole.argtypes = [
            i32, i32, i32, f32, vp, i32, f32, i32, i32, i32, vp, vp, vp,
            i32, vp, vp, i64] + [vp] * 7 + [vp]
        lib.fabber_fused_whole.restype = i32
        lib.fabber_fused_vb_loop.argtypes = [
            i32, i32, i32, f32, vp, vp, vp, vp, vp, vp, i64] + [vp] * 5 \
            + [vp]
        lib.fabber_fused_vb_loop.restype = i32
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


# the C entry point of a library built from a generated model functor:
# kernel 6 at the functor's P and the run's Q, its three MODEs
_GEN_TEMPLATE = """// generated by fabber_core_tpu_torch/ops/_cuda.py build_generated: the
// whole-loop kernel (fused_nl_loop.cuh) with a model functor generated
// from a model (models/kernelgen.py) at P = {p}, Q = {q}.
#include "dual.cuh"
#include "fused_nl_loop.cuh"

namespace {{
using namespace fabber::gen;
{source}
}}  // namespace

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
  VBParams k;
  NLDetConsts dc;
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


def tile_plan(nt, nq):
    """(staged, VB, smem bytes) of a whole-loop kernel launch (kernels 6
    and 8, csrc/tile.cuh) at nt samples and nq weights per sample (Q
    groups for kernel 6, 1 for kernel 8): blocks of TILE_VB lanes with a
    [nt, TILE_VB] tile and [nt, nq] weights, 4 (nt VB + nt nq) bytes,
    where at least TILE_MIN_WARPS such blocks fit an SM; else the
    streamed form (False, STREAM_THREADS, 0)."""
    smem = 4 * (nt * TILE_VB + nt * nq)
    if SMEM_PER_SM // (smem + SMEM_RESERVED) >= TILE_MIN_WARPS:
        return True, TILE_VB, smem
    return False, STREAM_THREADS, 0


def launch_vb(nt, nq, vb=None):
    """The vb argument of a kernel 6 or 8 C entry point: 0 streams, > 0
    stages in blocks of vb lanes. None takes tile_plan's choice; an int
    forces it (the tests' and chip_smoke.py's means to time or check a
    form; a value the entry point refuses raises at the launch)."""
    if vb is not None:
        return int(vb)
    staged, pvb, _ = tile_plan(nt, nq)
    return pvb if staged else 0


def generated_source(source, p, q):
    """The .cu of a generated functor (GenModel source) at P, Q."""
    return _GEN_TEMPLATE.format(source=source, p=p, q=q)


def generated_key(source, p, q):
    """The hash naming a generated functor's build: its .cu (source, P,
    Q), the headers and the flags."""
    h = hashlib.sha256(generated_source(source, p, q).encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_generated(source, p, q):
    """Build (once per source, P, Q, headers and flags) and load the
    whole-loop kernel with a generated model functor: writes
    build/kernels/gen/<hash>.cu, compiles it with nvcc for sm_90a into
    libfabber_gen_<hash>.so (a temporary file, then os.replace) and loads
    it with its own ctypes.CDLL. Returns the library; raises with nvcc's
    stderr when the build fails. gen_build_log[hash] keeps the build's
    seconds and nvcc's output (ptxas's register and spill lines; the
    seconds are nan where an earlier process built the library)."""
    if not 1 <= p <= 4:
        raise FabberError(f"a generated functor takes P <= 4, not {p} "
                          "(csrc/vb_device.cuh kMaxP)")
    cu = generated_source(source, p, q)
    key = generated_key(source, p, q)
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
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
               str(tmp), str(src)]
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
    lib.fabber_gen_nl_loop.argtypes = [
        vp, i32, i32, f32, vp, i32, f32, i32, i32, i32, vp,
        vp, vp, vp, vp, vp, vp, vp, i32, i64] + [vp] * 7 + [i32, vp]
    lib.fabber_gen_nl_loop.restype = i32
    lib.fabber_gen_occupancy.argtypes = [i32, i32, i32]
    lib.fabber_gen_occupancy.restype = i32
    _gen_libs[key] = lib
    return lib


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


def has_nl_instance(kind, p, q):
    """True when the nonlinear kernels are compiled for this model
    functor kind, P and Q (csrc/vb_device.cuh FABBER_NL_INSTANCES)."""
    return bool(load().fabber_nl_has_instance(kind, p, q))


def has_whole_instance(p, q):
    """True when the fixed-design kernels (kernels 4 and 5) are compiled
    for P and Q (csrc/fused_whole.cu FABBER_WHOLE_INSTANCES)."""
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


def launch_stats(p, data, tconsts, aconsts, m0, rtqr, dtqr):
    lib = load()
    nt, nv = data.shape
    with torch.cuda.device(data.device):
        err = lib.fabber_spectral_stats(
            p, data.data_ptr(), tconsts.data_ptr(), aconsts.data_ptr(),
            nt, nv, m0.data_ptr(), rtqr.data_ptr(), dtqr.data_ptr(),
            _stream(data.device))
    _raise_on(err, "spectral_stats")


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
    lib = load()
    nv = m0.shape[-1]
    with torch.cuda.device(m0.device):
        err = lib.fabber_spectral_core(
            p, n_iters, m0.data_ptr(), rtqr.data_ptr(), dtqr.data_ptr(),
            pm.data_ptr(), consts.data_ptr(), *detector_args(detector), nv,
            *(o.data_ptr() for o in outs), _stream(m0.device))
    _raise_on(err, "spectral_core")


def launch_spectral_fused(p, n_iters, data, tconsts, aconsts, pm, consts,
                          detector, outs):
    lib = load()
    nt, nv = data.shape
    with torch.cuda.device(data.device):
        err = lib.fabber_spectral_fused(
            p, n_iters, data.data_ptr(), tconsts.data_ptr(),
            aconsts.data_ptr(), nt, pm.data_ptr(), consts.data_ptr(),
            *detector_args(detector), nv, *(o.data_ptr() for o in outs),
            _stream(data.device))
    _raise_on(err, "spectral_fused")


def launch_whole(p, nq, n_iters, locked_sd, consts, detector, det_consts,
                 data, tconsts, pm, pp, outs):
    """consts: [Q*P*P + 4Q] float32 host tensor; detector: a convergence
    detector object or None (maxits); det_consts: [Q+1] float32 host
    tensor (lb_coeff, f_const) or None."""
    lib = load()
    nt, nv = data.shape
    dc = 0 if det_consts is None else det_consts.data_ptr()
    with torch.cuda.device(data.device):
        err = lib.fabber_fused_whole(
            p, nq, n_iters, locked_sd, consts.data_ptr(),
            *detector_args(detector), dc, data.data_ptr(),
            tconsts.data_ptr(), nt, pm.data_ptr(), pp.data_ptr(), nv,
            *(o.data_ptr() for o in outs), _stream(data.device))
    _raise_on(err, "fused_whole")


def launch_vb_loop(p, nq, n_iters, locked_sd, consts, m0, rtqr, dtqr, pm,
                   pp, outs):
    lib = load()
    nv = m0.shape[-1]
    with torch.cuda.device(m0.device):
        err = lib.fabber_fused_vb_loop(
            p, nq, n_iters, locked_sd, consts.data_ptr(), m0.data_ptr(),
            rtqr.data_ptr(), dtqr.data_ptr(), pm.data_ptr(), pp.data_ptr(),
            nv, *(o.data_ptr() for o in outs), _stream(m0.device))
    _raise_on(err, "fused_vb_loop")


def _int_array(values):
    return (ctypes.c_int * len(values))(*values)


def launch_nl_loop(km, nq, tcodes, n_iters, need_f, locked_sd, consts,
                   detector, det_consts, centre0, pm, pp, pd0, data, qw,
                   outs, vb):
    """consts: [4Q] float32 host tensor (pack_nl_consts); detector: a
    convergence detector object or None (maxits); det_consts: [Q+2]
    float32 host tensor (lb_coeff, f_const, f_const_init) or None; pd0:
    the initial posterior variances [P,V] (freduce) or None; vb: 0
    streamed, > 0 staged in blocks of vb lanes (launch_vb)."""
    lib = load()
    nt, nv = data.shape
    consts = consts.contiguous()
    dc = 0 if det_consts is None else det_consts.contiguous().data_ptr()
    with torch.cuda.device(data.device):
        err = lib.fabber_fused_nl_loop(
            km.kind, km.nparams, nq, _int_array(tcodes), km.dt, n_iters,
            int(need_f), locked_sd, consts.data_ptr(),
            *detector_args(detector), dc, centre0.data_ptr(),
            pm.data_ptr(), pp.data_ptr(),
            0 if pd0 is None else pd0.data_ptr(), data.data_ptr(),
            qw.data_ptr(), nt, nv, *(o.data_ptr() for o in outs), vb,
            _stream(data.device))
    _raise_on(err, "fused_nl_loop")


def launch_vb_iter(km, nq, tcodes, need_f, centre, pm, pp, phi, data, qw,
                   alpha, outs):
    """alpha: the lm detector's [V] damping (the LM branch) or None."""
    lib = load()
    nt, nv = data.shape
    with torch.cuda.device(data.device):
        err = lib.fabber_fused_vb_iter(
            km.kind, km.nparams, nq, _int_array(tcodes), km.dt, int(need_f),
            centre.data_ptr(), pm.data_ptr(), pp.data_ptr(), phi.data_ptr(),
            data.data_ptr(), qw.data_ptr(),
            0 if alpha is None else alpha.data_ptr(), nt, nv,
            *(o.data_ptr() for o in outs), _stream(data.device))
    _raise_on(err, "fused_vb_iter")


def _float_array(values):
    return (ctypes.c_float * len(values))(*values)


def launch_nlls(km, tcodes, consts, mode, marquardt, max_its, dof, params0,
                data, w, state, outs, vb):
    """consts: the 7 optimizer constants (ops/fused_nlls.py); mode: 0
    fresh, 1 phase 1, 2 resume; w: the [T] 0/1 weights on the device;
    state: [4,V] or None; outs: (params, cost, its, prec, cov, state_out)
    with None for what the mode does not write; vb: 0 streamed, > 0
    staged in blocks of vb lanes (launch_vb)."""
    lib = load()
    nt, nv = data.shape

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    with torch.cuda.device(data.device):
        err = lib.fabber_fused_nlls(
            km.kind, km.nparams, _int_array(tcodes), km.dt,
            _float_array(consts), mode, int(marquardt), max_its, dof,
            params0.data_ptr(), data.data_ptr(), w.data_ptr(), ptr(state),
            nt, nv, *(ptr(o) for o in outs), vb, _stream(data.device))
    _raise_on(err, "fused_nlls")


def nl_occupancy(kind, p, nq, mode, vb, nt):
    """Blocks per SM of kernel 6's (kind, P, Q) instance in MODE mode (0
    maxits, 1 pointzeroone/freduce, 2 trialmode/lm) and form vb at nt
    samples (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 where
    refused."""
    return int(load().fabber_nl_occupancy(kind, p, nq, mode, vb, nt))


def gen_occupancy(lib, mode, vb, nt):
    """nl_occupancy for a library of build_generated."""
    return int(lib.fabber_gen_occupancy(mode, vb, nt))


def nlls_occupancy(kind, p, mode, marquardt, vb, nt):
    """Blocks per SM of kernel 8's (kind, P) instance in mode (0 fresh, 1
    phase 1, 2 resume), with or without Marquardt damping, in form vb at
    nt samples; -1 where refused."""
    return int(load().fabber_nlls_occupancy(kind, p, mode, int(marquardt),
                                            vb, nt))


def launch_ar_loop(p, nq, n_iters, consts, detector, elbo, m0, rmr, dmr, pm,
                   pp, outs):
    """consts: [3nq*P*P + 2 + 6nq] float32 host tensor (pack_ar_consts);
    detector: a pointzeroone / freduce detector object or None (maxits);
    elbo: (f_const, lb_coeff) or None; outs: the eight planes, then f
    and its under a detector."""
    lib = load()
    nv = m0.shape[-1]
    f_const, lb_coeff = elbo if elbo is not None else (0.0, 0.0)
    ptrs = [o.data_ptr() for o in outs] + [0] * (10 - len(outs))
    with torch.cuda.device(m0.device):
        err = lib.fabber_fused_ar_loop(
            p, nq, n_iters, consts.data_ptr(), *detector_args(detector),
            f_const, lb_coeff, m0.data_ptr(), rmr.data_ptr(), dmr.data_ptr(),
            pm.data_ptr(), pp.data_ptr(), nv, *ptrs, _stream(m0.device))
    _raise_on(err, "fused_ar_loop")
