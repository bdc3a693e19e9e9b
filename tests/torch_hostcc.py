"""The port's CUDA device code compiled as host C++ with g++, for the CPU
tests: a shim header stands in for cuda_runtime.h (the CUDA qualifiers
as nothing, __ldg as a load, one block of one thread per call, so a
staged tile (tile.cuh) is one lane wide, and a warp too (the ballot and
atomicAdd of kernel 2's two-phase form, kept in the patched copy
probes/csrc/core_compact.cu); kernels 1's and 3's staged forms run a
block's lanes as threads that meet at __syncthreads), and at double the
kernel headers are text-substituted float -> double (vb_device.cuh,
detectors.cuh, tile.cuh, spectral_device.cuh, whole_device.cuh and
fused_nl_loop.cuh cut before its launch section; dual.cuh has both
overloads and is used as it is). Kernels 1 (spectral_stats.cu), 2
(spectral_core.cu), 3 (spectral_fused.cu), 4 (fused_whole.cu), 5
(fused_loop.cu), 7 (fused_vb_iter.cu), 8 (fused_nlls.cu) and 9
(fused_ar_loop.cu) are cut before their launch sections the same way;
kernels 1-3 and 9 also build at float32, the headers as they are (g++
contracts no multiply-add on x86-64's baseline, so the float32 build
rounds as the card's kernel does: fmaf and __fmaf_rn fused, every other
product and sum rounded apart). Tests skip when g++ is missing."""

import ctypes
import hashlib
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "fabber_core_tpu_torch" / "csrc"
PROBES_CSRC = Path(__file__).resolve().parents[1] / "probes" / "csrc"

SHIM = """#pragma once
#include <math.h>
#include <algorithm>
#include <condition_variable>
#include <mutex>
using std::max;
using std::min;
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
template <class T> inline T __ldg(const T* p) { return *p; }
// a block's barrier where its lanes run as threads (stats_kernel_fn's
// staged form); elsewhere a block is one thread and there is none
struct FabberHostBarrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned n = 1, arrived = 0, gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    const unsigned g = gen;
    if (++arrived == n) {
      arrived = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != g; });
    }
  }
};
static FabberHostBarrier* fabber_host_barrier = nullptr;
inline void __syncthreads() {
  if (fabber_host_barrier) fabber_host_barrier->wait();
}
// warps of one lane (one thread per block): the warp intrinsics of the
// two-phase form of kernel 2 (probes/csrc/core_compact.cu), and its
// atomicAdd on the compact buffer's count
inline unsigned __activemask() { return 1u; }
inline unsigned __ballot_sync(unsigned, int pred) { return pred ? 1u : 0u; }
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int atomicAdd(int* p, int v) {
  static std::mutex m;
  std::lock_guard<std::mutex> g(m);
  const int old = *p;
  *p += v;
  return old;
}
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline double __fmaf_rn(double a, double b, double c) { return fma(a, b, c); }
struct FabberDim3 { unsigned x, y, z; };
static FabberDim3 blockIdx = {0, 0, 0}, blockDim = {1, 1, 1},
                  gridDim = {1, 1, 1};
static thread_local FabberDim3 threadIdx = {0, 0, 0};
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
"""


# the prebuilt instance lists (csrc/spectral_device.cuh kMaxP, kernel 9's
# FABBER_AR_INSTANCES: P <= 8; csrc/whole_device.cuh
# FABBER_WHOLE_INSTANCES); the kernel functions below take a per-shape
# instance's kernel (the *_wide_fn at the end) past them
SPECTRAL_PREBUILT_P = 8


def whole_prebuilt(p, q):
    return p <= 8 and (q <= 2 or (q == 3 and p <= 5))


def have_gxx():
    return shutil.which("g++") is not None


def _to_double(text):
    text = re.sub(r"\bfloat\b(?!\.h)", "double", text)
    for f in ("expf", "logf", "log1pf", "sqrtf", "fabsf", "fminf",
              "fmaxf", "fmaf"):
        text = re.sub(rf"\b{f}\(", f"{f[:-1]}(", text)
    return text


def _write_headers(d, double=True):
    conv = _to_double if double else (lambda text: text)
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "dual.cuh").write_text((CSRC / "dual.cuh").read_text())
    for name in ("vb_device.cuh", "detectors.cuh", "tile.cuh",
                 "spectral_device.cuh", "whole_device.cuh", "coop_device.cuh",
                 "fulltime.cuh", "fused_whole_body.inc",
                 "fused_ar_loop_body.inc"):
        (d / name).write_text(conv((CSRC / name).read_text()))
    for name in ("fused_nl_loop.cuh", "fused_vb_iter.cuh",
                 "fused_nlls.cuh"):
        text = (CSRC / name).read_text()
        text = text[:text.index("// ---- launch ----")] + "}  // namespace\n"
        (d / name).write_text(conv(text))


def _kernel_source(name, marker, double):
    """A kernel's .cu cut before its launch section (marker), at double
    (text-substituted) or as it is."""
    src = (CSRC / name).read_text()
    src = src[:src.index(marker)]
    return _to_double(src) if double else src


def _build(d, name, src):
    (d / f"{name}.cpp").write_text(src)
    out = d / f"{name}.so"
    proc = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-pthread", "-shared", "-fPIC", "-w",
         "-I", str(d),
         "-o", str(out), str(d / f"{name}.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(out))


def build_source(tmpdir, name, src):
    """A library from src (C++ that may include the shim as
    "cuda_runtime.h" and the kernel headers, as the functions below
    write them) compiled with g++."""
    d = Path(tmpdir)
    _write_headers(d)
    return _build(d, name, src)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def functor_fn(tle, tmpdir):
    """fn(m [P], supp [S], t) -> (signal, model-space Jacobian [P]) of
    a TimeLocalEval's generated functor at double."""
    d = Path(tmpdir)
    _write_headers(d)
    src = ('#include "cuda_runtime.h"\n#include "dual.cuh"\n'
           "namespace {\nusing namespace fabber::gen;\n" + tle.source
           + "}  // namespace\n"
           'extern "C" double gen_eval(const double* m, const double* supp,'
           " double t, double* jac) {\n"
           "  return fabber::gen::eval_dual<GenModel, GenModel::P, double>("
           "m, supp, t, jac);\n}\n")
    lib = _build(d, "functor", src)
    lib.gen_eval.restype = ctypes.c_double
    lib.gen_eval.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_double, ctypes.c_void_p]

    def fn(m, supp, t):
        m = np.ascontiguousarray(m, np.float64)
        s = np.ascontiguousarray(supp if supp is not None else [0.0],
                                 np.float64)
        jac = np.zeros(len(m))
        sig = lib.gen_eval(_ptr(m), _ptr(s), float(t), _ptr(jac))
        return sig, jac
    return fn


def full_functor_fn(tle, tmpdir):
    """fn(m [P], supp [S] or None) -> (signal [T], model-space Jacobian
    [P,T]) of a TimeLocalEval's full-time functor (csrc/fulltime.cuh
    run_dual) at double, one host thread taking every sample (lane 0 of
    1, so its barriers wait for no other)."""
    assert tle.full_time
    d = Path(tmpdir)
    _write_headers(d)
    src = ('#include "cuda_runtime.h"\n#include "dual.cuh"\n'
           '#include "fulltime.cuh"\n'
           "namespace {\nusing namespace fabber::gen;\n"
           + _to_double(tle.source) + "}  // namespace\n"
           'extern "C" void gen_full(const double* m, const double* supp,'
           " const double* cst, double* sh, double* out) {\n"
           "  fabber::gen::run_dual<GenModel, double>(m, supp, cst, sh, out,"
           " 0, 1);\n}\n")
    lib = _build(d, "full_functor_" + _functor_model(tle)[1], src)
    vp = ctypes.c_void_p
    lib.gen_full.argtypes = [vp, vp, vp, vp, vp]
    cst = np.ascontiguousarray(
        [0.0] if tle.consts is None else tle.consts, np.float64)
    nt = int(re.search(r"NT = (\d+);", tle.source).group(1))

    def fn(m, supp=None):
        m = np.ascontiguousarray(m, np.float64)
        s = np.ascontiguousarray(supp if supp is not None else [0.0],
                                 np.float64)
        sh = np.zeros(max(tle.smem_floats, 1))
        out = np.zeros((len(m) + 1) * nt)
        lib.gen_full(_ptr(m), _ptr(s), _ptr(cst), _ptr(sh), _ptr(out))
        out = out.reshape(len(m) + 1, nt)
        return out[0], out[1:]
    return fn


def kernel_fn(functor, q, tmpdir, staged=True):
    """The whole-loop kernel (fused_nl_loop.cuh) with a hand-written
    functor of vb_device.cuh (its C++ name, e.g. "ExpSum<3>") or a
    TimeLocalEval's generated one, at double, in its staged (tile.cuh) or
    streamed form, one block of one thread per voxel: fn(tcodes,
    n_iters, need_f, consts [4Q], det (kind, tol, max_its, max_trials,
    init_save), det_consts [Q+2], centre0, pm, pp, pd0 [P,V], data
    [T,V], supp [S,V] or None, qw [T,Q]) -> the seven outputs. A
    hand-written functor's dt is an argument of the kernel: fn's dt
    keyword (a generated one has its own)."""
    d = Path(tmpdir)
    _write_headers(d)
    model, name = _functor_model(functor)
    src = _kernel_head("fused_nl_loop.cuh", functor) + f"""
namespace {{
using Model = {model};
using HK = VBParamsFor<Model::P, {q}>;
using HD = NLDetConstsFor<{q}>;
template <int MODE>
static void run_all(const HK& k, const HD& dc, const double* const* in,
                    double* const* out) {{
  const auto kp = params_for<Model::P, {q}>(k);
  const auto dp = det_consts_for<{q}>(dc);
  for (long long v = 0; v < k.V; ++v) {{
    blockIdx.x = (unsigned)v;
    fused_nl_loop_kernel<Model, {q}, MODE, {"true" if staged else "false"}>(
        kp, dp, in[0], in[1], in[2], in[3], in[4], in[5], in[6], out[0],
        out[1], out[2], out[3], out[4], out[5], out[6]);
  }}
}}
}}  // namespace
extern "C" int host_nl_loop(const int* tcodes, double dt, int n_iters,
                            int need_f, const double* consts, int det_kind,
                            double det_tol, int det_max_its,
                            int det_max_trials, int det_init_save,
                            const double* det_consts,
                            const double* const* in, double* const* out,
                            int nt, long long V) {{
  HK k;
  HD dc;
  if (!nl_setup(Model::P, {q}, tcodes, dt, n_iters, need_f, -1.0, consts,
                det_kind, det_tol, det_max_its, det_max_trials,
                det_init_save, det_consts, in[3], nt, V, &k, &dc))
    return 1;
  if (det_kind == 0) run_all<0>(k, dc, in, out);
  else if (det_kind <= 2) run_all<1>(k, dc, in, out);
  else run_all<2>(k, dc, in, out);
  return 0;
}}
"""
    lib = _build(d, f"kernel_{name}_q{q}_{'staged' if staged else 'streamed'}",
                 src)
    lib.host_nl_loop.restype = ctypes.c_int
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_nl_loop.argtypes = [vp, ctypes.c_double, i32, i32, vp, i32,
                                 ctypes.c_double, i32, i32, i32, vp, vp, vp,
                                 i32, ctypes.c_longlong]

    def fn(tcodes, n_iters, need_f, consts, det, det_consts, centre0, pm,
           pp, pd0, data, supp, qw, dt=0.0):
        nt, nv = data.shape
        p = centre0.shape[0]
        fq = q if det[0] == 0 else (2 if det[0] == 2 else 1)
        outs = [np.zeros(s) for s in ((p, nv), (p, p, nv), (p, p, nv),
                                      (q, nv), (q, nv), (fq, nv), (fq, nv))]
        ins = [np.ascontiguousarray(x, np.float64) if x is not None
               else None for x in (centre0, pm, pp, pd0, data, supp, qw)]
        in_ptrs = (ctypes.c_void_p * 7)(*[
            None if x is None else x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 7)(*[o.ctypes.data for o in outs])
        tc = (ctypes.c_int * p)(*tcodes)
        cs = np.ascontiguousarray(consts, np.float64)
        dcs = np.ascontiguousarray(det_consts, np.float64)
        rc = lib.host_nl_loop(tc, dt, n_iters, int(need_f), _ptr(cs),
                              det[0], det[1], det[2], det[3], det[4],
                              _ptr(dcs), in_ptrs, out_ptrs, nt, nv)
        assert rc == 0
        return outs
    return fn


def full_kernel_fn(functor, q, tmpdir):
    """Kernel 6's full-time form (fused_nl_loop.cuh
    fused_nl_loop_full_kernel, cut before its launch section) with a
    TimeLocalEval's full-time functor (models/kernelgen.py) at Q groups,
    at double: a block of kCoopThreads threads per voxel, each a host
    thread meeting the others at __syncthreads, as kernel 7's cooperative
    form runs in vb_iter_kernel_fn: fn(tcodes, n_iters, need_f, consts
    [4Q], det (kind, tol, max_its, max_trials, init_save), det_consts
    [Q+2], centre0, pm, pp, pd0 [P,V], data [T,V], supp [S,V] or None, qw
    [T,Q]) -> the seven outputs; the functor's constants ride along. Also
    fn.smem: the block's bytes (FullLayout::bytes at float32 sizes, the
    float count times 4)."""
    assert functor.full_time
    d = Path(tmpdir)
    _write_headers(d)
    _, name = _functor_model(functor)
    src = "#include <thread>\n#include <vector>\n" + _kernel_head(
        "fused_nl_loop.cuh", functor) + f"""
namespace {{
using HK = VBParamsFor<GenModel::P, {q}>;
using HD = NLDetConstsFor<{q}>;
template <int MODE>
static void run_all(const HK& k, const HD& dc, const double* const* in,
                    double* const* out) {{
  const auto kp = params_for<GenModel::P, {q}>(k);
  const auto dp = det_consts_for<{q}>(dc);
  FabberHostBarrier bar;
  bar.n = (unsigned)kCoopThreads;
  fabber_host_barrier = &bar;
  blockDim.x = (unsigned)kCoopThreads;
  for (long long v = 0; v < k.V; ++v) {{
    blockIdx.x = (unsigned)v;
    std::vector<std::thread> lanes;
    for (int l = 0; l < kCoopThreads; ++l)
      lanes.emplace_back([=, &kp, &dp] {{
        threadIdx.x = (unsigned)l;
        fused_nl_loop_full_kernel<GenModel, {q}, MODE>(
            kp, dp, in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
            out[0], out[1], out[2], out[3], out[4], out[5], out[6]);
      }});
    for (auto& th : lanes) th.join();
  }}
  blockDim.x = 1;
  fabber_host_barrier = nullptr;
}}
}}  // namespace
extern "C" long long host_full_floats() {{
  return FullLayout<GenModel, {q}>::floats;
}}
extern "C" int host_nl_loop_full(const int* tcodes, int n_iters, int need_f,
                                 const double* consts, int det_kind,
                                 double det_tol, int det_max_its,
                                 int det_max_trials, int det_init_save,
                                 const double* det_consts,
                                 const double* const* in,
                                 double* const* out, int nt, long long V) {{
  HK k;
  HD dc;
  if (!nl_setup(GenModel::P, {q}, tcodes, 0.0, n_iters, need_f, -1.0,
                consts, det_kind, det_tol, det_max_its, det_max_trials,
                det_init_save, det_consts, in[3], nt, V, &k, &dc) ||
      nt != GenModel::NT)
    return 1;
  if (det_kind == 0) run_all<0>(k, dc, in, out);
  else if (det_kind <= 2) run_all<1>(k, dc, in, out);
  else run_all<2>(k, dc, in, out);
  return 0;
}}
"""
    lib = _build(d, f"full_{name}_q{q}", src)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_nl_loop_full.restype = i32
    lib.host_nl_loop_full.argtypes = [vp, i32, i32, vp, i32, ctypes.c_double,
                                      i32, i32, i32, vp, vp, vp, i32,
                                      ctypes.c_longlong]
    lib.host_full_floats.restype = ctypes.c_longlong
    cst = None if functor.consts is None else np.ascontiguousarray(
        functor.consts, np.float64)

    def fn(tcodes, n_iters, need_f, consts, det, det_consts, centre0, pm,
           pp, pd0, data, supp, qw):
        nt, nv = data.shape
        p = centre0.shape[0]
        fq = q if det[0] == 0 else (2 if det[0] == 2 else 1)
        outs = [np.zeros(s) for s in ((p, nv), (p, p, nv), (p, p, nv),
                                      (q, nv), (q, nv), (fq, nv), (fq, nv))]
        ins = [np.ascontiguousarray(x, np.float64) if x is not None
               else None for x in (centre0, pm, pp, pd0, data, supp, qw)]
        ins.append(cst)
        in_ptrs = (ctypes.c_void_p * 8)(*[
            None if x is None else x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 7)(*[o.ctypes.data for o in outs])
        tc = (ctypes.c_int * p)(*tcodes)
        cs = np.ascontiguousarray(consts, np.float64)
        dcs = np.ascontiguousarray(det_consts, np.float64)
        rc = lib.host_nl_loop_full(tc, n_iters, int(need_f), _ptr(cs),
                                   det[0], det[1], det[2], det[3], det[4],
                                   _ptr(dcs), in_ptrs, out_ptrs, nt, nv)
        assert rc == 0
        return outs
    fn.smem = 4 * lib.host_full_floats()
    return fn


def _functor_model(functor):
    """(the C++ model type, a file-name tag) of a hand-written functor's
    name or a TimeLocalEval's generated GenModel."""
    if isinstance(functor, str):
        return functor, re.sub(r"\W", "", functor)
    return "GenModel", "gen" + hashlib.sha256(
        functor.source.encode()).hexdigest()[:12]


def _kernel_head(header, functor):
    """The source's head: the shim, dual.cuh, a kernel header and, for a
    TimeLocalEval, its generated functor, at double."""
    src = '#include "cuda_runtime.h"\n#include "dual.cuh"\n' \
        f'#include "{header}"\n'
    if not isinstance(functor, str):
        src += ("namespace {\nusing namespace fabber::gen;\n"
                + _to_double(functor.source) + "}  // namespace\n")
    return src


def nlls_kernel_fn(functor, tmpdir, staged=True):
    """The NLLS kernel (fused_nlls.cuh, cut before its launch section) with
    a hand-written functor of vb_device.cuh (functor: its C++ name, e.g.
    "ExpSum<2>") or a TimeLocalEval's generated one (models/kernelgen.py;
    its dt is its own), at double, in its staged or streamed form, one
    block of one thread per voxel: fn(mode, marquardt, tcodes, dt, consts
    [7], max_its, dof, params0 [P,V], data [T,V], w [T], state [4,V] or
    None) -> (params, cost, its, prec, cov, state_out) with zeros for
    what the mode does not write."""
    d = Path(tmpdir)
    _write_headers(d)
    model, name = _functor_model(functor)
    src = _kernel_head("fused_nlls.cuh", functor) + f"""
namespace {{
using Model = {model};
using HK = NLLSParamsFor<Model::P>;
template <int MODE, bool MARQ>
static void run_all(const HK& k, const double* const* in,
                    double* const* out) {{
  const auto kp = nlls_params_for<Model::P>(k);
  for (long long v = 0; v < k.V; ++v) {{
    blockIdx.x = (unsigned)v;
    fused_nlls_kernel<Model, MODE, MARQ, {"true" if staged else "false"}>(
        kp, in[0], in[1], in[2], in[3], out[0], out[1], out[2], out[3],
        out[4], out[5]);
  }}
}}
}}  // namespace
extern "C" void host_nlls(int mode, int marq, const int* tcodes, double dt,
                          const double* consts, int max_its, double dof,
                          const double* const* in, double* const* out,
                          int nt, long long V) {{
  HK k = {{}};
  for (int i = 0; i < Model::P; ++i) k.tcode[i] = tcodes[i];
  k.dt = dt;
  k.max_its = max_its;
  k.lam_init = consts[0];
  k.grow = consts[1];
  k.shrink = consts[2];
  k.lam_max = consts[3];
  k.prec_floor = consts[4];
  k.cftol = consts[5];
  k.plateau = consts[6];
  k.dof = dof;
  k.nt = nt;
  k.V = V;
  switch (mode * 2 + marq) {{
    case 0: run_all<kFresh, false>(k, in, out); break;
    case 1: run_all<kFresh, true>(k, in, out); break;
    case 2: run_all<kPhase1, false>(k, in, out); break;
    case 3: run_all<kPhase1, true>(k, in, out); break;
    case 4: run_all<kResume, false>(k, in, out); break;
    default: run_all<kResume, true>(k, in, out);
  }}
}}
"""
    lib = _build(d, f"nlls_{name}_{'staged' if staged else 'streamed'}",
                 src)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_nlls.restype = None
    lib.host_nlls.argtypes = [i32, i32, vp, ctypes.c_double, vp, i32,
                              ctypes.c_double, vp, vp, i32,
                              ctypes.c_longlong]

    def fn(mode, marquardt, tcodes, dt, consts, max_its, dof, params0,
           data, w, state):
        nt, nv = data.shape
        p = params0.shape[0]
        outs = [np.zeros(s) for s in ((p, nv), (nv,), (nv,), (p, p, nv),
                                      (p, p, nv), (4, nv))]
        ins = [np.ascontiguousarray(x, np.float64) if x is not None
               else None for x in (params0, data, w, state)]
        in_ptrs = (ctypes.c_void_p * 4)(*[
            None if x is None else x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 6)(*[o.ctypes.data for o in outs])
        tc = (ctypes.c_int * p)(*tcodes)
        cs = np.ascontiguousarray(consts, np.float64)
        lib.host_nlls(mode, int(marquardt), tc, dt, _ptr(cs), max_its, dof,
                      in_ptrs, out_ptrs, nt, nv)
        return outs
    return fn


def _functor_p(functor):
    """P of a hand-written functor's C++ name or a TimeLocalEval."""
    if not isinstance(functor, str):
        return functor.nparams
    m = re.fullmatch(r"(ExpSum|PolyModel)<(\d+)>", functor)
    return int(m.group(2)) * (2 if m.group(1) == "ExpSum" else 1)


def vb_iter_kernel_fn(functor, q, tmpdir):
    """Kernel 7 (fused_vb_iter.cuh, cut before its launch section) with a
    hand-written functor of vb_device.cuh (its C++ name, e.g.
    "ExpSum<2>") or a TimeLocalEval's generated one (models/kernelgen.py;
    its dt is its own) at Q groups, at double, in the form a per-shape
    unit at its (P, Q) compiles (ops/_cuda.py _roll_define, and the
    header's kIterCoop): the per-lane form (both of its forms in one
    library, one block of one thread per voxel) or, past rolled_loops'
    sizes, the cooperative form (fused_vb_iter_coop_kernel, a block of
    kCoopThreads threads per voxel, each a host thread meeting the others
    at __syncthreads; staged is ignored): fn(staged, tcodes, dt, need_f,
    centre, pm, pp [P,V], phi [Q,V], data [T,V], qw [T,Q], alpha [V] or
    None) -> the seven outputs (means, prec, cov, nkqk, ntr, fkqk,
    ftr)."""
    from fabber_core_tpu_torch.ops import _cuda
    roll = _cuda._roll_define(_functor_p(functor), q)
    d = Path(tmpdir)
    _write_headers(d)
    model, name = _functor_model(functor)
    runner = f"""
template <bool LM, bool STAGED>
static void run_all(const HK& k, const double* const* in,
                    double* const* out) {{
  const auto kp = params_for<Model::P, {q}>(k);
  if constexpr (kIterCoop) {{
    FabberHostBarrier bar;
    bar.n = (unsigned)kCoopThreads;
    fabber_host_barrier = &bar;
    blockDim.x = (unsigned)kCoopThreads;
    for (long long v = 0; v < k.V; ++v) {{
      blockIdx.x = (unsigned)v;
      std::vector<std::thread> lanes;
      for (int l = 0; l < kCoopThreads; ++l)
        lanes.emplace_back([=, &kp] {{
          threadIdx.x = (unsigned)l;
          fused_vb_iter_coop_kernel<Model, {q}, LM>(
              kp, in[0], in[1], in[2], in[3], in[4], in[5], in[6], out[0],
              out[1], out[2], out[3], out[4], out[5], out[6]);
        }});
      for (auto& th : lanes) th.join();
    }}
    blockDim.x = 1;
    fabber_host_barrier = nullptr;
  }} else {{
    for (long long v = 0; v < k.V; ++v) {{
      blockIdx.x = (unsigned)v;
      fused_vb_iter_kernel<Model, {q}, LM, STAGED>(
          kp, in[0], in[1], in[2], in[3], in[4], in[5], in[6], out[0],
          out[1], out[2], out[3], out[4], out[5], out[6]);
    }}
  }}
}}"""
    src = roll + "#include <thread>\n#include <vector>\n" + _kernel_head(
        "fused_vb_iter.cuh", functor) + f"""
namespace {{
using Model = {model};
using HK = VBParamsFor<Model::P, {q}>;
{runner}
}}  // namespace
extern "C" void host_vb_iter(int staged, const int* tcodes, double dt,
                             int need_f, const double* const* in,
                             double* const* out, int nt, long long V) {{
  HK k = {{}};
  for (int i = 0; i < Model::P; ++i) k.tcode[i] = tcodes[i];
  k.dt = dt;
  k.need_f = need_f;
  k.nt = nt;
  k.V = V;
  const bool lm = in[6] != nullptr;
  if (staged) {{
    if (lm) run_all<true, true>(k, in, out);
    else run_all<false, true>(k, in, out);
  }} else {{
    if (lm) run_all<true, false>(k, in, out);
    else run_all<false, false>(k, in, out);
  }}
}}
"""
    lib = _build(d, f"iter_{name}_q{q}", src)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_vb_iter.restype = None
    lib.host_vb_iter.argtypes = [i32, vp, ctypes.c_double, i32, vp, vp, i32,
                                 ctypes.c_longlong]

    def fn(staged, tcodes, dt, need_f, centre, pm, pp, phi, data, qw,
           alpha):
        nt, nv = data.shape
        p = centre.shape[0]
        outs = [np.zeros(s) for s in ((p, nv), (p, p, nv), (p, p, nv),
                                      (q, nv), (q, nv), (q, nv), (q, nv))]
        ins = [np.ascontiguousarray(x, np.float64) if x is not None
               else None for x in (centre, pm, pp, phi, data, qw, alpha)]
        in_ptrs = (ctypes.c_void_p * 7)(*[
            None if x is None else x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 7)(*[o.ctypes.data for o in outs])
        tc = (ctypes.c_int * p)(*tcodes)
        lib.host_vb_iter(int(staged), tc, dt, int(need_f), in_ptrs,
                         out_ptrs, nt, nv)
        return outs
    return fn


def whole_kernel_fn(p, q, tmpdir):
    """Kernel 4 (fused_whole.cu, cut before its launch section) at (P, Q),
    at double, both forms in one library, one block of one thread per
    voxel: fn(staged, n_iters, locked_sd, consts [Q*P*P + 4Q], det (kind,
    tol, max_its, max_trials, init_save), det_consts [Q+1], data [T,V],
    tconsts [(P + QP + Q), T], pm, pp [P,V]) -> the seven outputs (means,
    prec, cov, b, c, then fkqk and ftr [Q,V] under maxits or F and the
    iteration count [1,V] under a detector)."""
    if not whole_prebuilt(p, q):
        return whole_wide_fn(p, q, tmpdir)
    d = Path(tmpdir)
    _write_headers(d)
    src = (CSRC / "fused_whole.cu").read_text()
    src = src[:src.index("// ---- launch and C entry points")]
    src = _to_double(src) + f"""
template <int MODE, bool STAGED>
static void run_all(const WholeConsts& k, const double* const* in,
                    double* const* out) {{
  for (long long v = 0; v < k.V; ++v) {{
    blockIdx.x = (unsigned)v;
    fused_whole_kernel<{p}, {q}, MODE, STAGED>(
        k, in[0], in[1], in[2], in[3], out[0], out[1], out[2], out[3],
        out[4], out[5], out[6]);
  }}
}}
template <bool STAGED>
static void run_mode(const WholeConsts& k, const double* const* in,
                     double* const* out) {{
  if (k.d.kind == kMaxits) run_all<0, STAGED>(k, in, out);
  else if (k.d.kind == kPointZeroOne) run_all<1, STAGED>(k, in, out);
  else run_all<2, STAGED>(k, in, out);
}}
}}  // namespace
extern "C" void host_whole(int staged, int n_iters, double locked_sd,
                           const double* consts, const int* det,
                           double det_tol, const double* det_consts,
                           const double* const* in, double* const* out,
                           int nt, long long V) {{
  const int p = {p}, q = {q}, n = q * p * p;
  WholeConsts k = {{}};
  for (int i = 0; i < n; ++i) k.dtqd[i] = consts[i];
  for (int i = 0; i < q; ++i) {{
    k.inv_b0[i] = consts[n + i];
    k.c_post[i] = consts[n + q + i];
    k.b_init[i] = consts[n + 2 * q + i];
    k.c_init[i] = consts[n + 3 * q + i];
    k.lb_coeff[i] = det_consts[i];
  }}
  k.f_const = det_consts[q];
  k.locked_sd = locked_sd;
  k.n_iters = n_iters;
  k.nt = nt;
  k.V = V;
  k.d = {{det[0], det_tol, det[1], det[2], det[3]}};
  if (staged) run_mode<true>(k, in, out);
  else run_mode<false>(k, in, out);
}}
"""
    lib = _build(d, f"whole_p{p}_q{q}", '#include "cuda_runtime.h"\n' + src)
    return _whole_lib_fn(lib, p, q)


def loop_kernel_fn(p, q, tmpdir):
    """Kernel 5 (fused_loop.cu, cut before its launch section) at (P, Q),
    at double, one block of one thread per voxel: fn(n_iters, locked_sd,
    consts [Q*P*P + 4Q], m0 [P,V], rtqr [Q,V], dtqr [Q,P,V], pm, pp
    [P,V]) -> (means [P,V], prec, cov [P,P,V], b, c [Q,V])."""
    if not whole_prebuilt(p, q):
        return loop_wide_fn(p, q, tmpdir)
    d = Path(tmpdir)
    _write_headers(d)
    src = _kernel_source("fused_loop.cu", "// ---- launch and C entry points",
                         True) + f"""
}}  // namespace
extern "C" void host_loop(int n_iters, double locked_sd,
                          const double* consts, const double* const* in,
                          double* const* out, long long V) {{
  const WholeConsts k = make_consts({p}, {q}, n_iters, locked_sd, consts,
                                    1, V);
  for (long long v = 0; v < V; ++v) {{
    blockIdx.x = (unsigned)v;
    fused_loop_kernel<{p}, {q}>(k, in[0], in[1], in[2], in[3], in[4],
                                out[0], out[1], out[2], out[3], out[4]);
  }}
}}
"""
    lib = _build(d, f"loop_p{p}_q{q}", '#include "cuda_runtime.h"\n' + src)
    vp = ctypes.c_void_p
    lib.host_loop.restype = None
    lib.host_loop.argtypes = [ctypes.c_int, ctypes.c_double, vp, vp, vp,
                              ctypes.c_longlong]

    def fn(n_iters, locked_sd, consts, m0, rtqr, dtqr, pm, pp):
        nv = m0.shape[-1]
        ins = [np.ascontiguousarray(x, np.float64)
               for x in (m0, rtqr, dtqr, pm, pp)]
        outs = [np.zeros(s) for s in ((p, nv), (p, p, nv), (p, p, nv),
                                      (q, nv), (q, nv))]
        in_ptrs = (ctypes.c_void_p * 5)(*[x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 5)(*[o.ctypes.data for o in outs])
        cs = np.ascontiguousarray(consts, np.float64)
        lib.host_loop(n_iters, locked_sd, _ptr(cs), in_ptrs, out_ptrs, nv)
        return outs
    return fn


def stats_kernel_fn(p, tmpdir, double=True):
    """Kernel 1 (spectral_stats.cu, cut before its launch section) at P,
    at double or float32, both forms in one library: fn(staged, data
    [T,V], tconsts [2P+1,T], aconsts [P*P], vb=32, offset=0) -> (m0
    [P,V], rtqr [1,V], dtqr [P,V]). Streamed: one block of one thread per
    voxel. Staged: blocks of vb lanes, each lane a thread, so the tile's
    16-byte chunks, its rotated rows and the ragged last block run as on
    the card; offset puts the plane that many elements past the start of
    its buffer (rows off 16-byte alignment)."""
    if p > SPECTRAL_PREBUILT_P:
        return stats_wide_fn(p, tmpdir, double)
    d = Path(tmpdir)
    _write_headers(d, double)
    real = "double" if double else "float"
    src = _kernel_source("spectral_stats.cu",
                         "// ---- launch and C entry points", double) + f"""
static void run_streamed(const {real}* data, const {real}* tc,
                         const SolveConsts& ac, int nt, long long V,
                         {real}* m0, {real}* rtqr, {real}* dtqr) {{
  for (long long v = 0; v < V; ++v) {{
    blockIdx.x = (unsigned)v;
    spectral_stats_kernel<{p}, false>(data, tc, nt, V, ac, m0, rtqr, dtqr);
  }}
}}
static void run_staged(const {real}* data, const {real}* tc,
                       const SolveConsts& ac, int nt, long long V,
                       {real}* m0, {real}* rtqr, {real}* dtqr, int vb) {{
  FabberHostBarrier bar;
  bar.n = (unsigned)vb;
  fabber_host_barrier = &bar;
  blockDim.x = (unsigned)vb;
  for (long long b = 0; b * vb < V; ++b) {{
    blockIdx.x = (unsigned)b;
    std::vector<std::thread> lanes;
    for (int l = 0; l < vb; ++l)
      lanes.emplace_back([=, &ac] {{
        threadIdx.x = (unsigned)l;
        spectral_stats_kernel<{p}, true>(data, tc, nt, V, ac, m0, rtqr, dtqr);
      }});
    for (auto& th : lanes) th.join();
  }}
  blockDim.x = 1;
  fabber_host_barrier = nullptr;
}}
}}  // namespace
extern "C" void host_stats(int vb, const {real}* data, const {real}* tc,
                           const {real}* a, int nt, long long V, {real}* m0,
                           {real}* rtqr, {real}* dtqr) {{
  SolveConsts ac = {{}};
  for (int i = 0; i < {p} * {p}; ++i) ac.a[i] = a[i];
  if (vb > 0) run_staged(data, tc, ac, nt, V, m0, rtqr, dtqr, vb);
  else run_streamed(data, tc, ac, nt, V, m0, rtqr, dtqr);
}}
"""
    lib = _build(d, f"stats_p{p}_{real}", '#include "cuda_runtime.h"\n'
                 "#include <thread>\n#include <vector>\n" + src)
    vp = ctypes.c_void_p
    lib.host_stats.restype = None
    lib.host_stats.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int,
                               ctypes.c_longlong, vp, vp, vp]
    dt = np.float64 if double else np.float32

    def fn(staged, data, tconsts, aconsts, vb=32, offset=0):
        nt, nv = data.shape
        buf = np.zeros(data.size + offset, dt)
        buf[offset:] = np.asarray(data, dt).ravel()
        ins = [buf[offset:]] + [np.ascontiguousarray(x, dt)
                                for x in (tconsts, aconsts)]
        outs = [np.zeros(s, dt) for s in ((p, nv), (1, nv), (p, nv))]
        lib.host_stats(vb if staged else 0, *(_ptr(x) for x in ins), nt, nv,
                       *(_ptr(o) for o in outs))
        return outs
    return fn


def ar_kernel_fn(p, nq, tmpdir, double=True):
    """Kernel 9 (fused_ar_loop.cu, cut before its launch section) at (P,
    nq), at double or float32, one block of one thread per voxel:
    fn(n_iters, consts [3nq P^2 + 2 + 6nq], det (kind, tol, max_its,
    max_trials, init_save), elbo (f_const, lb_coeff), m0 [P,V], rmr
    [3nq,V], dmr [3nq,P,V], pm, pp [P,V]) -> the eight planes (means,
    prec, cov, amu, acov, aprec, b, c), then f and its [1,V] under a
    detector (kind > 0)."""
    if p > SPECTRAL_PREBUILT_P:
        return ar_wide_fn(p, nq, tmpdir, double)
    d = Path(tmpdir)
    _write_headers(d, double)
    real = "double" if double else "float"
    src = _kernel_source("fused_ar_loop.cu",
                         "// ---- launch and C entry points", double) + f"""
template <int MODE>
static void run_all(const ArConsts& k, const {real}* const* in,
                    {real}* const* out) {{
  for (long long v = 0; v < k.V; ++v) {{
    blockIdx.x = (unsigned)v;
    fused_ar_loop_kernel<{p}, {nq}, MODE>(
        k, in[0], in[1], in[2], in[3], in[4], out[0], out[1], out[2],
        out[3], out[4], out[5], out[6], out[7], out[8], out[9]);
  }}
}}
}}  // namespace
extern "C" void host_ar(int n_iters, const {real}* consts, const int* det,
                        {real} det_tol, {real} f_const, {real} lb_coeff,
                        const {real}* const* in, {real}* const* out,
                        long long V) {{
  const int p = {p}, nq = {nq}, n = kSpecs * nq * p * p;
  ArConsts k = {{}};
  for (int i = 0; i < n; ++i) k.dmd[i] = consts[i];
  k.ap[0] = consts[n];
  k.ap[1] = consts[n + 1];
  for (int q = 0; q < nq; ++q) {{
    k.inv_b0[q] = consts[n + 2 + q];
    k.c_post[q] = consts[n + 2 + nq + q];
    k.init_b[q] = consts[n + 2 + 2 * nq + q];
    k.init_c[q] = consts[n + 2 + 3 * nq + q];
    k.init_acov[q] = consts[n + 2 + 4 * nq + q];
    k.init_aprec[q] = consts[n + 2 + 5 * nq + q];
  }}
  k.n_iters = n_iters;
  k.V = V;
  k.d = {{det[0], det_tol, det[1], det[2], det[3]}};
  k.f_const = f_const;
  k.lb_coeff = lb_coeff;
  if (det[0] == 0) run_all<0>(k, in, out);
  else run_all<1>(k, in, out);
}}
"""
    lib = _build(d, f"ar_p{p}_q{nq}_{real}",
                 '#include "cuda_runtime.h"\n' + src)
    vp = ctypes.c_void_p
    cr = ctypes.c_double if double else ctypes.c_float
    lib.host_ar.restype = None
    lib.host_ar.argtypes = [ctypes.c_int, vp, vp, cr, cr, cr, vp, vp,
                            ctypes.c_longlong]
    dt = np.float64 if double else np.float32

    def fn(n_iters, consts, det, elbo, m0, rmr, dmr, pm, pp):
        nv = m0.shape[-1]
        ins = [np.ascontiguousarray(x, dt) for x in (m0, rmr, dmr, pm, pp)]
        shapes = [(p, nv), (p, p, nv), (p, p, nv)] + [(nq, nv)] * 5
        if det[0] != 0:
            shapes += [(1, nv), (1, nv)]
        outs = [np.zeros(s, dt) for s in shapes]
        in_ptrs = (ctypes.c_void_p * 5)(*[x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 10)(*([o.ctypes.data for o in outs]
                                            + [None] * (10 - len(outs))))
        cs = np.ascontiguousarray(consts, dt)
        dk = (ctypes.c_int * 4)(det[0], det[2], det[3], det[4])
        lib.host_ar(n_iters, _ptr(cs), dk, det[1], elbo[0], elbo[1],
                    in_ptrs, out_ptrs, nv)
        return outs
    return fn


def _core_source(p, double):
    """Kernel 2 (spectral_core.cu) cut before its launch section, with
    run_all<KIND>(in, k, det, n_iters, V, out): every voxel of the KIND
    instance, one block of one thread each."""
    real = "double" if double else "float"
    return _kernel_source("spectral_core.cu",
                          "// ---- launch and C entry point", double) + f"""
template <int KIND>
static void run_all(const {real}* const* in, const CoreConsts& k,
                    const DetParams& det, int n_iters, long long V,
                    {real}* const* out) {{
  for (long long v = 0; v < V; ++v) {{
    blockIdx.x = (unsigned)v;
    spectral_core_kernel<{p}, KIND>(in[0], in[1], in[2], in[3], k, det,
                                    n_iters, V, out[0], out[1], out[2],
                                    out[3], out[4], out[5], out[6]);
  }}
}}
}}  // namespace
"""


def _core_lib_fn(lib, p, double):
    """fn(m0 [P,V], rtqr [1,V], dtqr [P,V], pm [P,V], consts, n_iters,
    det) -> the seven outputs of lib's host_core."""
    vp = ctypes.c_void_p
    cr = ctypes.c_double if double else ctypes.c_float
    lib.host_core.restype = None
    lib.host_core.argtypes = [vp, vp, vp, cr, ctypes.c_int,
                              ctypes.c_longlong, vp]
    dt = np.float64 if double else np.float32

    def fn(m0, rtqr, dtqr, pm, consts, n_iters, det):
        nv = m0.shape[-1]
        ins = [np.ascontiguousarray(x, dt) for x in (m0, rtqr, dtqr, pm)]
        outs = [np.zeros(s, dt) for s in ((p, nv), (p, p, nv), (p, p, nv),
                                          (1, nv), (1, nv), (1, nv), (1, nv))]
        in_ptrs = (ctypes.c_void_p * 4)(*[x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 7)(*[o.ctypes.data for o in outs])
        cs = np.ascontiguousarray(consts, dt)
        dk = (ctypes.c_int * 4)(det[0], det[2], det[3], det[4])
        lib.host_core(in_ptrs, _ptr(cs), dk, det[1], n_iters, nv, out_ptrs)
        return outs
    return fn


_HOST_CORE_HEAD = """extern "C" void host_core(const {real}* const* in, const {real}* consts,
                          const int* det, {real} det_tol, int n_iters,
                          long long V, {real}* const* out) {{
  CoreConsts k = {{}};
  for (int i = 0; i < 4 * {p} * {p} + 2 * {p} + 6; ++i) k.v[i] = consts[i];
  const DetParams dp = {{det[0], det_tol, det[1], det[2], det[3]}};
"""


def core_kernel_fn(p, tmpdir, double=True):
    """Kernel 2 (spectral_core.cu, cut before its launch section) at P, at
    double or float32, every detector instance (KIND) in one library, one
    block of one thread per voxel: fn(m0 [P,V], rtqr [1,V], dtqr [P,V],
    pm [P,V], consts [4P^2+2P+6], n_iters, det (kind, tol, max_its,
    max_trials, init_save)) -> the seven outputs (means, prec, cov, b, c,
    F, tr or the lane's iteration count)."""
    if p > SPECTRAL_PREBUILT_P:
        return core_wide_fn(p, tmpdir, double)
    d = Path(tmpdir)
    _write_headers(d, double)
    real = "double" if double else "float"
    src = _core_source(p, double) + _HOST_CORE_HEAD.format(
        real=real, p=p) + """  switch (det[0]) {
    case 0: run_all<0>(in, k, dp, n_iters, V, out); break;
    case 1: run_all<1>(in, k, dp, n_iters, V, out); break;
    case 2: run_all<2>(in, k, dp, n_iters, V, out); break;
    default: run_all<3>(in, k, dp, n_iters, V, out);
  }
}
"""
    lib = _build(d, f"core_p{p}_{real}", '#include "cuda_runtime.h"\n' + src)
    return _core_lib_fn(lib, p, double)


def core_two_phase_fn(p, tmpdir, double=True):
    """The two-phase trialmode form of kernel 2 that the patched copy
    probes/csrc/core_compact.cu keeps (its device code between its
    include of spectral_core.cu and its block-local form, on kernel 2 cut
    as core_kernel_fn cuts it) at P, at double or float32: fn as
    core_kernel_fn's (trialmode only): phase 1 over every voxel, one
    block of one thread each (one-lane warps: ballot, popc and the
    atomicAdd of the shim), then phase 2 as one thread over the
    compacted lanes."""
    d = Path(tmpdir)
    _write_headers(d, double)
    real = "double" if double else "float"
    probe = (PROBES_CSRC / "core_compact.cu").read_text()
    probe = probe[probe.index('#include "spectral_core.cu"\n'):
                  probe.index("// ---- the block-local form")]
    probe = probe.split("\n", 1)[1]
    src = _core_source(p, double) + (
        _to_double(probe) if double else probe) + f"""
static void run_two_phase(const {real}* const* in, const CoreConsts& k,
                          const DetParams& det, int n_iters, long long V,
                          {real}* const* out) {{
  std::vector<{real}> fs((4 * {p} + 5) * V);
  std::vector<int> is(5 * V);
  int count = 0;
  for (long long v = 0; v < V; ++v) {{
    blockIdx.x = (unsigned)v;
    core_phase1_kernel<{p}, 3>(in[0], in[1], in[2], in[3], k, det, n_iters,
                               V, out[0], out[1], out[2], out[3], out[4],
                               out[5], out[6], fs.data(), is.data(), &count);
  }}
  blockIdx.x = 0;
  core_phase2_kernel<{p}, 3>(k, det, n_iters, V, fs.data(), is.data(),
                             &count, out[0], out[1], out[2], out[3], out[4],
                             out[5], out[6]);
}}
}}  // namespace
""" + _HOST_CORE_HEAD.format(real=real, p=p) + """  run_two_phase(in, k, dp, n_iters, V, out);
}
"""
    lib = _build(d, f"core2_p{p}_{real}", '#include "cuda_runtime.h"\n'
                 "#include <vector>\n" + src)
    return _core_lib_fn(lib, p, double)


def fused_kernel_fn(p, tmpdir, double=True):
    """Kernel 3 (spectral_fused.cu, cut before its launch section) at P,
    at double or float32, both forms and every detector instance in one
    library: fn(staged, data [T,V], tconsts [2P+1,T], aconsts [P*P], pm
    [P,V], consts [4P^2+2P+6], n_iters, det (kind, tol, max_its,
    max_trials, init_save), vb=32, offset=0) -> the seven outputs of
    core_kernel_fn. Streamed: one block of one thread per voxel. Staged:
    blocks of vb lanes, each lane a thread meeting the others at the
    staging barrier (stats_kernel_fn's staged form), the plane offset
    floats into its buffer."""
    if p > SPECTRAL_PREBUILT_P:
        return fused_wide_fn(p, tmpdir, double)
    d = Path(tmpdir)
    _write_headers(d, double)
    real = "double" if double else "float"
    src = _kernel_source("spectral_fused.cu",
                         "// ---- launch and C entry points", double) + f"""
struct HostArgs {{
  const {real}* data;
  const {real}* tc;
  const {real}* pm;
  int nt, n_iters;
  long long V;
  SolveConsts ac;
  CoreConsts k;
  DetParams det;
  {real}* const* out;
}};
template <int KIND, bool STAGED>
static void lane(const HostArgs& a) {{
  spectral_fused_kernel<{p}, KIND, STAGED>(
      a.data, a.tc, a.nt, a.V, a.ac, a.pm, a.k, a.det, a.n_iters, a.out[0],
      a.out[1], a.out[2], a.out[3], a.out[4], a.out[5], a.out[6]);
}}
template <int KIND>
static void run_streamed(const HostArgs& a) {{
  for (long long v = 0; v < a.V; ++v) {{
    blockIdx.x = (unsigned)v;
    lane<KIND, false>(a);
  }}
}}
template <int KIND>
static void run_staged(const HostArgs& a, int vb) {{
  FabberHostBarrier bar;
  bar.n = (unsigned)vb;
  fabber_host_barrier = &bar;
  blockDim.x = (unsigned)vb;
  for (long long b = 0; b * vb < a.V; ++b) {{
    blockIdx.x = (unsigned)b;
    std::vector<std::thread> lanes;
    for (int l = 0; l < vb; ++l)
      lanes.emplace_back([=, &a] {{
        threadIdx.x = (unsigned)l;
        lane<KIND, true>(a);
      }});
    for (auto& th : lanes) th.join();
  }}
  blockDim.x = 1;
  fabber_host_barrier = nullptr;
}}
template <int KIND>
static void run(const HostArgs& a, int vb) {{
  if (vb > 0) run_staged<KIND>(a, vb);
  else run_streamed<KIND>(a);
}}
}}  // namespace
extern "C" void host_fused(int vb, const {real}* data, const {real}* tc,
                           const {real}* aconsts, const {real}* pm,
                           const {real}* consts, int n_iters, const int* det,
                           {real} det_tol, int nt, long long V,
                           {real}* const* out) {{
  HostArgs a = {{data, tc, pm, nt, n_iters, V, {{}}, {{}},
                {{det[0], det_tol, det[1], det[2], det[3]}}, out}};
  for (int i = 0; i < {p} * {p}; ++i) a.ac.a[i] = aconsts[i];
  for (int i = 0; i < 4 * {p} * {p} + 2 * {p} + 6; ++i) a.k.v[i] = consts[i];
  switch (det[0]) {{
    case 0: run<0>(a, vb); break;
    case 1: run<1>(a, vb); break;
    case 2: run<2>(a, vb); break;
    default: run<3>(a, vb);
  }}
}}
"""
    lib = _build(d, f"fused_p{p}_{real}", '#include "cuda_runtime.h"\n'
                 "#include <thread>\n#include <vector>\n" + src)
    vp = ctypes.c_void_p
    cr = ctypes.c_double if double else ctypes.c_float
    lib.host_fused.restype = None
    lib.host_fused.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, ctypes.c_int,
                               vp, cr, ctypes.c_int, ctypes.c_longlong, vp]
    dt = np.float64 if double else np.float32

    def fn(staged, data, tconsts, aconsts, pm, consts, n_iters, det, vb=32,
           offset=0):
        nt, nv = data.shape
        buf = np.zeros(data.size + offset, dt)
        buf[offset:] = np.asarray(data, dt).ravel()
        ins = [buf[offset:]] + [np.ascontiguousarray(x, dt) for x in
                                (tconsts, aconsts, pm, consts)]
        outs = [np.zeros(s, dt) for s in ((p, nv), (p, p, nv), (p, p, nv),
                                          (1, nv), (1, nv), (1, nv), (1, nv))]
        out_ptrs = (ctypes.c_void_p * 7)(*[o.ctypes.data for o in outs])
        dk = (ctypes.c_int * 4)(det[0], det[2], det[3], det[4])
        lib.host_fused(vb if staged else 0, *(_ptr(x) for x in ins), n_iters,
                       dk, det[1], nt, nv, out_ptrs)
        return outs
    return fn


# -- the per-shape instances' kernels (P past the prebuilt lists) ----------
#
# The wide kernels (csrc/spectral_*.cu spectral_*_wide_kernel,
# fused_whole.cu fused_whole_wide_kernel, fused_loop.cu
# fused_loop_wide_kernel, fused_ar_loop.cu fused_ar_loop_wide_kernel)
# read their constants through pointers (the device buffers on the card):
# here host arrays. Each fn takes the arguments of its prebuilt
# counterpart's fn above.

def stats_wide_fn(p, tmpdir, double=True):
    """Kernel 1's per-shape instance at P (stats_kernel_fn's fn): both
    forms, the block's factor of A by the block (factor_block)."""
    d = Path(tmpdir)
    _write_headers(d, double)
    real = "double" if double else "float"
    src = _kernel_source("spectral_stats.cu",
                         "// ---- launch and C entry points", double) + f"""
}}  // namespace
extern "C" void host_stats(int vb, const {real}* data, const {real}* tc,
                           const {real}* a, int nt, long long V, {real}* m0,
                           {real}* rtqr, {real}* dtqr) {{
  if (vb == 0) {{
    for (long long v = 0; v < V; ++v) {{
      blockIdx.x = (unsigned)v;
      spectral_stats_wide_kernel<{p}, false>(data, tc, nt, V, a, m0, rtqr,
                                             dtqr);
    }}
    return;
  }}
  FabberHostBarrier bar;
  bar.n = (unsigned)vb;
  fabber_host_barrier = &bar;
  blockDim.x = (unsigned)vb;
  for (long long b = 0; b * vb < V; ++b) {{
    blockIdx.x = (unsigned)b;
    std::vector<std::thread> lanes;
    for (int l = 0; l < vb; ++l)
      lanes.emplace_back([=] {{
        threadIdx.x = (unsigned)l;
        spectral_stats_wide_kernel<{p}, true>(data, tc, nt, V, a, m0, rtqr,
                                              dtqr);
      }});
    for (auto& th : lanes) th.join();
  }}
  blockDim.x = 1;
  fabber_host_barrier = nullptr;
}}
"""
    lib = _build(d, f"stats_wide_p{p}_{real}", '#include "cuda_runtime.h"\n'
                 "#include <thread>\n#include <vector>\n" + src)
    vp = ctypes.c_void_p
    lib.host_stats.restype = None
    lib.host_stats.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int,
                               ctypes.c_longlong, vp, vp, vp]
    dt = np.float64 if double else np.float32

    def fn(staged, data, tconsts, aconsts, vb=32, offset=0):
        nt, nv = data.shape
        buf = np.zeros(data.size + offset, dt)
        buf[offset:] = np.asarray(data, dt).ravel()
        ins = [buf[offset:]] + [np.ascontiguousarray(x, dt)
                                for x in (tconsts, aconsts)]
        outs = [np.zeros(s, dt) for s in ((p, nv), (1, nv), (p, nv))]
        lib.host_stats(vb if staged else 0, *(_ptr(x) for x in ins), nt, nv,
                       *(_ptr(o) for o in outs))
        return outs
    return fn


def core_wide_fn(p, tmpdir, double=True):
    """Kernel 2's per-shape instance at P (core_kernel_fn's fn), every
    detector instance, its constants copied into the block's shared
    memory."""
    d = Path(tmpdir)
    _write_headers(d, double)
    real = "double" if double else "float"
    src = _kernel_source("spectral_core.cu",
                         "// ---- launch and C entry point", double) + f"""
template <int KIND>
static void run_all(const {real}* const* in, const {real}* k,
                    const DetParams& det, int n_iters, long long V,
                    {real}* const* out) {{
  for (long long v = 0; v < V; ++v) {{
    blockIdx.x = (unsigned)v;
    spectral_core_wide_kernel<{p}, KIND>(in[0], in[1], in[2], in[3], k, det,
                                         n_iters, V, out[0], out[1], out[2],
                                         out[3], out[4], out[5], out[6]);
  }}
}}
}}  // namespace
extern "C" void host_core(const {real}* const* in, const {real}* k,
                          const int* det, {real} det_tol, int n_iters,
                          long long V, {real}* const* out) {{
  const DetParams dp = {{det[0], det_tol, det[1], det[2], det[3]}};
  switch (det[0]) {{
    case 0: run_all<0>(in, k, dp, n_iters, V, out); break;
    case 1: run_all<1>(in, k, dp, n_iters, V, out); break;
    case 2: run_all<2>(in, k, dp, n_iters, V, out); break;
    default: run_all<3>(in, k, dp, n_iters, V, out);
  }}
}}
"""
    lib = _build(d, f"core_wide_p{p}_{real}",
                 '#include "cuda_runtime.h"\n' + src)
    return _core_lib_fn(lib, p, double)


def fused_wide_fn(p, tmpdir, double=True):
    """Kernel 3's per-shape instance at P (fused_kernel_fn's fn, without
    the offset): both forms and every detector instance."""
    d = Path(tmpdir)
    _write_headers(d, double)
    real = "double" if double else "float"
    src = _kernel_source("spectral_fused.cu",
                         "// ---- launch and C entry points", double) + f"""
struct HostArgs {{
  const {real}* data;
  const {real}* tc;
  const {real}* a;
  const {real}* pm;
  const {real}* k;
  int nt, n_iters;
  long long V;
  DetParams det;
  {real}* const* out;
}};
template <int KIND, bool STAGED>
static void lane(const HostArgs& a) {{
  spectral_fused_wide_kernel<{p}, KIND, STAGED>(
      a.data, a.tc, a.nt, a.V, a.a, a.pm, a.k, a.det, a.n_iters, a.out[0],
      a.out[1], a.out[2], a.out[3], a.out[4], a.out[5], a.out[6]);
}}
template <int KIND>
static void run(const HostArgs& a, int vb) {{
  if (vb == 0) {{
    for (long long v = 0; v < a.V; ++v) {{
      blockIdx.x = (unsigned)v;
      lane<KIND, false>(a);
    }}
    return;
  }}
  FabberHostBarrier bar;
  bar.n = (unsigned)vb;
  fabber_host_barrier = &bar;
  blockDim.x = (unsigned)vb;
  for (long long b = 0; b * vb < a.V; ++b) {{
    blockIdx.x = (unsigned)b;
    std::vector<std::thread> lanes;
    for (int l = 0; l < vb; ++l)
      lanes.emplace_back([=, &a] {{
        threadIdx.x = (unsigned)l;
        lane<KIND, true>(a);
      }});
    for (auto& th : lanes) th.join();
  }}
  blockDim.x = 1;
  fabber_host_barrier = nullptr;
}}
}}  // namespace
extern "C" void host_fused(int vb, const {real}* data, const {real}* tc,
                           const {real}* aconsts, const {real}* pm,
                           const {real}* consts, int n_iters, const int* det,
                           {real} det_tol, int nt, long long V,
                           {real}* const* out) {{
  const HostArgs a = {{data, tc, aconsts, pm, consts, nt, n_iters, V,
                      {{det[0], det_tol, det[1], det[2], det[3]}}, out}};
  switch (det[0]) {{
    case 0: run<0>(a, vb); break;
    case 1: run<1>(a, vb); break;
    case 2: run<2>(a, vb); break;
    default: run<3>(a, vb);
  }}
}}
"""
    lib = _build(d, f"fused_wide_p{p}_{real}", '#include "cuda_runtime.h"\n'
                 "#include <thread>\n#include <vector>\n" + src)
    vp = ctypes.c_void_p
    cr = ctypes.c_double if double else ctypes.c_float
    lib.host_fused.restype = None
    lib.host_fused.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, ctypes.c_int,
                               vp, cr, ctypes.c_int, ctypes.c_longlong, vp]
    dt = np.float64 if double else np.float32

    def fn(staged, data, tconsts, aconsts, pm, consts, n_iters, det, vb=32,
           offset=0):
        nt, nv = data.shape
        buf = np.zeros(data.size + offset, dt)
        buf[offset:] = np.asarray(data, dt).ravel()
        ins = [buf[offset:]] + [np.ascontiguousarray(x, dt) for x in
                                (tconsts, aconsts, pm, consts)]
        outs = [np.zeros(s, dt) for s in ((p, nv), (p, p, nv), (p, p, nv),
                                          (1, nv), (1, nv), (1, nv), (1, nv))]
        out_ptrs = (ctypes.c_void_p * 7)(*[o.ctypes.data for o in outs])
        dk = (ctypes.c_int * 4)(det[0], det[2], det[3], det[4])
        lib.host_fused(vb if staged else 0, *(_ptr(x) for x in ins), n_iters,
                       dk, det[1], nt, nv, out_ptrs)
        return outs
    return fn


def whole_wide_fn(p, q, tmpdir):
    """Kernel 4's per-shape instance at (P, Q) (whole_kernel_fn's fn), at
    double, both forms: WideConsts with D'Q_qD read through a pointer."""
    d = Path(tmpdir)
    _write_headers(d)
    src = _kernel_source("fused_whole.cu", "// ---- launch and C entry points",
                         True) + f"""
template <int MODE, bool STAGED>
static void run_all(const WideConsts& k, const double* const* in,
                    double* const* out) {{
  for (long long v = 0; v < k.V; ++v) {{
    blockIdx.x = (unsigned)v;
    fused_whole_wide_kernel<{p}, {q}, MODE, STAGED>(
        k, in[0], in[1], in[2], in[3], out[0], out[1], out[2], out[3],
        out[4], out[5], out[6]);
  }}
}}
template <bool STAGED>
static void run_mode(const WideConsts& k, const double* const* in,
                     double* const* out) {{
  if (k.d.kind == kMaxits) run_all<0, STAGED>(k, in, out);
  else if (k.d.kind == kPointZeroOne) run_all<1, STAGED>(k, in, out);
  else run_all<2, STAGED>(k, in, out);
}}
}}  // namespace
extern "C" void host_whole(int staged, int n_iters, double locked_sd,
                           const double* consts, const int* det,
                           double det_tol, const double* det_consts,
                           const double* const* in, double* const* out,
                           int nt, long long V) {{
  const int q = {q};
  WideConsts k = make_wide_consts(q, n_iters, locked_sd, consts, consts,
                                  q * {p} * {p}, nt, V);
  for (int i = 0; i < q; ++i) k.lb_coeff[i] = det_consts[i];
  k.f_const = det_consts[q];
  k.d = {{det[0], det_tol, det[1], det[2], det[3]}};
  if (staged) run_mode<true>(k, in, out);
  else run_mode<false>(k, in, out);
}}
"""
    lib = _build(d, f"whole_wide_p{p}_q{q}",
                 '#include "cuda_runtime.h"\n' + src)
    return _whole_lib_fn(lib, p, q)


def _whole_lib_fn(lib, p, q):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_whole.restype = None
    lib.host_whole.argtypes = [i32, i32, ctypes.c_double, vp, vp,
                               ctypes.c_double, vp, vp, vp, i32,
                               ctypes.c_longlong]

    def fn(staged, n_iters, locked_sd, consts, det, det_consts, data,
           tconsts, pm, pp):
        nt, nv = data.shape
        fq = q if det[0] == 0 else 1
        outs = [np.zeros(s) for s in ((p, nv), (p, p, nv), (p, p, nv),
                                      (q, nv), (q, nv), (fq, nv), (fq, nv))]
        ins = [np.ascontiguousarray(x, np.float64)
               for x in (data, tconsts, pm, pp)]
        in_ptrs = (ctypes.c_void_p * 4)(*[x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 7)(*[o.ctypes.data for o in outs])
        cs = np.ascontiguousarray(consts, np.float64)
        dcs = np.ascontiguousarray(det_consts, np.float64)
        dk = (ctypes.c_int * 4)(det[0], det[2], det[3], det[4])
        lib.host_whole(int(staged), n_iters, locked_sd, _ptr(cs), dk,
                       det[1], _ptr(dcs), in_ptrs, out_ptrs, nt, nv)
        return outs
    return fn


def loop_wide_fn(p, q, tmpdir):
    """Kernel 5's per-shape instance at (P, Q) (loop_kernel_fn's fn), at
    double."""
    d = Path(tmpdir)
    _write_headers(d)
    src = _kernel_source("fused_loop.cu", "// ---- launch and C entry points",
                         True) + f"""
}}  // namespace
extern "C" void host_loop(int n_iters, double locked_sd,
                          const double* consts, const double* const* in,
                          double* const* out, long long V) {{
  const WideConsts k = make_wide_consts({q}, n_iters, locked_sd, consts,
                                        consts, {q} * {p} * {p}, 1, V);
  for (long long v = 0; v < V; ++v) {{
    blockIdx.x = (unsigned)v;
    fused_loop_wide_kernel<{p}, {q}>(k, in[0], in[1], in[2], in[3], in[4],
                                     out[0], out[1], out[2], out[3], out[4]);
  }}
}}
"""
    lib = _build(d, f"loop_wide_p{p}_q{q}",
                 '#include "cuda_runtime.h"\n' + src)
    vp = ctypes.c_void_p
    lib.host_loop.restype = None
    lib.host_loop.argtypes = [ctypes.c_int, ctypes.c_double, vp, vp, vp,
                              ctypes.c_longlong]

    def fn(n_iters, locked_sd, consts, m0, rtqr, dtqr, pm, pp):
        nv = m0.shape[-1]
        ins = [np.ascontiguousarray(x, np.float64)
               for x in (m0, rtqr, dtqr, pm, pp)]
        outs = [np.zeros(s) for s in ((p, nv), (p, p, nv), (p, p, nv),
                                      (q, nv), (q, nv))]
        in_ptrs = (ctypes.c_void_p * 5)(*[x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 5)(*[o.ctypes.data for o in outs])
        cs = np.ascontiguousarray(consts, np.float64)
        lib.host_loop(n_iters, locked_sd, _ptr(cs), in_ptrs, out_ptrs, nv)
        return outs
    return fn


def ar_wide_fn(p, nq, tmpdir, double=True):
    """Kernel 9's per-shape instance at (P, nq) (ar_kernel_fn's fn):
    WideArConsts with D'M_sD read through a pointer."""
    d = Path(tmpdir)
    _write_headers(d, double)
    real = "double" if double else "float"
    src = _kernel_source("fused_ar_loop.cu",
                         "// ---- launch and C entry points", double) + f"""
template <int MODE>
static void run_all(const WideArConsts& k, const {real}* const* in,
                    {real}* const* out) {{
  for (long long v = 0; v < k.V; ++v) {{
    blockIdx.x = (unsigned)v;
    fused_ar_loop_wide_kernel<{p}, {nq}, MODE>(
        k, in[0], in[1], in[2], in[3], in[4], out[0], out[1], out[2],
        out[3], out[4], out[5], out[6], out[7], out[8], out[9]);
  }}
}}
}}  // namespace
extern "C" void host_ar(int n_iters, const {real}* consts, const int* det,
                        {real} det_tol, {real} f_const, {real} lb_coeff,
                        const {real}* const* in, {real}* const* out,
                        long long V) {{
  WideArConsts k = {{}};
  k.dmd = DevRows{{consts}};
  fill_ar_consts(k, kSpecs * {nq} * {p} * {p}, {nq}, n_iters, consts,
                 det[0], det_tol, det[1], det[2], det[3], f_const, lb_coeff,
                 V);
  if (det[0] == 0) run_all<0>(k, in, out);
  else run_all<1>(k, in, out);
}}
"""
    lib = _build(d, f"ar_wide_p{p}_q{nq}_{real}",
                 '#include "cuda_runtime.h"\n' + src)
    vp = ctypes.c_void_p
    cr = ctypes.c_double if double else ctypes.c_float
    lib.host_ar.restype = None
    lib.host_ar.argtypes = [ctypes.c_int, vp, vp, cr, cr, cr, vp, vp,
                            ctypes.c_longlong]
    dt = np.float64 if double else np.float32

    def fn(n_iters, consts, det, elbo, m0, rmr, dmr, pm, pp):
        nv = m0.shape[-1]
        ins = [np.ascontiguousarray(x, dt) for x in (m0, rmr, dmr, pm, pp)]
        shapes = [(p, nv), (p, p, nv), (p, p, nv)] + [(nq, nv)] * 5
        if det[0] != 0:
            shapes += [(1, nv), (1, nv)]
        outs = [np.zeros(s, dt) for s in shapes]
        in_ptrs = (ctypes.c_void_p * 5)(*[x.ctypes.data for x in ins])
        out_ptrs = (ctypes.c_void_p * 10)(*([o.ctypes.data for o in outs]
                                            + [None] * (10 - len(outs))))
        cs = np.ascontiguousarray(consts, dt)
        dk = (ctypes.c_int * 4)(det[0], det[2], det[3], det[4])
        lib.host_ar(n_iters, _ptr(cs), dk, det[1], elbo[0], elbo[1],
                    in_ptrs, out_ptrs, nv)
        return outs
    return fn
