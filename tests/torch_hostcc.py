"""The port's CUDA device code compiled as host C++ with g++, for the CPU
tests: a shim header stands in for cuda_runtime.h (the CUDA qualifiers
as nothing, __ldg as a load, one "thread" per call), and at double the
kernel headers are text-substituted float -> double (vb_device.cuh,
detectors.cuh and fused_nl_loop.cuh cut before its launch section;
dual.cuh has both overloads and is used as it is). Tests skip when g++
is missing."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "fabber_core_tpu_torch" / "csrc"

SHIM = """#pragma once
#include <math.h>
#include <algorithm>
using std::max;
using std::min;
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
template <class T> inline T __ldg(const T* p) { return *p; }
struct FabberDim3 { unsigned x, y, z; };
static FabberDim3 blockIdx = {0, 0, 0}, blockDim = {1, 1, 1},
                  threadIdx = {0, 0, 0};
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
"""


def have_gxx():
    return shutil.which("g++") is not None


def _to_double(text):
    text = re.sub(r"\bfloat\b(?!\.h)", "double", text)
    for f in ("expf", "logf", "log1pf", "sqrtf", "fabsf", "fminf",
              "fmaxf"):
        text = re.sub(rf"\b{f}\(", f"{f[:-1]}(", text)
    return text


def _write_headers(d):
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "dual.cuh").write_text((CSRC / "dual.cuh").read_text())
    for name in ("vb_device.cuh", "detectors.cuh"):
        (d / name).write_text(_to_double((CSRC / name).read_text()))
    nl = (CSRC / "fused_nl_loop.cuh").read_text()
    nl = nl[:nl.index("// ---- launch ----")] + "}  // namespace\n"
    (d / "fused_nl_loop.cuh").write_text(_to_double(nl))


def _build(d, name, src):
    (d / f"{name}.cpp").write_text(src)
    out = d / f"{name}.so"
    proc = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w", "-I", str(d),
         "-o", str(out), str(d / f"{name}.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(out))


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


def kernel_fn(tle, q, tmpdir):
    """The whole-loop kernel (fused_nl_loop.cuh) with a TimeLocalEval's
    generated functor, at double, one call per voxel: fn(tcodes,
    n_iters, need_f, consts [4Q], det (kind, tol, max_its, max_trials,
    init_save), det_consts [Q+2], centre0, pm, pp, pd0 [P,V], data
    [T,V], supp [S,V] or None, qw [T,Q]) -> the seven outputs."""
    d = Path(tmpdir)
    _write_headers(d)
    p = tle.nparams
    src = _to_double(
        '#include "cuda_runtime.h"\n#include "dual.cuh"\n'
        '#include "fused_nl_loop.cuh"\n'
        "namespace {\nusing namespace fabber::gen;\n" + tle.source
        + "}  // namespace\n") + f"""
template <int MODE>
static void run_all(const VBParams& k, const NLDetConsts& dc,
                    const double* const* in, double* const* out) {{
  for (long long v = 0; v < k.V; ++v) {{
    threadIdx.x = (unsigned)v;
    fused_nl_loop_kernel<GenModel, {q}, MODE>(
        k, dc, in[0], in[1], in[2], in[3], in[4], in[5], in[6], out[0],
        out[1], out[2], out[3], out[4], out[5], out[6]);
  }}
}}
extern "C" int host_nl_loop(const int* tcodes, int n_iters, int need_f,
                            const double* consts, int det_kind,
                            double det_tol, int det_max_its,
                            int det_max_trials, int det_init_save,
                            const double* det_consts,
                            const double* const* in, double* const* out,
                            int nt, long long V) {{
  VBParams k;
  NLDetConsts dc;
  if (!nl_setup({p}, {q}, tcodes, 0.0, n_iters, need_f, -1.0, consts,
                det_kind, det_tol, det_max_its, det_max_trials,
                det_init_save, det_consts, in[3], nt, V, &k, &dc))
    return 1;
  if (det_kind == 0) run_all<0>(k, dc, in, out);
  else if (det_kind <= 2) run_all<1>(k, dc, in, out);
  else run_all<2>(k, dc, in, out);
  return 0;
}}
"""
    lib = _build(d, "kernel", src)
    lib.host_nl_loop.restype = ctypes.c_int
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_nl_loop.argtypes = [vp, i32, i32, vp, i32, ctypes.c_double,
                                 i32, i32, i32, vp, vp, vp, i32,
                                 ctypes.c_longlong]

    def fn(tcodes, n_iters, need_f, consts, det, det_consts, centre0, pm,
           pp, pd0, data, supp, qw):
        nt, nv = data.shape
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
        rc = lib.host_nl_loop(tc, n_iters, int(need_f), _ptr(cs), det[0],
                              det[1], det[2], det[3], det[4], _ptr(dcs),
                              in_ptrs, out_ptrs, nt, nv)
        assert rc == 0
        return outs
    return fn
