// spectral_core: the eigenbasis fixed point of fixed-design white-noise
// VB and the posterior reconstruction, for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_spectral.py
// make_spectral_core_kernel (its pallas_call at line 840; body
// _spectral_core at line 162, output writes _write_outputs at line 350),
// in both its modes: maxits (KIND = kMaxits) and the in-kernel F-based
// detectors pointzeroone / freduce / trialmode (KIND their code, one
// instance per detector: detectors.cuh det_test_kind). Plain
// version: fabber_core_tpu_torch/ops/fused_spectral.py
// spectral_core_plain.
//
// One thread per voxel, all state in registers. The 4P^2+2P+6 scalar
// constants (A, E'W, E'W^-1, WE, lam, pp, 1/b0, c_post, b_init, c_init,
// f_const, lb_coeff; layout of pack_spectral_consts) ride as a by-value
// kernel parameter, i.e. in constant memory, read as uniform operands.
// Per voxel:
//   rotate   ut = E'W (dtqr + A m0), u0t = E'W dtqr, vt = E'W (pp*pm),
//            m0t = E'W^-1 m0
//   loop     maxits: s0 = b_init*c_init, then n_iters-1 noise updates
//            s <- c_post / ((kqk + tr)/2 + 1/b0), kqk clamped at 0.
//            detector: per iteration, best-save (the generating phi and
//            the engine-initial flag) where the detector's save flag is
//            set, the update generated by the current phi, the noise,
//            the eigenbasis ELBO F, the detector's test
//            (detectors.cuh); the thread leaves its loop when its lane
//            is done or at n_iters (the engine's max_iterations + 2).
//            After the loop the engine's finalize: best-save, then the
//            revert selection of the generating phi.
//   rebuild  from the final (selected) s: means = WE mt, prec = s A +
//            diag(pp), cov_ij = sum_k WE_ik WE_jk / (s lam_k + 1), the
//            noise b and c = c_post, F (the eigenbasis ELBO) and tr
//            (maxits) or the lane's iteration count (detector).
// Detector mode tags b with a minus sign on lanes whose selected state
// is the engine-initial posterior (off the spectral manifold: a freduce
// revert at the first test, a trialmode revert to the initial best); the
// engine restores those lanes from its initial planes. The off-by-one of
// maxits (n_iters-1 updates, then the rebuild from the s that generated
// the last posterior) is the TPU kernel's and the XLA spectral route's;
// the engine reports its = n_iters.
//
// What bounds it on this card: the output write, (2P^2+P+4)*4 bytes per
// voxel (100 B at P=3) plus the (3P+1)*4-byte statistics read; the
// fixed point is ~25 flops per voxel-iteration, far below the card's
// rate. Every output plane is written coalesced (voxels on the last
// axis, one thread per voxel). In detector mode the loop is no longer
// negligible: each trip adds P+1 logf and P divides, and a warp runs
// until its slowest lane is done (under trialmode at its defaults ~17
// trips for a lane that reverts), which took the kernel from 0.94 to
// 2.49 ms at 16,777,216 voxels, P=3, on an H100. Each detector has its
// own instance (template KIND), so a lane carries only its detector's
// state and a trip runs only its test, with no switch on a runtime kind.
// Compacting the lanes still running after a few trips did not beat one
// launch (grid-wide in two launches, 4.06-4.16 against 2.36-2.51 ms;
// within each block, no gain: probes/csrc/core_compact.cu, probes/
// core_stragglers.py), so there is one launch. There is no block-level
// state, so no barrier. The per-voxel body is
// csrc/spectral_device.cuh core_voxel, which kernel 3 (spectral_fused.cu)
// runs too.
//
// Past P = 8 (a per-shape instance: ops/_cuda.py build_instance compiles
// this file with FABBER_INST_P defined, P 9 to 25) the constants come
// from a device buffer, copied into the block's shared memory once
// (spectral_core_wide_kernel; 10.3 KB at P = 25), and the rebuild runs
// its P x P planes in loops over rows and columns. From P ~ 12 the
// posterior's 2P^2 planes are most of what the kernel moves, so its
// writes bound it: (P + 2P^2 + 4) floats a voxel, 3.3 KB at P = 20.

#include <cuda_runtime.h>

#include "spectral_device.cuh"

namespace {

using fabber_spectral::CoreConsts;
using fabber_spectral::kMaxP;
using fabber_spectral::SharedCore;
constexpr int kThreads = 256;

using fabber::DetParams;

template <int P, int KIND>
__global__ void __launch_bounds__(kThreads)
spectral_core_kernel(const float* __restrict__ m0_in,
                     const float* __restrict__ rtqr_in,
                     const float* __restrict__ dtqr_in,
                     const float* __restrict__ pm_in, const CoreConsts k,
                     const DetParams det, int n_iters, long long V,
                     float* __restrict__ means_out,
                     float* __restrict__ prec_out, float* __restrict__ cov_out,
                     float* __restrict__ b_out, float* __restrict__ c_out,
                     float* __restrict__ f_out, float* __restrict__ tr_out) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float m0[P], dtqr[P], pm[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    m0[a] = m0_in[(size_t)a * V + v];
    dtqr[a] = dtqr_in[(size_t)a * V + v];
    pm[a] = pm_in[(size_t)a * V + v];
  }
  const float rtqr = rtqr_in[v];
  fabber_spectral::core_voxel<P, KIND>(m0, rtqr, dtqr, pm, k, det, n_iters,
                                       V, v, means_out, prec_out, cov_out,
                                       b_out, c_out, f_out, tr_out);
}

// A per-shape instance (P > kMaxP): the core constants [4P^2+2P+6]
// (device) copied into the block's shared memory first; every thread
// takes part in the copy and the barrier.
template <int P, int KIND>
__global__ void __launch_bounds__(kThreads)
spectral_core_wide_kernel(const float* __restrict__ m0_in,
                          const float* __restrict__ rtqr_in,
                          const float* __restrict__ dtqr_in,
                          const float* __restrict__ pm_in,
                          const float* __restrict__ consts,
                          const DetParams det, int n_iters, long long V,
                          float* __restrict__ means_out,
                          float* __restrict__ prec_out,
                          float* __restrict__ cov_out,
                          float* __restrict__ b_out, float* __restrict__ c_out,
                          float* __restrict__ f_out,
                          float* __restrict__ tr_out) {
  float* kc = fabber::dynamic_smem();
  fabber_spectral::copy_block(consts, kc, fabber_spectral::core_floats(P));
  __syncthreads();
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float m0[P], dtqr[P], pm[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    m0[a] = m0_in[(size_t)a * V + v];
    dtqr[a] = dtqr_in[(size_t)a * V + v];
    pm[a] = pm_in[(size_t)a * V + v];
  }
  const float rtqr = rtqr_in[v];
  fabber_spectral::core_voxel<P, KIND>(m0, rtqr, dtqr, pm, SharedCore{kc},
                                       det, n_iters, V, v, means_out,
                                       prec_out, cov_out, b_out, c_out, f_out,
                                       tr_out);
}

// ---- launch and C entry point -------------------------------------------

// One launch's arguments.
struct CoreArgs {
  const float* m0;
  const float* rtqr;
  const float* dtqr;
  const float* pm;
  CoreConsts k;
  const float* consts;   // a per-shape instance's, on the device
  DetParams det;
  int n_iters;
  long long V;
  float* outs[7];
};

template <int P, int KIND>
int launch_kind(const CoreArgs& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.V + kThreads - 1) / kThreads);
  if constexpr (P > kMaxP) {
    const auto kernel = spectral_core_wide_kernel<P, KIND>;
    const int smem = 4 * fabber_spectral::core_floats(P);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, kThreads, smem, stream>>>(
        a.m0, a.rtqr, a.dtqr, a.pm, a.consts, a.det, a.n_iters, a.V,
        a.outs[0], a.outs[1], a.outs[2], a.outs[3], a.outs[4], a.outs[5],
        a.outs[6]);
  } else {
    spectral_core_kernel<P, KIND><<<grid, kThreads, 0, stream>>>(
        a.m0, a.rtqr, a.dtqr, a.pm, a.k, a.det, a.n_iters, a.V, a.outs[0],
        a.outs[1], a.outs[2], a.outs[3], a.outs[4], a.outs[5], a.outs[6]);
  }
  return (int)cudaGetLastError();
}

template <int P>
int launch(const CoreArgs& a, cudaStream_t stream) {
  switch (a.det.kind) {
    case fabber::kMaxits:
      return launch_kind<P, fabber::kMaxits>(a, stream);
    case fabber::kPointZeroOne:
      return launch_kind<P, fabber::kPointZeroOne>(a, stream);
    case fabber::kFreduce:
      return launch_kind<P, fabber::kFreduce>(a, stream);
    default:
      return launch_kind<P, fabber::kTrialMode>(a, stream);
  }
}

}  // namespace

#if !defined(FABBER_INST_P)
// m0, dtqr, pm [P,V], rtqr [1,V] (device); consts_host [4P^2+2P+6]
// (host, by value). det_kind 0 is maxits; 1, 2, 3 are pointzeroone,
// freduce, trialmode (detectors.cuh), with their tolerance, max_its,
// max_trials and initial save flag. Outputs (device, preallocated):
// means [P,V], prec [P,P,V], cov [P,P,V], b, c, F [1,V], and tr
// (maxits) or the lane's iteration count (detector) [1,V].
extern "C" int fabber_spectral_core(int p, int n_iters, const float* m0,
                                    const float* rtqr, const float* dtqr,
                                    const float* pm, const float* consts_host,
                                    int det_kind, float det_tol,
                                    int det_max_its, int det_max_trials,
                                    int det_init_save, long long V,
                                    float* means, float* prec, float* cov,
                                    float* b, float* c, float* f, float* tr,
                                    void* stream) {
  if (p < 1 || p > kMaxP || n_iters < 1 || V < 1 || det_kind < 0 ||
      det_kind > fabber::kTrialMode)
    return (int)cudaErrorInvalidValue;
  CoreArgs a = {m0, rtqr, dtqr, pm, {}, nullptr,
                {det_kind, det_tol, det_max_its, det_max_trials,
                 det_init_save},
                n_iters, V, {means, prec, cov, b, c, f, tr}};
  for (int i = 0; i < 4 * p * p + 2 * p + 6; ++i) a.k.v[i] = consts_host[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    default: return launch<8>(a, s);
  }
}
#else
// A per-shape instance's entry point (ops/_cuda.py build_instance, P =
// FABBER_INST_P, 9 to 25): fabber_spectral_core's arguments, with the
// constants [4P^2+2P+6] on the device. Another p returns
// cudaErrorInvalidValue.
extern "C" int fabber_inst_spectral_core(int p, int n_iters, const float* m0,
                                         const float* rtqr, const float* dtqr,
                                         const float* pm, const float* consts,
                                         int det_kind, float det_tol,
                                         int det_max_its, int det_max_trials,
                                         int det_init_save, long long V,
                                         float* means, float* prec,
                                         float* cov, float* b, float* c,
                                         float* f, float* tr, void* stream) {
  if (p != FABBER_INST_P || n_iters < 1 || V < 1 || det_kind < 0 ||
      det_kind > fabber::kTrialMode)
    return (int)cudaErrorInvalidValue;
  const CoreArgs a = {m0, rtqr, dtqr, pm, {}, consts,
                      {det_kind, det_tol, det_max_its, det_max_trials,
                       det_init_save},
                      n_iters, V, {means, prec, cov, b, c, f, tr}};
  return launch<FABBER_INST_P>(a, static_cast<cudaStream_t>(stream));
}
#endif
