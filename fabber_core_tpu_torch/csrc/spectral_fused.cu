// spectral_fused: the one-kernel form of the spectral route (statistics
// and eigenbasis fixed point in one thread), for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_spectral.py
// make_fused_spectral_loop (its pallas_call at line 529), in maxits
// (KIND = kMaxits) and in the pointzeroone / freduce / trialmode detector
// mode (KIND their code, one instance per detector). Plain version:
// fabber_core_tpu_torch/ops/fused_spectral.py spectral_fused_plain (the
// plain statistics, then the plain core).
//
// One thread per voxel. Each thread runs csrc/spectral_device.cuh
// stats_voxel on its data column and hands its m0, rtqr and dtqr in
// registers to core_voxel, which writes the posterior. The statistics
// never reach device memory, so the kernel's outputs are those of the
// split pair (spectral_stats.cu followed by spectral_core.cu) bit for
// bit, in either form: the same device code on the same values.
//
// What bounds it on this card: the [T,V] data read, 4*T bytes per voxel,
// plus the (2P^2+P+4)*4-byte posterior write and the prior means read;
// the split pair adds a (2P+1)-plane write and a (3P+1)-plane read of
// the statistics in between (72 B per voxel at P=3). Both statistics
// passes read the column, and a block's columns outlive the 50 MB L2,
// so reading them in the plane (the streamed form, blocks of 256 with
// the (2P+1) x T design rows alone in shared memory) sends pass 2 back
// to HBM: it ran 8-20% slower than the split pair on an H100. The staged
// form (template STAGED) takes kernel 1's staged tile (spectral_device.cuh
// stage_stats: the block's [T, VB] tile and the rows copied into shared
// memory once, in 16-byte cp.async chunks of rotated rows), so HBM sees
// the plane once; the core then runs in registers while the block keeps
// its tile. Staged at VB 128 it ran 5% under the split pair (3.89
// against 4.11 ms at 16,777,216 voxels, T=106, P=3, on an H100), and
// beat streamed and the narrower blocks under trialmode too, so
// ops/fused_spectral.py fused_vb takes kernel 1's plan (ops/_cuda.py
// tile_plan, STATS_WIDTHS) in every mode.
//
// Past P = 8 (a per-shape instance: ops/_cuda.py build_instance compiles
// this file with FABBER_INST_P defined, P 9 to 25) the kernel is
// spectral_fused_wide_kernel: kernel 1's wide statistics (the block's
// factor of A in shared memory) and kernel 2's wide core (its constants
// copied from a device buffer into shared memory after the factor), in
// one thread as here.

#include <cuda_runtime.h>

#include "spectral_device.cuh"

namespace {

using fabber::DetParams;
using fabber_spectral::CoreConsts;
using fabber_spectral::kMaxP;
using fabber_spectral::PlaneColumn;
using fabber_spectral::SharedCore;
using fabber_spectral::SharedFactor;
using fabber_spectral::SolveConsts;
using fabber_spectral::StatsTile;
using fabber_spectral::stats_smem;
constexpr int kThreads = fabber_spectral::kStatsThreads;

template <int P, int KIND, bool STAGED>
__global__ void __launch_bounds__(kThreads)
spectral_fused_kernel(const float* __restrict__ data,
                      const float* __restrict__ tconsts, int T, long long V,
                      SolveConsts ac, const float* __restrict__ pm_in,
                      const CoreConsts k, const DetParams det, int n_iters,
                      float* __restrict__ means_out,
                      float* __restrict__ prec_out,
                      float* __restrict__ cov_out, float* __restrict__ b_out,
                      float* __restrict__ c_out, float* __restrict__ f_out,
                      float* __restrict__ tr_out) {
  // rows [(2P+1), T]: D rows, DW rows, q. Every thread of the block
  // takes part in the copies and the barrier, those past V included.
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float m0[P], rtqr, dtqr[P], pm[P];
  if constexpr (STAGED) {
    const StatsTile col =
        fabber_spectral::stage_stats<P>(data, tconsts, T, V);
    if (v >= V) return;
    fabber_spectral::stats_voxel<P>(col.tile + T * col.vb, T, col, ac, m0,
                                    rtqr, dtqr);
  } else {
    float* rows = fabber::dynamic_smem();
    for (int i = threadIdx.x; i < (2 * P + 1) * T; i += blockDim.x)
      rows[i] = tconsts[i];
    __syncthreads();
    if (v >= V) return;
    fabber_spectral::stats_voxel<P>(rows, T, PlaneColumn{data + v, V}, ac,
                                    m0, rtqr, dtqr);
  }
#pragma unroll
  for (int a = 0; a < P; ++a) pm[a] = pm_in[(size_t)a * V + v];
  fabber_spectral::core_voxel<P, KIND>(m0, rtqr, dtqr, pm, k, det, n_iters,
                                       V, v, means_out, prec_out, cov_out,
                                       b_out, c_out, f_out, tr_out);
}

// A per-shape instance (P > kMaxP): after the rows, the block's factor of
// a [P*P] (device; factor_block) and the core constants [4P^2+2P+6]
// (device) copied into shared memory; otherwise spectral_fused_kernel.
template <int P, int KIND, bool STAGED>
__global__ void __launch_bounds__(kThreads)
spectral_fused_wide_kernel(const float* __restrict__ data,
                           const float* __restrict__ tconsts, int T,
                           long long V, const float* __restrict__ a,
                           const float* __restrict__ pm_in,
                           const float* __restrict__ consts,
                           const DetParams det, int n_iters,
                           float* __restrict__ means_out,
                           float* __restrict__ prec_out,
                           float* __restrict__ cov_out,
                           float* __restrict__ b_out,
                           float* __restrict__ c_out,
                           float* __restrict__ f_out,
                           float* __restrict__ tr_out) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float m0[P], rtqr, dtqr[P], pm[P];
  float* l;
  if constexpr (STAGED) {
    const StatsTile col =
        fabber_spectral::stage_stats<P>(data, tconsts, T, V);
    const float* rows = col.tile + T * col.vb;
    l = const_cast<float*>(rows) + (2 * P + 1) * T;
    fabber_spectral::copy_block(consts, l + P * P,
                                fabber_spectral::core_floats(P));
    fabber_spectral::factor_block<P>(a, l);
    if (v >= V) return;
    fabber_spectral::stats_voxel<P>(rows, T, col, SharedFactor{l}, m0, rtqr,
                                    dtqr);
  } else {
    float* rows = fabber::dynamic_smem();
    l = rows + (2 * P + 1) * T;
    fabber_spectral::copy_block(tconsts, rows, (2 * P + 1) * T);
    fabber_spectral::copy_block(consts, l + P * P,
                                fabber_spectral::core_floats(P));
    fabber_spectral::factor_block<P>(a, l);
    if (v >= V) return;
    fabber_spectral::stats_voxel<P>(rows, T, PlaneColumn{data + v, V},
                                    SharedFactor{l}, m0, rtqr, dtqr);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) pm[i] = pm_in[(size_t)i * V + v];
  fabber_spectral::core_voxel<P, KIND>(m0, rtqr, dtqr, pm,
                                       SharedCore{l + P * P}, det, n_iters,
                                       V, v, means_out, prec_out, cov_out,
                                       b_out, c_out, f_out, tr_out);
}

// ---- launch and C entry points ------------------------------------------

// One launch's arguments.
struct FusedArgs {
  const float* data;
  const float* tconsts;
  const float* pm;
  int T, n_iters;
  long long V;
  SolveConsts ac;
  CoreConsts k;
  const float* a_dev;    // a per-shape instance's A and core constants,
  const float* consts;   // on the device
  DetParams det;
  float* outs[7];
};

// One instance's launch, or (occ not null) its blocks per SM: STAGED in
// blocks of vb lanes, else blocks of kThreads; smem bytes of dynamic
// shared memory (raised above the 48 KB default before the launch).
template <int P, int KIND, bool STAGED>
int launch_form(const FusedArgs& a, int vb, long long smem,
                cudaStream_t stream, int* occ) {
  const auto kernel = [] {
    if constexpr (P > kMaxP)
      return spectral_fused_wide_kernel<P, KIND, STAGED>;
    else
      return spectral_fused_kernel<P, KIND, STAGED>;
  }();
  const int threads = STAGED ? vb : kThreads;
  if (STAGED || smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occ != nullptr) {
    *occ = fabber::tile_occupancy(kernel, threads, smem);
    return 0;
  }
  const unsigned grid = (unsigned)((a.V + threads - 1) / threads);
  if constexpr (P > kMaxP)
    kernel<<<grid, threads, smem, stream>>>(
        a.data, a.tconsts, a.T, a.V, a.a_dev, a.pm, a.consts, a.det,
        a.n_iters, a.outs[0], a.outs[1], a.outs[2], a.outs[3], a.outs[4],
        a.outs[5], a.outs[6]);
  else
    kernel<<<grid, threads, smem, stream>>>(
        a.data, a.tconsts, a.T, a.V, a.ac, a.pm, a.k, a.det, a.n_iters,
        a.outs[0], a.outs[1], a.outs[2], a.outs[3], a.outs[4], a.outs[5],
        a.outs[6]);
  return (int)cudaGetLastError();
}

template <int P, int KIND>
int launch_kind(const FusedArgs& a, int vb, long long smem,
                cudaStream_t stream, int* occ) {
  if (vb > 0) return launch_form<P, KIND, true>(a, vb, smem, stream, occ);
  return launch_form<P, KIND, false>(a, 0, smem, stream, occ);
}

template <int P>
int launch(const FusedArgs& a, int vb, long long smem, cudaStream_t stream,
           int* occ) {
  switch (a.det.kind) {
    case fabber::kMaxits:
      return launch_kind<P, fabber::kMaxits>(a, vb, smem, stream, occ);
    case fabber::kPointZeroOne:
      return launch_kind<P, fabber::kPointZeroOne>(a, vb, smem, stream, occ);
    case fabber::kFreduce:
      return launch_kind<P, fabber::kFreduce>(a, vb, smem, stream, occ);
    default:
      return launch_kind<P, fabber::kTrialMode>(a, vb, smem, stream, occ);
  }
}

#if !defined(FABBER_INST_P)
int dispatch(int p, const FusedArgs& a, int vb, long long smem,
             cudaStream_t s, int* occ) {
  switch (p) {
    case 1: return launch<1>(a, vb, smem, s, occ);
    case 2: return launch<2>(a, vb, smem, s, occ);
    case 3: return launch<3>(a, vb, smem, s, occ);
    case 4: return launch<4>(a, vb, smem, s, occ);
    case 5: return launch<5>(a, vb, smem, s, occ);
    case 6: return launch<6>(a, vb, smem, s, occ);
    case 7: return launch<7>(a, vb, smem, s, occ);
    default: return launch<8>(a, vb, smem, s, occ);
  }
}
#endif

}  // namespace

#if !defined(FABBER_INST_P)

// Kernel 3. data [T,V], tconsts [2P+1,T], pm [P,V] (device); a_host
// [P*P] and consts_host [4P^2+2P+6] (host, by value; the layouts of
// fabber_spectral_stats and fabber_spectral_core). det_kind 0 is maxits;
// 1, 2, 3 are pointzeroone, freduce, trialmode. Outputs as
// fabber_spectral_core's. vb: 0 streams the plane (blocks of 256, the
// rows in 4 (2P+1) T bytes of shared memory); > 0 stages it in blocks of
// vb lanes (a multiple of 32, at most 256, with 4 (T vb + (2P+1) T)
// bytes of shared memory at most 232,448; fabber_spectral_stats's rule);
// other values return cudaErrorInvalidValue.
extern "C" int fabber_spectral_fused(int p, int n_iters, const float* data,
                                     const float* tconsts,
                                     const float* a_host, int T,
                                     const float* pm, const float* consts_host,
                                     int det_kind, float det_tol,
                                     int det_max_its, int det_max_trials,
                                     int det_init_save, long long V,
                                     float* means, float* prec, float* cov,
                                     float* b, float* c, float* f, float* tr,
                                     int vb, void* stream) {
  if (p < 1 || p > kMaxP || n_iters < 1 || T < 1 || V < 1 || det_kind < 0 ||
      det_kind > fabber::kTrialMode)
    return (int)cudaErrorInvalidValue;
  const long long smem = stats_smem(p, vb, T);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  FusedArgs a = {data, tconsts, pm, T, n_iters, V, {}, {}, nullptr, nullptr,
                 {det_kind, det_tol, det_max_its, det_max_trials,
                  det_init_save},
                 {means, prec, cov, b, c, f, tr}};
  for (int i = 0; i < p * p; ++i) a.ac.a[i] = a_host[i];
  for (int i = 0; i < 4 * p * p + 2 * p + 6; ++i) a.k.v[i] = consts_host[i];
  return dispatch(p, a, vb, smem, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// Blocks per SM of kernel 3 at P = p, detector det_kind, in the form vb
// selects (fabber_spectral_fused's vb) at T samples; -1 where the
// arguments are refused or the CUDA call fails.
extern "C" int fabber_fused_occupancy(int p, int det_kind, int vb, int T) {
  const long long smem = stats_smem(p, vb, T);
  if (p < 1 || p > kMaxP || T < 1 || smem < 0 || det_kind < 0 ||
      det_kind > fabber::kTrialMode)
    return -1;
  FusedArgs a = {};
  a.T = T;
  a.V = 1;
  a.det.kind = det_kind;
  int occ = 0;
  return dispatch(p, a, vb, smem, nullptr, &occ) == 0 ? occ : -1;
}
#else
// A per-shape instance's entry points (ops/_cuda.py build_instance, P =
// FABBER_INST_P, 9 to 25): fabber_spectral_fused's arguments, with a
// [P*P] and consts [4P^2+2P+6] on the device; 4 (5P^2 + 2P + 6) bytes of
// shared memory more. Another p returns cudaErrorInvalidValue.
extern "C" int fabber_inst_spectral_fused(
    int p, int n_iters, const float* data, const float* tconsts,
    const float* a_dev, int T, const float* pm, const float* consts,
    int det_kind, float det_tol, int det_max_its, int det_max_trials,
    int det_init_save, long long V, float* means, float* prec, float* cov,
    float* b, float* c, float* f, float* tr, int vb, void* stream) {
  constexpr int P = FABBER_INST_P;
  if (p != P || n_iters < 1 || T < 1 || V < 1 || det_kind < 0 ||
      det_kind > fabber::kTrialMode)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      stats_smem(P, vb, T, P * P + fabber_spectral::core_floats(P));
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const FusedArgs a = {data, tconsts, pm, T, n_iters, V, {}, {}, a_dev,
                       consts,
                       {det_kind, det_tol, det_max_its, det_max_trials,
                        det_init_save},
                       {means, prec, cov, b, c, f, tr}};
  return launch<P>(a, vb, smem, static_cast<cudaStream_t>(stream), nullptr);
}

// fabber_fused_occupancy for this instance
extern "C" int fabber_inst_fused_occupancy(int p, int det_kind, int vb,
                                           int T) {
  constexpr int P = FABBER_INST_P;
  const long long smem =
      stats_smem(P, vb, T, P * P + fabber_spectral::core_floats(P));
  if (p != P || T < 1 || smem < 0 || det_kind < 0 ||
      det_kind > fabber::kTrialMode)
    return -1;
  FusedArgs a = {};
  a.T = T;
  a.V = 1;
  a.det.kind = det_kind;
  int occ = 0;
  return launch<P>(a, vb, smem, nullptr, &occ) == 0 ? occ : -1;
}
#endif
