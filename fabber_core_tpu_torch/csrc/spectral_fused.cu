// spectral_fused: the one-kernel form of the spectral route (statistics
// and eigenbasis fixed point in one thread), for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_spectral.py
// make_fused_spectral_loop (its pallas_call at line 529), in maxits
// (DET = false) and in the pointzeroone / freduce / trialmode detector
// mode (DET = true). Plain version: fabber_core_tpu_torch/ops/
// fused_spectral.py spectral_fused_plain (the plain statistics, then the
// plain core).
//
// One thread per voxel. The block stages the (2P+1) x T design rows in
// shared memory, as spectral_stats.cu does; each thread then runs
// csrc/spectral_device.cuh stats_voxel on its data column and hands its
// m0, rtqr and dtqr in registers to core_voxel, which writes the
// posterior. The statistics never reach device memory, so the kernel's
// outputs are those of the split pair (spectral_stats.cu followed by
// spectral_core.cu) bit for bit: the same device code on the same
// values.
//
// What bounds it on this card: the [T,V] data read, 4*T bytes per voxel,
// plus the (2P^2+P+4)*4-byte posterior write and the prior means read;
// the split pair adds a (2P+1)-plane write and a (3P+1)-plane read of
// the statistics in between (72 B per voxel at P=3). It reads the column
// in the plane in both passes, as the stats kernel's streamed form does
// (pass 2 from L2 where it is still resident, else from HBM). It holds
// the registers of both bodies at once, so it may run at a lower
// occupancy than either half (chip_smoke.py phase 2 prints ptxas's
// counts).

#include <cuda_runtime.h>

#include "spectral_device.cuh"

namespace {

using fabber::DetParams;
using fabber_spectral::CoreConsts;
using fabber_spectral::kMaxP;
using fabber_spectral::SolveConsts;
constexpr int kThreads = 256;

template <int P, bool DET>
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
  extern __shared__ float rows[];  // [(2P+1), T]: D rows, DW rows, q
  const int nrows = (2 * P + 1) * T;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) rows[i] = tconsts[i];
  __syncthreads();

  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float m0[P], rtqr, dtqr[P], pm[P];
  fabber_spectral::stats_voxel<P>(
      rows, T, fabber_spectral::PlaneColumn{data + v, V}, ac, m0, rtqr,
      dtqr);
#pragma unroll
  for (int a = 0; a < P; ++a) pm[a] = pm_in[(size_t)a * V + v];
  fabber_spectral::core_voxel<P, DET>(m0, rtqr, dtqr, pm, k, det, n_iters, V,
                                      v, means_out, prec_out, cov_out, b_out,
                                      c_out, f_out, tr_out);
}

template <int P, bool DET>
int launch_mode(const float* data, const float* tconsts, int T, long long V,
                const SolveConsts& ac, const float* pm, const CoreConsts& k,
                const DetParams& det, int n_iters, float* const* outs,
                cudaStream_t stream) {
  const size_t smem = (size_t)(2 * P + 1) * T * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectral_fused_kernel<P, DET>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((V + kThreads - 1) / kThreads);
  spectral_fused_kernel<P, DET><<<grid, kThreads, smem, stream>>>(
      data, tconsts, T, V, ac, pm, k, det, n_iters, outs[0], outs[1],
      outs[2], outs[3], outs[4], outs[5], outs[6]);
  return (int)cudaGetLastError();
}

template <int P>
int launch(const float* data, const float* tconsts, int T, long long V,
           const SolveConsts& ac, const float* pm, const CoreConsts& k,
           const DetParams& det, int n_iters, float* const* outs,
           cudaStream_t stream) {
  if (det.kind == fabber::kMaxits)
    return launch_mode<P, false>(data, tconsts, T, V, ac, pm, k, det,
                                 n_iters, outs, stream);
  return launch_mode<P, true>(data, tconsts, T, V, ac, pm, k, det, n_iters,
                              outs, stream);
}

}  // namespace

// data [T,V], tconsts [2P+1,T], pm [P,V] (device); a_host [P*P] and
// consts_host [4P^2+2P+6] (host, by value; the layouts of
// fabber_spectral_stats and fabber_spectral_core). det_kind 0 is maxits;
// 1, 2, 3 are pointzeroone, freduce, trialmode. Outputs as
// fabber_spectral_core's.
extern "C" int fabber_spectral_fused(int p, int n_iters, const float* data,
                                     const float* tconsts,
                                     const float* a_host, int T,
                                     const float* pm, const float* consts_host,
                                     int det_kind, float det_tol,
                                     int det_max_its, int det_max_trials,
                                     int det_init_save, long long V,
                                     float* means, float* prec, float* cov,
                                     float* b, float* c, float* f, float* tr,
                                     void* stream) {
  if (p < 1 || p > kMaxP || n_iters < 1 || T < 1 || V < 1 || det_kind < 0 ||
      det_kind > fabber::kTrialMode)
    return (int)cudaErrorInvalidValue;
  SolveConsts ac = {};
  for (int i = 0; i < p * p; ++i) ac.a[i] = a_host[i];
  CoreConsts k = {};
  for (int i = 0; i < 4 * p * p + 2 * p + 6; ++i) k.v[i] = consts_host[i];
  const DetParams det = {det_kind, det_tol, det_max_its, det_max_trials,
                         det_init_save};
  float* const outs[7] = {means, prec, cov, b, c, f, tr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch<1>(data, tconsts, T, V, ac, pm, k, det, n_iters, outs, s);
    case 2: return launch<2>(data, tconsts, T, V, ac, pm, k, det, n_iters, outs, s);
    case 3: return launch<3>(data, tconsts, T, V, ac, pm, k, det, n_iters, outs, s);
    case 4: return launch<4>(data, tconsts, T, V, ac, pm, k, det, n_iters, outs, s);
    case 5: return launch<5>(data, tconsts, T, V, ac, pm, k, det, n_iters, outs, s);
    case 6: return launch<6>(data, tconsts, T, V, ac, pm, k, det, n_iters, outs, s);
    case 7: return launch<7>(data, tconsts, T, V, ac, pm, k, det, n_iters, outs, s);
    default: return launch<8>(data, tconsts, T, V, ac, pm, k, det, n_iters, outs, s);
  }
}
