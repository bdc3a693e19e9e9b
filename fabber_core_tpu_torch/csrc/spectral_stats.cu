// spectral_stats: one-read sufficient statistics of the fixed-design,
// single-noise-group spectral route, for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_spectral.py
// make_spectral_stats_kernel (its pallas_call at line 719).
//
// One thread per voxel v. The per-timepoint constants (raw design D,
// mask-weighted design DW = D*q, mask q: (2P+1) rows of T floats) are
// staged in shared memory once per block and read as broadcasts. Then
//   pass 1  dty_a = sum_t DW[a,t] y[t]                       (f32 FMAs)
//   solve   m0 = A^-1 dty by an unrolled f32 Cholesky of the f32
//           A = D'QD (the TPU kernel's same-arithmetic rule: a host-f64
//           inverse would break r0's f32 orthogonality); a non-finite
//           m0 is replaced by 0 (the reference point is then the raw
//           expansion, still correct)
//   pass 2  r0 = y - D m0;  rtqr = sum_t q r0^2;  dtqr_a = sum_t DW[a,t] r0
//
// What bounds it on this card: the [T,V] data read, 4*T bytes per voxel
// (424 B at T=106), against 4*(2P+1) bytes of output. Voxels lie on the
// last axis, so the 32 threads of a warp load 32 consecutive floats of
// row t: one 128-byte transaction per row. The TPU form's 128-padded
// time axis and its K=8 MXU products existed for the MXU and are gone.
// This first version re-reads the column in pass 2 (from L2 where it is
// still resident, else from HBM), so it moves up to 2x the floor;
// staging the [T, block] tile in shared memory is the next step. The
// per-voxel body is csrc/spectral_device.cuh stats_voxel, which kernel 3
// (spectral_fused.cu) runs too.

#include <cuda_runtime.h>

#include "spectral_device.cuh"

namespace {

using fabber_spectral::kMaxP;
using fabber_spectral::SolveConsts;
constexpr int kThreads = 256;

template <int P>
__global__ void __launch_bounds__(kThreads)
spectral_stats_kernel(const float* __restrict__ data,
                      const float* __restrict__ tconsts, int T, long long V,
                      SolveConsts ac, float* __restrict__ m0_out,
                      float* __restrict__ rtqr_out,
                      float* __restrict__ dtqr_out) {
  extern __shared__ float rows[];  // [(2P+1), T]: D rows, DW rows, q
  const int nrows = (2 * P + 1) * T;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) rows[i] = tconsts[i];
  __syncthreads();

  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float m0[P], rtqr, dtqr[P];
  fabber_spectral::stats_voxel<P>(rows, T, data + v, V, ac, m0, rtqr, dtqr);
#pragma unroll
  for (int a = 0; a < P; ++a) {
    m0_out[(size_t)a * V + v] = m0[a];
    dtqr_out[(size_t)a * V + v] = dtqr[a];
  }
  rtqr_out[v] = rtqr;
}

template <int P>
int launch(const float* data, const float* tconsts, const SolveConsts& ac,
           int T, long long V, float* m0, float* rtqr, float* dtqr,
           cudaStream_t stream) {
  const size_t smem = (size_t)(2 * P + 1) * T * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectral_stats_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((V + kThreads - 1) / kThreads);
  spectral_stats_kernel<P><<<grid, kThreads, smem, stream>>>(
      data, tconsts, T, V, ac, m0, rtqr, dtqr);
  return (int)cudaGetLastError();
}

}  // namespace

// data [T,V], tconsts [2P+1,T] (device); a_host [P*P] (host, by value).
// Outputs m0 [P,V], rtqr [1,V], dtqr [P,V] (device, preallocated).
extern "C" int fabber_spectral_stats(int p, const float* data,
                                     const float* tconsts,
                                     const float* a_host, int T, long long V,
                                     float* m0, float* rtqr, float* dtqr,
                                     void* stream) {
  if (p < 1 || p > kMaxP || T < 1 || V < 1) return (int)cudaErrorInvalidValue;
  SolveConsts ac = {};
  for (int i = 0; i < p * p; ++i) ac.a[i] = a_host[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch<1>(data, tconsts, ac, T, V, m0, rtqr, dtqr, s);
    case 2: return launch<2>(data, tconsts, ac, T, V, m0, rtqr, dtqr, s);
    case 3: return launch<3>(data, tconsts, ac, T, V, m0, rtqr, dtqr, s);
    case 4: return launch<4>(data, tconsts, ac, T, V, m0, rtqr, dtqr, s);
    case 5: return launch<5>(data, tconsts, ac, T, V, m0, rtqr, dtqr, s);
    case 6: return launch<6>(data, tconsts, ac, T, V, m0, rtqr, dtqr, s);
    case 7: return launch<7>(data, tconsts, ac, T, V, m0, rtqr, dtqr, s);
    default: return launch<8>(data, tconsts, ac, T, V, m0, rtqr, dtqr, s);
  }
}
