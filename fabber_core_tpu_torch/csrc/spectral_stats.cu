// spectral_stats: the sufficient statistics of the fixed-design,
// single-noise-group spectral route, for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_spectral.py
// make_spectral_stats_kernel (its pallas_call at line 719).
//
// One thread per voxel v. The per-timepoint constants (raw design D,
// mask-weighted design DW = D*q, mask q: (2P+1) rows of T floats) are
// copied into shared memory once per block and read as broadcasts. Then
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
// Both passes read the column, and a block's columns (108 KB for 256
// lanes at T=106) outlive the 50 MB L2 across all resident blocks, so
// streamed, pass 2 goes back to HBM for most of the plane: 4.93-5.20 ms
// at 16,777,216 voxels on an NVIDIA H100 80GB HBM3 (700 W), about 2x
// the plane's copy time. The staged form (template STAGED) copies the
// block's [T, VB] tile into shared memory once with cp.async, beside the
// design rows (one dynamic allocation), and both passes read it there:
// HBM sees the plane once. The copy is the staged form's cost, so the
// block's lanes copy the tile in 16-byte chunks, a quarter of the copies
// of one 4-byte copy per lane and sample, for any V and any plane: row t
// of the tile holds the plane's row t rotated by its first sample's
// offset from 16-byte alignment (StatsTile), so the plane's aligned
// chunks land on aligned words, and each row's unaligned head and tail
// take one 4-byte copy per float (stage_stats; both in
// spectral_device.cuh, kernel 3's staging too). ops/_cuda.py tile_plan
// stages in the widest of 128, 64 and 32 lanes whose blocks leave at
// least five warps per SM (4 (T VB + (2P+1) T) bytes: 57,240 at T=106,
// P=3, VB 128, 4 blocks per SM): each lane makes one pass of each kind,
// so no straggler holds a tile, and wider blocks ran faster
// (probes/stats_tile.py); else the streamed form serves (blocks of 256,
// the rows alone in shared memory). The two forms run the same
// arithmetic in the same order (per-voxel body csrc/spectral_device.cuh
// stats_voxel, which kernel 3, spectral_fused.cu, runs in both forms
// too), so they agree bit for bit.
//
// Past P = 8 (a per-shape instance: ops/_cuda.py build_instance compiles
// this file with FABBER_INST_P defined, P 9 to 25) the kernel is
// spectral_stats_wide_kernel: A comes from a device buffer, its factor
// is taken once per block into shared memory after the rows
// (spectral_device.cuh factor_block, 4 P^2 bytes more), and each lane
// solves for its m0 on that factor; the passes are the same. The data
// read still bounds it: the (2P+1) x T rows are broadcasts.

#include <cuda_runtime.h>

#include "spectral_device.cuh"

namespace {

using fabber_spectral::kMaxP;
using fabber_spectral::PlaneColumn;
using fabber_spectral::SharedFactor;
using fabber_spectral::SolveConsts;
using fabber_spectral::StatsTile;
using fabber_spectral::stats_smem;
constexpr int kThreads = fabber_spectral::kStatsThreads;

template <int P, bool STAGED>
__global__ void __launch_bounds__(kThreads)
spectral_stats_kernel(const float* __restrict__ data,
                      const float* __restrict__ tconsts, int T, long long V,
                      SolveConsts ac, float* __restrict__ m0_out,
                      float* __restrict__ rtqr_out,
                      float* __restrict__ dtqr_out) {
  // rows [(2P+1), T]: D rows, DW rows, q. Every thread of the block
  // takes part in the copies and the barrier, those past V included.
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float m0[P], rtqr, dtqr[P];
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
  for (int a = 0; a < P; ++a) {
    m0_out[(size_t)a * V + v] = m0[a];
    dtqr_out[(size_t)a * V + v] = dtqr[a];
  }
  rtqr_out[v] = rtqr;
}

// A per-shape instance (P > kMaxP): a [P*P] (device) is factored once per
// block into shared memory after the rows (factor_block), which every
// lane's m0 solve reads. Otherwise spectral_stats_kernel.
template <int P, bool STAGED>
__global__ void __launch_bounds__(kThreads)
spectral_stats_wide_kernel(const float* __restrict__ data,
                           const float* __restrict__ tconsts, int T,
                           long long V, const float* __restrict__ a,
                           float* __restrict__ m0_out,
                           float* __restrict__ rtqr_out,
                           float* __restrict__ dtqr_out) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float m0[P], rtqr, dtqr[P];
  if constexpr (STAGED) {
    const StatsTile col =
        fabber_spectral::stage_stats<P>(data, tconsts, T, V);
    const float* rows = col.tile + T * col.vb;
    float* l = const_cast<float*>(rows) + (2 * P + 1) * T;
    fabber_spectral::factor_block<P>(a, l);
    if (v >= V) return;
    fabber_spectral::stats_voxel<P>(rows, T, col, SharedFactor{l}, m0, rtqr,
                                    dtqr);
  } else {
    float* rows = fabber::dynamic_smem();
    float* l = rows + (2 * P + 1) * T;
    fabber_spectral::copy_block(tconsts, rows, (2 * P + 1) * T);
    fabber_spectral::factor_block<P>(a, l);
    if (v >= V) return;
    fabber_spectral::stats_voxel<P>(rows, T, PlaneColumn{data + v, V},
                                    SharedFactor{l}, m0, rtqr, dtqr);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    m0_out[(size_t)i * V + v] = m0[i];
    dtqr_out[(size_t)i * V + v] = dtqr[i];
  }
  rtqr_out[v] = rtqr;
}

// ---- launch and C entry points ------------------------------------------

// One instance's launch, or (occ not null) its blocks per SM: STAGED in
// blocks of vb lanes, else blocks of kThreads; smem bytes of dynamic
// shared memory (raised above the 48 KB default before the launch).
template <int P, bool STAGED, class AC>
int launch_form(const float* data, const float* tconsts, const AC& ac,
                int T, long long V, float* m0, float* rtqr, float* dtqr,
                int vb, long long smem, cudaStream_t stream, int* occ) {
  const auto kernel = [] {
    if constexpr (P > kMaxP)
      return spectral_stats_wide_kernel<P, STAGED>;
    else
      return spectral_stats_kernel<P, STAGED>;
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
  const unsigned grid = (unsigned)((V + threads - 1) / threads);
  kernel<<<grid, threads, smem, stream>>>(data, tconsts, T, V, ac, m0, rtqr,
                                          dtqr);
  return (int)cudaGetLastError();
}

template <int P, class AC>
int launch(const float* data, const float* tconsts, const AC& ac, int T,
           long long V, float* m0, float* rtqr, float* dtqr, int vb,
           long long smem, cudaStream_t stream, int* occ) {
  if (vb > 0)
    return launch_form<P, true>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb,
                                smem, stream, occ);
  return launch_form<P, false>(data, tconsts, ac, T, V, m0, rtqr, dtqr, 0,
                               smem, stream, occ);
}

#if !defined(FABBER_INST_P)
int dispatch(int p, const float* data, const float* tconsts,
             const SolveConsts& ac, int T, long long V, float* m0,
             float* rtqr, float* dtqr, int vb, long long smem,
             cudaStream_t s, int* occ) {
  switch (p) {
    case 1: return launch<1>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb, smem, s, occ);
    case 2: return launch<2>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb, smem, s, occ);
    case 3: return launch<3>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb, smem, s, occ);
    case 4: return launch<4>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb, smem, s, occ);
    case 5: return launch<5>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb, smem, s, occ);
    case 6: return launch<6>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb, smem, s, occ);
    case 7: return launch<7>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb, smem, s, occ);
    default: return launch<8>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb, smem, s, occ);
  }
}
#endif

}  // namespace

#if !defined(FABBER_INST_P)

// Kernel 1. data [T,V], tconsts [2P+1,T] (device); a_host [P*P] (host, by
// value). Outputs m0 [P,V], rtqr [1,V], dtqr [P,V] (device,
// preallocated). vb: 0 streams the plane (blocks of 256, the rows in
// 4 (2P+1) T bytes of shared memory); > 0 stages it in blocks of vb lanes
// (a multiple of 32, at most 256, with 4 (T vb + (2P+1) T) bytes of
// shared memory at most 232,448; ops/_cuda.py tile_plan); other values
// return cudaErrorInvalidValue.
extern "C" int fabber_spectral_stats(int p, const float* data,
                                     const float* tconsts,
                                     const float* a_host, int T, long long V,
                                     float* m0, float* rtqr, float* dtqr,
                                     int vb, void* stream) {
  if (p < 1 || p > kMaxP || T < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const long long smem = stats_smem(p, vb, T);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  SolveConsts ac = {};
  for (int i = 0; i < p * p; ++i) ac.a[i] = a_host[i];
  return dispatch(p, data, tconsts, ac, T, V, m0, rtqr, dtqr, vb, smem,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks per SM of kernel 1 at P = p in the form vb selects
// (fabber_spectral_stats's vb) at T samples; -1 where the arguments are
// refused or the CUDA call fails.
extern "C" int fabber_stats_occupancy(int p, int vb, int T) {
  const long long smem = stats_smem(p, vb, T);
  if (p < 1 || p > kMaxP || T < 1 || smem < 0) return -1;
  const SolveConsts ac = {};
  int occ = 0;
  return dispatch(p, nullptr, nullptr, ac, T, 1, nullptr, nullptr, nullptr,
                  vb, smem, nullptr, &occ) == 0
             ? occ
             : -1;
}
#else
// A per-shape instance's entry points (ops/_cuda.py build_instance, P =
// FABBER_INST_P, 9 to 25): fabber_spectral_stats's arguments, with a
// [P*P] on the device; 4 P^2 bytes of shared memory more. Another p
// returns cudaErrorInvalidValue.
extern "C" int fabber_inst_spectral_stats(int p, const float* data,
                                          const float* tconsts,
                                          const float* a, int T, long long V,
                                          float* m0, float* rtqr,
                                          float* dtqr, int vb,
                                          void* stream) {
  constexpr int P = FABBER_INST_P;
  static_assert(P > kMaxP && P <= fabber_spectral::kWideMaxP,
                "a spectral instance past the prebuilt P");
  if (p != P || T < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const long long smem = stats_smem(P, vb, T, P * P);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  return launch<P>(data, tconsts, a, T, V, m0, rtqr, dtqr, vb, smem,
                   static_cast<cudaStream_t>(stream), nullptr);
}

// fabber_stats_occupancy for this instance
extern "C" int fabber_inst_stats_occupancy(int p, int vb, int T) {
  constexpr int P = FABBER_INST_P;
  const long long smem = stats_smem(P, vb, T, P * P);
  if (p != P || T < 1 || smem < 0) return -1;
  int occ = 0;
  const float* a = nullptr;
  return launch<P>(nullptr, nullptr, a, T, 1, nullptr, nullptr, nullptr, vb,
                   smem, nullptr, &occ) == 0
             ? occ
             : -1;
}
#endif
