// A patched copy of csrc/spectral_stats.cu (its statistics in
// probes/csrc/stats_variants.cuh) as it stood when probes/stats_tile.py measured its
// staged builds on an NVIDIA H100: the 16-byte tile copy only where the
// plane's rows are 16-byte aligned (else one float a lane), and two
// builds csrc/ does not keep, -DFABBER_STATS_BULK and
// -DFABBER_STATS_ROWS4 (PERF.md row 1). The probe builds it alone
// (probes/variants.py) and swaps its entry points in; csrc/ holds the
// kernel the port runs.
//
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
// the plane's copy time. The staged form (template STAGED, csrc/
// tile.cuh's Column, as kernel 4's statistics) copies the block's
// [T, VB] tile into shared memory once with cp.async, beside the design
// rows (one dynamic allocation), and both passes read it there: HBM sees
// the plane once. The copy is the staged form's cost: where the plane's
// rows are 16-byte aligned the block's lanes copy each row in 16-byte
// chunks (stage_stats), a quarter of the copies of one 4-byte copy per
// lane and sample. ops/_cuda.py tile_plan stages in the widest of 128,
// 64 and 32 lanes whose blocks leave at least five warps per SM (4 (T VB
// + (2P+1) T) bytes: 57,240 at T=106, P=3, VB 128, 4 blocks per SM):
// each lane makes one pass of each kind, so no straggler holds a tile,
// and wider blocks ran faster (probes/stats_tile.py); else the streamed
// form serves (blocks of 256, the rows alone in shared memory). The two
// forms run the same arithmetic in the same order (per-voxel body
// csrc/spectral_device.cuh stats_voxel, which kernel 3, spectral_fused.cu,
// runs streamed), so they agree bit for bit.
//
// Two builds of the staged form for probes/stats_tile.py, neither the
// default: -DFABBER_STATS_BULK copies the tile's rows with the copy
// engine (cp.async.bulk, one per sample row, counted by an mbarrier)
// instead of the lanes' 16-byte copies; -DFABBER_STATS_ROWS4 lays the
// rows out per sample (spectral_device.cuh rows4_stride), so a sample's
// 2P+1 row values take (2P+1)/4 rounded up 16-byte shared-memory loads
// (2 at P=3) instead of 2P+1 4-byte ones.

#include <cuda_runtime.h>
#include <stdint.h>

#include "spectral_device.cuh"
#include "stats_variants.cuh"
#include "tile.cuh"

namespace {

using fabber::Column;
using fabber_spectral::kMaxP;
using fabber_spectral::SolveConsts;
constexpr int kThreads = 256;   // streamed block; the largest staged VB
#if defined(FABBER_STATS_ROWS4)
constexpr bool kRows4 = true;
#else
constexpr bool kRows4 = false;
#endif

// Floats of the rows in shared memory at (p, T).
inline int rows_floats(int p, int T) {
  return (kRows4 ? (2 * p + 4) / 4 * 4 : 2 * p + 1) * T;
}

#if defined(FABBER_STATS_BULK)
// The tile's rows by the copy engine (cp.async.bulk, the TMA's plain
// form): warp 0's lanes start one bulk copy per sample row (the block's
// VB floats, or those below V in the last block), whose completion the
// block's mbarrier counts in bytes.
__device__ __forceinline__ void bulk_rows(float* tile, const float* data,
                                          int T, long long V, long long v0,
                                          int vb, uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  const long long left = V - v0;
  const unsigned row = 4u * (unsigned)(left < vb ? left : vb);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(row * (unsigned)T)
          : "memory");
    __syncwarp();
    for (int t = threadIdx.x; t < T; t += 32) {
      const unsigned d =
          static_cast<unsigned>(__cvta_generic_to_shared(tile + t * vb));
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(d),
          "l"(data + (size_t)t * V + v0), "r"(row), "r"(b)
          : "memory");
    }
  }
#endif
}

// every thread waits for the bulk copies' bytes (the barrier's phase 0)
__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
#endif
}
#endif

// The staged form's copies: the [T, vb] tile, then the rows (per sample
// under FABBER_STATS_ROWS4), then the wait and the block's barrier;
// every thread takes part. Where the plane's rows are 16-byte aligned
// (V % 4 == 0, a 16-byte aligned base, vb a multiple of 4) the block's
// lanes copy the tile in 16-byte chunks, a row's chunks on consecutive
// lanes (T vb / 4 cp.async a block, or under FABBER_STATS_BULK one bulk
// copy a row); else each lane copies its own column, 4 bytes a sample
// (T vb). On an NVIDIA H100 at T=106, P=3 the 16-byte copies took the
// staged kernel from 3.83 to 3.31 ms at VB 128 (probes/stats_tile.py).
template <int P>
__device__ __forceinline__ Column<true> stage_stats(
    const float* __restrict__ data, const float* __restrict__ tconsts,
    int T, long long V, long long v) {
  const int vb = (int)blockDim.x, lane = (int)threadIdx.x;
  float* tile = fabber::dynamic_smem();
  float* rows = tile + T * vb;
  const long long v0 = (long long)blockIdx.x * vb;
  const bool wide = (V & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(data) & 15) == 0 &&
                    (vb & 3) == 0;
#if defined(FABBER_STATS_BULK)
  __shared__ alignas(8) uint64_t bar;
  if (wide) bulk_rows(tile, data, T, V, v0, vb, &bar);
#else
  if (wide) {
    const int nc = vb / 4;   // 16-byte chunks per row of the tile
    for (int i = lane; i < T * nc; i += vb) {
      const int t = i / nc, c = i - t * nc;
      const long long u = v0 + 4 * c;
      fabber::cp_async16(tile + t * vb + 4 * c,
                         data + (size_t)t * V + (u < V ? u : 0),
                         u < V ? 4 : 0);
    }
  }
#endif
  if (!wide) {
    const bool in = v < V;
    const float* src = data + (in ? v : 0);
    for (int t = 0; t < T; ++t)
      fabber::cp_async4(tile + t * vb + lane, src + (size_t)t * V, in);
  }
  const int nrows = (2 * P + 1) * T;
  for (int i = lane; i < nrows; i += vb) {
    int slot = i;
    if constexpr (kRows4) {
      const int r = i / T, t = i - r * T;
      slot = t * fabber_probe::rows4_stride<P>() +
             (r < P ? P + 1 + r : (r < 2 * P ? r - P : P));
    }
    fabber::cp_async4(rows + slot, tconsts + i, true);
  }
  fabber::cp_async_wait_block();
#if defined(FABBER_STATS_BULK)
  if (wide) bulk_wait(&bar);
#endif
  return Column<true>{tile, rows, vb, lane};
}

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
    const Column<true> col = stage_stats<P>(data, tconsts, T, V, v);
    if (v >= V) return;
    fabber_probe::stats_voxel<P, true, kRows4>(col.w, T, col, ac, m0, rtqr,
                                                 dtqr);
  } else {
    float* rows = fabber::dynamic_smem();
    for (int i = threadIdx.x; i < (2 * P + 1) * T; i += blockDim.x)
      rows[i] = tconsts[i];
    __syncthreads();
    if (v >= V) return;
    fabber_probe::stats_voxel<P>(
        rows, T, Column<false>{data + v, rows, V, 0}, ac, m0, rtqr, dtqr);
  }
#pragma unroll
  for (int a = 0; a < P; ++a) {
    m0_out[(size_t)a * V + v] = m0[a];
    dtqr_out[(size_t)a * V + v] = dtqr[a];
  }
  rtqr_out[v] = rtqr;
}

// ---- launch and C entry points ------------------------------------------

// Dynamic shared memory of a launch at (vb, T): streamed (vb 0) the rows;
// staged the [T, vb] tile and the rows; -1 where refused (tile.cuh
// tile_bytes: vb not a multiple of 32 or above kThreads, or a tile above
// a block's shared memory; rows beyond it).
inline long long stats_smem(int p, int vb, int T) {
  if (vb == 0) {
    const long long b = 4LL * (2 * p + 1) * T;
    return b <= fabber::kMaxBlockSmem ? b : -1;
  }
  return fabber::tile_bytes(vb, T, rows_floats(p, T), kThreads);
}

// One instance's launch, or (occ not null) its blocks per SM: STAGED in
// blocks of vb lanes, else blocks of kThreads; smem bytes of dynamic
// shared memory (raised above the 48 KB default before the launch).
template <int P, bool STAGED>
int launch_form(const float* data, const float* tconsts,
                const SolveConsts& ac, int T, long long V, float* m0,
                float* rtqr, float* dtqr, int vb, long long smem,
                cudaStream_t stream, int* occ) {
  const auto kernel = spectral_stats_kernel<P, STAGED>;
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

template <int P>
int launch(const float* data, const float* tconsts, const SolveConsts& ac,
           int T, long long V, float* m0, float* rtqr, float* dtqr, int vb,
           long long smem, cudaStream_t stream, int* occ) {
  if (vb > 0)
    return launch_form<P, true>(data, tconsts, ac, T, V, m0, rtqr, dtqr, vb,
                                smem, stream, occ);
  return launch_form<P, false>(data, tconsts, ac, T, V, m0, rtqr, dtqr, 0,
                               smem, stream, occ);
}

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

}  // namespace

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
