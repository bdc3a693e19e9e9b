// tile.cuh: a block's slice of the [T, V] data plane staged in shared
// memory once, for the kernels that read a voxel's data column in more
// than one pass (fused_nlls.cu, kernel 8; fused_nl_loop.cuh, kernel 6;
// fused_vb_iter.cu, kernel 7; fused_whole.cu, kernel 4), for Hopper
// (sm_90a).
//
// A block of VB lanes (VB = blockDim.x, a multiple of 32 and at most the
// kernel's kThreads) copies its [T, VB] slice of the plane and the nw
// per-sample weights ([T] for kernel 8, [T, Q] for kernels 6 and 7, the
// (P + QP + Q) x T design rows for kernel 4) into dynamic
// shared memory with 4-byte cp.async copies (lanes past V are zero
// filled), one commit group, then waits for it and meets the block's
// barrier. Each thread copies its own column: row t of the tile is
// tile[t * VB + lane], so a warp's 32 copies (and later its 32 reads) of
// one row are consecutive words, one per bank. Every pass of the loop
// then reads its samples from shared memory instead of HBM. Kernel 1
// (spectral_stats.cu) lays its tile out its own way, rows rotated for
// 16-byte copies, with the copies, the size rule and the occupancy query
// below.
//
// The streamed form reads the plane in global memory as before; it
// serves a T whose tile leaves too few warps per SM (ops/_cuda.py
// tile_plan) and is the same-call yardstick of the staged one. Both go
// through Column, so a pass is one function for both forms: (src,
// stride, lane) is (tile, VB, threadIdx.x) staged and (data, V, v)
// streamed.
//
// Without __CUDA_ARCH__ (the CPU tests compile the kernels as host C++,
// one thread per block) the copies are plain loads and stores.

#pragma once

#include <cuda_runtime.h>

namespace fabber {

// the most dynamic shared memory one block may take on sm_90 (227 KB)
constexpr int kMaxBlockSmem = 232448;

template <bool STAGED>
struct Column {
  const float* __restrict__ x;   // the samples: tile [T,VB] or plane [T,V]
  const float* __restrict__ w;   // the weights: their shared copy or global
  long long stride;              // VB or V
  long long lane;                // threadIdx.x or v

  __device__ __forceinline__ float sample(int t) const {
    if constexpr (STAGED)
      return x[t * (int)stride + (int)lane];
    else
      return x[(size_t)t * stride + lane];
  }
  __device__ __forceinline__ float weight(int i) const {
    if constexpr (STAGED)
      return w[i];
    else
      return __ldg(w + i);
  }
};

// dst <- *src (4 bytes, asynchronously), or 0 where !valid (src unread)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
#else
  *dst = valid ? *src : 0.f;
#endif
}

// dst <- the n (0 to 4) floats at src, zeros after them (asynchronously,
// around L1; src unread where n is 0); both 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int n) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(4 * n)
               : "memory");
#else
  for (int i = 0; i < 4; ++i) dst[i] = i < n ? src[i] : 0.f;
#endif
}

// one commit group for the copies above, waited for, then the barrier
__device__ __forceinline__ void cp_async_wait_block() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  __syncthreads();
}

__device__ __forceinline__ float* dynamic_smem() {
#if defined(__CUDACC__)
  extern __shared__ float fabber_tile_smem[];
  return fabber_tile_smem;
#else
  static float host_tile[1 << 16];   // host C++: one block at a time
  return host_tile;
#endif
}

// The column this thread's passes read. Staged: every thread of the
// block (those past V included, which must meet the barrier) copies its
// lane of the [nt, VB] tile and a share of the nw weights into dynamic
// shared memory (tile first, weights after it). Streamed: the plane and
// the weights where they are.
template <bool STAGED>
__device__ __forceinline__ Column<STAGED> stage_column(
    const float* __restrict__ data, const float* __restrict__ w, int nt,
    int nw, long long V, long long v) {
  if constexpr (STAGED) {
    const int vb = (int)blockDim.x, lane = (int)threadIdx.x;
    float* tile = dynamic_smem();
    float* wsh = tile + nt * vb;
    const bool in = v < V;
    const float* src = data + (in ? v : 0);
    for (int t = 0; t < nt; ++t)
      cp_async4(tile + t * vb + lane, src + (size_t)t * V, in);
    for (int i = lane; i < nw; i += vb) cp_async4(wsh + i, w + i, true);
    cp_async_wait_block();
    return Column<true>{tile, wsh, vb, lane};
  } else {
    return Column<false>{data, w, V, v};
  }
}

// Dynamic shared memory of a staged launch: the [nt, vb] tile and the
// nw weights; -1 where (vb, nt) is one the kernels refuse: vb not a
// multiple of 32, above max_vb, or a tile above kMaxBlockSmem.
inline long long tile_bytes(int vb, int nt, int nw, int max_vb) {
  if (vb < 32 || vb > max_vb || vb % 32 != 0 || nt < 1 || nw < 0) return -1;
  const long long bytes = 4LL * ((long long)nt * vb + nw);
  return bytes <= kMaxBlockSmem ? bytes : -1;
}

#if defined(__CUDACC__)
// Launch geometry and the shared-memory opt-in of one instance: vb = 0
// streams (blocks of threads lanes, no shared memory); vb > 0 stages
// (blocks of vb lanes, smem bytes, raised above the 48 KB default by
// cudaFuncSetAttribute before the launch). Returns the CUDA error.
template <class Kernel>
inline int tile_setup(Kernel kernel, int vb, long long smem) {
  if (vb == 0) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// blocks of one instance resident per SM at this geometry (0 on error)
template <class Kernel>
inline int tile_occupancy(Kernel kernel, int threads, long long smem) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    (size_t)smem) != 0)
    return 0;
  return blocks;
}
#endif

}  // namespace fabber
