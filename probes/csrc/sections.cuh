// sections.cuh: clock64() marks per section of the cooperative kernels, for
// probes/coop_sections.py. A unit built with -DFABBER_SECTION_CLOCKS (and
// -I probes/csrc) includes this header through csrc/coop_device.cuh, and
// every FABBER_MARK(k) of the package's kernels (device code only) adds
// the cycles since the warp's last mark to section k. Lane 0 of each warp stamps, into per-warp accumulators in
// static shared memory (kSecWarps x (kSecCount + 1) 8-byte words, 800 B a
// block); FABBER_SEC_END adds them to the device totals that
// fabber_sections_read copies out. Without the flag every mark is empty.

#pragma once

constexpr int kSecCount = 24;
constexpr int kSecWarps = 4;

__device__ unsigned long long fabber_sec_cycles[kSecCount];
__shared__ unsigned long long fabber_sec_acc[kSecWarps][kSecCount + 1];

__host__ __device__ __forceinline__ void fabber_sec_begin() {
#if defined(__CUDA_ARCH__)
  const int w = (int)(threadIdx.x >> 5) % kSecWarps;
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < kSecCount; ++k) fabber_sec_acc[w][k] = 0ull;
    fabber_sec_acc[w][kSecCount] = clock64();
  }
#endif
}

__host__ __device__ __forceinline__ void fabber_sec_mark(int k) {
#if defined(__CUDA_ARCH__)
  const int w = (int)(threadIdx.x >> 5) % kSecWarps;
  if ((threadIdx.x & 31) == 0) {
    const unsigned long long t = clock64();
    fabber_sec_acc[w][k] += t - fabber_sec_acc[w][kSecCount];
    fabber_sec_acc[w][kSecCount] = t;
  }
#endif
}

__host__ __device__ __forceinline__ void fabber_sec_end() {
#if defined(__CUDA_ARCH__)
  const int w = (int)(threadIdx.x >> 5) % kSecWarps;
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < kSecCount; ++k)
      atomicAdd(&fabber_sec_cycles[k], fabber_sec_acc[w][k]);
#endif
}

// the totals since the last reset, kSecCount words, into host memory
extern "C" int fabber_sections_read(unsigned long long* host) {
  cudaDeviceSynchronize();
  return (int)cudaMemcpyFromSymbol(host, fabber_sec_cycles,
                                   sizeof(fabber_sec_cycles));
}

extern "C" int fabber_sections_reset() {
  static const unsigned long long zero[kSecCount] = {};
  return (int)cudaMemcpyToSymbol(fabber_sec_cycles, zero, sizeof(zero));
}

#define FABBER_SEC_BEGIN() fabber_sec_begin()
#define FABBER_MARK(k) fabber_sec_mark(k)
#define FABBER_SEC_END() fabber_sec_end()
