// coop_device.cuh: the pieces of the cooperative kernels, for Hopper
// (sm_90a): one voxel a block of kCoopThreads threads (a warp), its state
// in the block's shared memory, the threads meeting at __syncthreads only
// (no warp shuffles, so the host build in tests/torch_hostcc.py runs a
// block's threads as host threads).
//
// Shared by kernel 7's cooperative form (fused_vb_iter.cuh
// fused_vb_iter_coop_kernel, past ops/_cuda.py rolled_loops' sizes) and
// kernel 6's full-time form (fused_nl_loop.cuh fused_nl_loop_full_kernel,
// a functor generated from a model that mixes time): the per-group sums
// over a chunk of kCoopChunk samples (coop_sums, coop_kqk), the column
// Cholesky (with kernel 6's jitter retry), the inverse from the factor,
// the traces and the stores. Each entry's arithmetic is vb_device.cuh's
// (cholesky, inverse_from_chol, trace_packed), a thread an entry.

#pragma once

#include "vb_device.cuh"

namespace {

using namespace fabber;

constexpr int kCoopThreads = 32;
constexpr int kCoopChunk = kCoopThreads;   // samples per chunk, one a thread
static_assert(kCoopChunk % kTB == 0, "chunks of whole time blocks");
// (i, j <= i) of the packed index e
__device__ __forceinline__ void untri(int e, int& i, int& j) {
  i = (int)((sqrtf(8.f * (float)e + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > e) --i;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

// each thread's slice of ns packed sums [ns][NT] (and, with rvec, of the
// [ns][P] sums J'W r) over the chunk, weights wts[ns][kCoopChunk]: kTB
// samples into a block sum, the blocks into the total
template <int P>
__device__ __forceinline__ void coop_sums(float* sums, float* rvec, int ns,
                                          const float* jac,
                                          const float* wts,
                                          const float* res, int nc) {
  constexpr int NT = P * (P + 1) / 2, JS = kCoopChunk + 1;
  for (int e = (int)threadIdx.x; e < ns * NT; e += kCoopThreads) {
    const int s = e / NT;
    int i, j;
    untri(e - s * NT, i, j);
    const float* w = wts + s * kCoopChunk;
    float tot = sums[e];
    for (int b0 = 0; b0 < nc; b0 += kTB) {
      const int b1 = min(b0 + kTB, nc);
      float bs = 0.f;
      for (int c = b0; c < b1; ++c) {
        const float wj = w[c] * jac[i * JS + c];
        bs = bs + wj * jac[j * JS + c];
      }
      tot = tot + bs;
    }
    sums[e] = tot;
  }
  if (rvec != nullptr) {
    for (int e = (int)threadIdx.x; e < ns * P; e += kCoopThreads) {
      const int s = e / P, i = e - s * P;
      const float* w = wts + s * kCoopChunk;
      float tot = rvec[e];
      for (int b0 = 0; b0 < nc; b0 += kTB) {
        const int b1 = min(b0 + kTB, nc);
        float bs = 0.f;
        for (int c = b0; c < b1; ++c) {
          const float wj = w[c] * jac[i * JS + c];
          bs = bs + wj * res[c];
        }
        tot = tot + bs;
      }
      rvec[e] = tot;
    }
  }
  __syncthreads();
}

// per group k'Q_qk over the chunk (res holds k^2), a thread a group
template <int Q>
__device__ __forceinline__ void coop_kqk(float* kqk,
                                         const float* __restrict__ qw,
                                         const float* res, int t0, int nc) {
  for (int q = (int)threadIdx.x; q < Q; q += kCoopThreads) {
    float tot = kqk[q];
    for (int b0 = 0; b0 < nc; b0 += kTB) {
      const int b1 = min(b0 + kTB, nc);
      float bk = 0.f;
      for (int c = b0; c < b1; ++c)
        bk = bk + __ldg(qw + (t0 + c) * Q + q) * res[c];
      tot = tot + bk;
    }
    kqk[q] = tot;
  }
  __syncthreads();
}

__device__ __forceinline__ void coop_zero(float* x, int n) {
  for (int e = (int)threadIdx.x; e < n; e += kCoopThreads) x[e] = 0.f;
  __syncthreads();
}

// the packed lower factor ch of a (+jit on the diagonal where JITTER),
// vb_device.cuh cholesky's arithmetic: column i's diagonal by thread 0,
// its rows below a thread each
template <int P, bool JITTER = false>
__device__ __forceinline__ void coop_cholesky(const float* a, float* ch,
                                              float jit = 0.f) {
  const int tid = (int)threadIdx.x;
  for (int i = 0; i < P; ++i) {
    if (tid == 0) {
      float s = a[tri(i, i)];
      if constexpr (JITTER) s = s + jit;
      for (int k = 0; k < i; ++k) s = s - ch[tri(i, k)] * ch[tri(i, k)];
      ch[tri(i, i)] = sqrtf(s);
    }
    __syncthreads();
    const float inv_d = 1.f / ch[tri(i, i)];
    for (int j = i + 1 + tid; j < P; j += kCoopThreads) {
      float s2 = a[tri(j, i)];
      for (int k = 0; k < i; ++k) s2 = s2 - ch[tri(j, k)] * ch[tri(i, k)];
      ch[tri(j, i)] = s2 * inv_d;
    }
    __syncthreads();
  }
}

// vb_device.cuh cholesky_jittered's retry: a factor with a non-finite
// diagonal is taken again with +1e-10 (every thread reads the diagonal
// after the barrier, so all take the same branch)
template <int P>
__device__ __forceinline__ void coop_cholesky_jittered(const float* a,
                                                       float* ch) {
  coop_cholesky<P, true>(a, ch, 0.f);
  bool bad = false;
  for (int i = 0; i < P; ++i) bad = bad || !isfinite(ch[tri(i, i)]);
  __syncthreads();
  if (bad) coop_cholesky<P, true>(a, ch, 1e-10f);
}

// cov = L^-T L^-1 from the packed factor, inverse_from_chol's arithmetic:
// L^-1 (into inv) a row a thread, cov an entry a thread
template <int P>
__device__ __forceinline__ void coop_inverse(const float* ch, float* inv,
                                             float* cov) {
  constexpr int NT = P * (P + 1) / 2;
  const int tid = (int)threadIdx.x;
  for (int i = tid; i < P; i += kCoopThreads) {
    inv[tri(i, i)] = 1.f / ch[tri(i, i)];
    for (int j = i - 1; j >= 0; --j) {
      float s = 0.f;
      for (int k = j + 1; k <= i; ++k) s = s + ch[tri(k, j)] * inv[tri(i, k)];
      inv[tri(i, j)] = -s / ch[tri(j, j)];
    }
  }
  __syncthreads();
  for (int e = tid; e < NT; e += kCoopThreads) {
    int i, j;
    untri(e, i, j);
    float s = 0.f;
    for (int k = i; k < P; ++k) s = s + inv[tri(k, i)] * inv[tri(k, j)];
    cov[e] = s;
  }
  __syncthreads();
}

// tr(Sigma J'Q_qJ) of the groups' sums [Q][NT] (trace_packed's order), a
// thread a group
template <int P, int Q>
__device__ __forceinline__ void coop_traces(const float* cov,
                                            const float* sums, float* tr) {
  constexpr int NT = P * (P + 1) / 2;
  for (int q = (int)threadIdx.x; q < Q; q += kCoopThreads)
    tr[q] = trace_packed<P>(cov, sums + q * NT);
  __syncthreads();
}

// packed symmetric -> full P x P planes [P*P, V], an entry a thread
template <int P>
__device__ __forceinline__ void coop_store_full(const float* packed,
                                                float* __restrict__ out,
                                                long long V, long long v) {
  for (int e = (int)threadIdx.x; e < P * P; e += kCoopThreads)
    out[(size_t)e * V + v] = packed[tri(e / P, e % P)];
}

}  // namespace
