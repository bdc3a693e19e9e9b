// A patched copy of csrc/fused_loop.cu (kernel 5) for
// probes/loop_kernel5.py. Its default build computes what the parent's
// kernel 5 computed (fused_whole.cu with STATS_IN, whole_device.cuh
// whole_step without LEAN), bit for bit; the flags build the
// measurements and the candidate steps of PERF.md row 5:
//
//   -DFABBER_LOOP_IO_ONLY   the same reads and writes with the loop cut:
//                           every output a sum of the voxel's inputs
//   -DFABBER_LOOP_WRAP=M    voxel v reads and writes voxel v & M (M + 1 a
//                           power of two): the whole grid's steps on a
//                           plane that stays in the 50 MB L2
//   -DFABBER_LOOP_CUT=mask  the step with fewer instructions:
//                           1  each diagonal reciprocal 1/L_ii computed
//                              once, in the Cholesky, and reused by the
//                              inverse (the same values, bit for bit)
//                           2  the inverse's divisions by L_jj as
//                              products with 1/L_jj (rounding moves)
//                           4  k'Q_qk's quadratic and tr(Sigma D'Q_qD)
//                              over the P(P+1)/2 distinct terms, with
//                              D_aj + D_ja taken once before the loop
//                              (rounding moves)
//                           8  L_ii = s rsqrtf(s) and 1/L_ii = rsqrtf(s),
//                              MUFU.RSQ's approximation in place of the
//                              IEEE square root and reciprocal, the
//                              inverse's products by it (with 2)
//                           7 is csrc/fused_loop.cu's kernel (the LEAN
//                           step), bit for bit
//
// fabber_loop_set_smem(bytes) makes every later launch take that much
// unused dynamic shared memory (the occupancy sweep's cap), and
// fabber_loop_occupancy(p, q) gives the blocks per SM of the instance at
// that setting. fabber_fused_vb_loop keeps csrc/fused_loop.cu's
// arguments, so the port's wrapper launches this build
// (probes/variants.py swap).

#include "whole_device.cuh"

#ifndef FABBER_LOOP_CUT
#define FABBER_LOOP_CUT 0
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kCut = FABBER_LOOP_CUT;
int g_smem = 0;   // unused dynamic shared memory of a launch

// vb_device.cuh cholesky that also keeps rd[i] = 1 / L_ii (cut 1)
template <int P>
__device__ __forceinline__ void cholesky_rd(const float* a, float jit,
                                            float* ch, float* rd) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = a[tri(i, i)] + jit;
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - ch[tri(i, k)] * ch[tri(i, k)];
    ch[tri(i, i)] = sqrtf(s);
    rd[i] = 1.f / ch[tri(i, i)];
#pragma unroll
    for (int j = i + 1; j < P; ++j) {
      float s2 = a[tri(j, i)];
#pragma unroll
      for (int k = 0; k < i; ++k) s2 = s2 - ch[tri(j, k)] * ch[tri(i, k)];
      ch[tri(j, i)] = s2 * rd[i];
    }
  }
}

template <int P>
__device__ __forceinline__ void cholesky_jittered_rd(const float* a,
                                                     float* ch, float* rd) {
  cholesky_rd<P>(a, 0.f, ch, rd);
  bool bad = false;
#pragma unroll
  for (int i = 0; i < P; ++i) bad = bad || !isfinite(ch[tri(i, i)]);
  if (bad) cholesky_rd<P>(a, 1e-10f, ch, rd);
}

// cholesky_jittered_rd with L_ii = s rsqrtf(s) and rd[i] = rsqrtf(s)
// (cut 8)
template <int P>
__device__ __forceinline__ void cholesky_rsq(const float* a, float jit,
                                             float* ch, float* rd) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = a[tri(i, i)] + jit;
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - ch[tri(i, k)] * ch[tri(i, k)];
    rd[i] = rsqrtf(s);
    ch[tri(i, i)] = s * rd[i];
#pragma unroll
    for (int j = i + 1; j < P; ++j) {
      float s2 = a[tri(j, i)];
#pragma unroll
      for (int k = 0; k < i; ++k) s2 = s2 - ch[tri(j, k)] * ch[tri(i, k)];
      ch[tri(j, i)] = s2 * rd[i];
    }
  }
}

template <int P>
__device__ __forceinline__ void cholesky_jittered_rsq(const float* a,
                                                      float* ch, float* rd) {
  cholesky_rsq<P>(a, 0.f, ch, rd);
  bool bad = false;
#pragma unroll
  for (int i = 0; i < P; ++i) bad = bad || !isfinite(ch[tri(i, i)]);
  if (bad) cholesky_rsq<P>(a, 1e-10f, ch, rd);
}

// vb_device.cuh inverse_from_chol from the factor and its diagonal
// reciprocals rd: divisions by L_jj (cut 1) or products with rd (cut 8)
template <int P, bool DIV>
__device__ __forceinline__ void inverse_from_chol_rd(const float* ch,
                                                     const float* rd,
                                                     float* cov) {
  float invl[P * (P + 1) / 2];
#pragma unroll
  for (int i = 0; i < P; ++i) invl[tri(i, i)] = rd[i];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = i - 1; j >= 0; --j) {
      float s = 0.f;
#pragma unroll
      for (int k = j + 1; k <= i; ++k) s = s + ch[tri(k, j)] * invl[tri(i, k)];
      invl[tri(i, j)] = DIV ? -s / ch[tri(j, j)] : -s * rd[j];
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = i; k < P; ++k) s = s + invl[tri(k, i)] * invl[tri(k, j)];
      cov[tri(i, j)] = s;
    }
  }
}

// whole_step at alpha 0 without logdet, with the cuts of kCut; dsym:
// D_aa and D_aj + D_ja (a > j) of each group, packed (cut 4).
template <int P, int Q>
__device__ __forceinline__ void loop_step(
    const WholeConsts& k, const float* m0, const float* rtqr,
    const float (&dtqr)[Q][P], const float (&dtqy)[Q][P], const float* pm,
    const float* pp, const float (&dsym)[Q][P * (P + 1) / 2],
    WholeState<P, Q>& st) {
  constexpr int NT = P * (P + 1) / 2;
  float phi[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) phi[q] = st.b[q] * st.c[q];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) v = v + phi[q] * DTQD(q, i, j);
      if (i == j) v = v + pp[i];
      st.prec[tri(i, j)] = v;
    }
  }
  float ch[NT], rd[P];
  if constexpr ((kCut & 8) != 0) {
    cholesky_jittered_rsq<P>(st.prec, ch, rd);
    inverse_from_chol_rd<P, false>(ch, rd, st.cov);
  } else if constexpr ((kCut & 2) != 0) {
    cholesky_jittered<P>(st.prec, ch);
    inverse_from_chol<P, true>(ch, st.cov);
  } else if constexpr ((kCut & 1) != 0) {
    cholesky_jittered_rd<P>(st.prec, ch, rd);
    inverse_from_chol_rd<P, true>(ch, rd, st.cov);
  } else {
    cholesky_jittered<P>(st.prec, ch);
    inverse_from_chol<P>(ch, st.cov);
  }
  float rhs[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) v = v + phi[q] * dtqy[q][a];
    rhs[a] = v + pp[a] * pm[a];
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) m = m + st.cov[tri(i, j)] * rhs[j];
    st.means[i] = m;
  }
  float d[P];
#pragma unroll
  for (int a = 0; a < P; ++a) d[a] = st.means[a] - m0[a];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float cross = 0.f, quad = 0.f, tr = 0.f;
#pragma unroll
    for (int a = 0; a < P; ++a) cross = cross + d[a] * dtqr[q][a];
#pragma unroll
    for (int a = 0; a < P; ++a) {
      if constexpr ((kCut & 4) != 0) {
#pragma unroll
        for (int j = 0; j <= a; ++j) {
          const float e = dsym[q][tri(a, j)];
          quad = quad + e * d[a] * d[j];
          tr = tr + e * st.cov[tri(a, j)];
        }
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float daj = DTQD(q, a, j);
          quad = quad + daj * d[a] * d[j];
          tr = tr + daj * st.cov[tri(a, j)];
        }
      }
    }
    const float kq = fmaxf(rtqr[q] - 2.f * cross + quad, 0.f);
    float bq = 1.f / ((kq + tr) * 0.5f + k.inv_b0[q]);
    const float cq = k.c_post[q];
    if (k.locked_sd > 0.f) bq = 1.f / cq / (k.locked_sd * k.locked_sd);
    st.b[q] = bq;
    st.c[q] = cq;
  }
}

template <int P, int Q>
__global__ void __launch_bounds__(kThreads)
loop_probe_kernel(const WholeConsts k, const float* __restrict__ m0_in,
                  const float* __restrict__ rtqr_in,
                  const float* __restrict__ dtqr_in,
                  const float* __restrict__ pm_in,
                  const float* __restrict__ pp_in,
                  float* __restrict__ means_out, float* __restrict__ prec_out,
                  float* __restrict__ cov_out, float* __restrict__ b_out,
                  float* __restrict__ c_out) {
  constexpr int NT = P * (P + 1) / 2;
  const long long V = k.V;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= V) return;
#if defined(FABBER_LOOP_WRAP)
  const long long v = t & (long long)(FABBER_LOOP_WRAP);
#else
  const long long v = t;
#endif

  float m0[P], rtqr[Q], dtqr[Q][P], pm[P], pp[P];
#pragma unroll
  for (int a = 0; a < P; ++a) m0[a] = m0_in[(size_t)a * V + v];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    rtqr[q] = rtqr_in[(size_t)q * V + v];
#pragma unroll
    for (int a = 0; a < P; ++a)
      dtqr[q][a] = dtqr_in[(size_t)(q * P + a) * V + v];
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    pm[i] = pm_in[(size_t)i * V + v];
    pp[i] = pp_in[(size_t)i * V + v];
  }
  WholeState<P, Q> st;
#if defined(FABBER_LOOP_IO_ONLY)
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < P; ++a) s = s + m0[a] + pm[a] + pp[a];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    s = s + rtqr[q];
#pragma unroll
    for (int a = 0; a < P; ++a) s = s + dtqr[q][a];
  }
#pragma unroll
  for (int i = 0; i < P; ++i) st.means[i] = s + (float)i;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    st.prec[i] = s * (float)(i + 1);
    st.cov[i] = s - (float)i;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    st.b[q] = 2.f * s;
    st.c[q] = s + (float)q;
  }
#else
  float dtqy[Q][P], dsym[Q][NT];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int a = 0; a < P; ++a) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) s = s + DTQD(q, a, j) * m0[j];
      dtqy[q][a] = dtqr[q][a] + s;
#pragma unroll
      for (int j = 0; j <= a; ++j)
        dsym[q][tri(a, j)] = a == j ? DTQD(q, a, a)
                                    : DTQD(q, a, j) + DTQD(q, j, a);
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) st.means[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NT; ++i) st.prec[i] = st.cov[i] = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    st.b[q] = k.b_init[q];
    st.c[q] = k.c_init[q];
  }
  for (int it = 0; it < k.n_iters; ++it)
    loop_step<P, Q>(k, m0, rtqr, dtqr, dtqy, pm, pp, dsym, st);
#endif

#pragma unroll
  for (int i = 0; i < P; ++i) means_out[(size_t)i * V + v] = st.means[i];
  store_full<P>(st.prec, prec_out, V, v);
  store_full<P>(st.cov, cov_out, V, v);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    b_out[(size_t)q * V + v] = st.b[q];
    c_out[(size_t)q * V + v] = st.c[q];
  }
}

template <int P, int Q>
int launch_probe(const WholeConsts& k, const float* const* ins,
                 float* const* outs, cudaStream_t stream, int* occ) {
  const auto kernel = loop_probe_kernel<P, Q>;
  if (g_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occ != nullptr) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, kernel, kThreads, g_smem);
    return (int)e;
  }
  const unsigned grid = (unsigned)((k.V + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, g_smem, stream>>>(
      k, ins[0], ins[1], ins[2], ins[3], ins[4], outs[0], outs[1], outs[2],
      outs[3], outs[4]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" void fabber_loop_set_smem(int bytes) { g_smem = bytes; }

extern "C" int fabber_loop_occupancy(int p, int q) {
  WholeConsts k = {};
  int occ = -1;
#define FABBER_OCC(NP, NQ)                                                 \
  if (p == NP && q == NQ)                                                  \
    return launch_probe<NP, NQ>(k, nullptr, nullptr, nullptr, &occ) == 0 \
               ? occ                                                       \
               : -1;
  FABBER_WHOLE_INSTANCES(FABBER_OCC)
#undef FABBER_OCC
  return -1;
}

// csrc/fused_loop.cu's entry point (its arguments and refusals).
extern "C" int fabber_fused_vb_loop(int p, int q, int n_iters,
                                    float locked_sd, const float* consts_host,
                                    const float* m0, const float* rtqr,
                                    const float* dtqr, const float* pm,
                                    const float* pp, long long V,
                                    float* means, float* prec, float* cov,
                                    float* b, float* c, void* stream) {
  if (p < 1 || p > kWMaxP || q < 1 || q > kWMaxQ || n_iters < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  const WholeConsts k =
      make_consts(p, q, n_iters, locked_sd, consts_host, 1, V);
  const float* const ins[5] = {m0, rtqr, dtqr, pm, pp};
  float* const outs[5] = {means, prec, cov, b, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABBER_LAUNCH(NP, NQ) \
  if (p == NP && q == NQ)     \
    return launch_probe<NP, NQ>(k, ins, outs, s, nullptr);
  FABBER_WHOLE_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}
