// vb_device.cuh: device code shared by the nonlinear VB kernels
// (fused_nl_loop.cu, fused_vb_iter.cu), for Hopper (sm_90a).
//
// The counterpart of what the TPU kernels share in
// fabber_core_tpu/ops/fused_vb.py (make_block_eval: the in-kernel model
// evaluator with the latent->model chain factors) and
// fabber_core_tpu/ops/fused_loop_nl.py (chol_planes_jittered,
// inv_from_chol: the unrolled Cholesky with the jitter retry and the
// inverse from the factor). One thread owns one voxel, so every
// "plane" of the TPU code is a scalar in a register here; P x P
// symmetric matrices are packed lower triangles in row-major order,
// (i, j <= i) at i(i+1)/2 + j, the order of the TPU code's _tri(p).
//
// Model functors give the signal and the model-space Jacobian at one
// 0-based time index t (a float); dt is a runtime argument. NS is the
// number of per-voxel suppdata values a functor reads (eval's supp; 0
// for the hand-written ones, which ignore it; a functor generated from a
// model's evaluate, models/kernelgen.py, may read some):
//   PolyModel<P>   c0 + c1 (t+1) + ... + c_{P-1} (t+1)^{P-1}
//                  (models/poly.py: samples indexed from 1)
//   ExpSum<NEXP>   sum_i a_i exp(-r_i t dt), parameters (a_1, r_1, ...)
//                  (models/exp.py)
// Transcendentals are expf/logf/log1pf at full accuracy (no
// --use_fast_math): biexp's rate Jacobian -t a e amplifies exp error.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tile.cuh"

// Every (model functor, P, Q) both nonlinear kernels are compiled for,
// as X(kind, P, functor, Q); kind 0 = PolyModel, 1 = ExpSum (the
// KERNEL_POLY / KERNEL_EXP codes of models/base.py). This list is the
// one source of the C entry points' dispatch and of
// fabber_nl_has_instance, which the engine's route gate asks.
#define FABBER_NL_INSTANCES(X)                                        \
  X(1, 2, ExpSum<1>, 1) X(1, 2, ExpSum<1>, 2) X(1, 2, ExpSum<1>, 3)   \
  X(1, 2, ExpSum<1>, 4) X(1, 4, ExpSum<2>, 1) X(1, 4, ExpSum<2>, 2)   \
  X(1, 4, ExpSum<2>, 3) X(1, 4, ExpSum<2>, 4)                         \
  X(0, 1, PolyModel<1>, 1) X(0, 1, PolyModel<1>, 2)                   \
  X(0, 2, PolyModel<2>, 1) X(0, 2, PolyModel<2>, 2)                   \
  X(0, 3, PolyModel<3>, 1) X(0, 3, PolyModel<3>, 2)                   \
  X(0, 4, PolyModel<4>, 1) X(0, 4, PolyModel<4>, 2)

namespace fabber {

// largest P of FABBER_NL_INSTANCES, and of a generated functor: the
// engine refuses a larger model on the card at construction
constexpr int kMaxP = 4;
constexpr int kMaxQ = 4;   // largest Q of FABBER_NL_INSTANCES
// samples per block of the two-level time sums: each pass sums kTB
// samples into block sums and adds the blocks into its totals. One
// float32 accumulator over all T samples loses the accuracy the TPU
// kernel's [TB,B] partial planes keep, and on biexp that moves ~7% of
// voxels into a worse basin in ten iterations.
constexpr int kTB = 8;

__host__ __device__ constexpr int tri(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// transform codes (ops/fused_vb.py TRANSFORM_CODES)
enum TransformCode : int {
  kIdentity = 0, kLog = 1, kSoftplus = 2, kFractional = 3, kAbs = 4
};

// latent -> model value (core/transforms.py to_model)
__device__ __forceinline__ float to_model(int code, float x) {
  switch (code) {
    case kLog: return expf(x);
    case kSoftplus: return x < 10.f ? log1pf(expf(fminf(x, 10.f))) : x;
    case kFractional: return 1.f / (1.f + expf(x));
    case kAbs: return fabsf(x);
    default: return x;
  }
}

// d to_model / d latent, as jax.jvp of the JAX transforms gives it:
// softplus is exactly 1 for x >= 10, abs has slope +1 at 0 (jax's abs
// rule selects on x >= 0)
__device__ __forceinline__ float chain_factor(int code, float x) {
  switch (code) {
    case kLog: return expf(x);
    case kSoftplus: {
      if (!(x < 10.f)) return 1.f;
      const float e = expf(x);
      return e / (1.f + e);
    }
    case kFractional: {
      const float e = expf(x);
      const float u = 1.f + e;
      return -e / (u * u);
    }
    case kAbs: return x >= 0.f ? 1.f : -1.f;
    default: return 1.f;
  }
}

template <int NP>
struct PolyModel {
  static constexpr int P = NP;
  static constexpr int NS = 0;
  __device__ __forceinline__ static float eval(const float* m,
                                               const float* /*supp*/,
                                               float t, float dt,
                                               float* jac) {
    return eval(m, t, dt, jac);
  }
  __device__ __forceinline__ static float eval(const float* m, float t,
                                               float /*dt*/, float* jac) {
    const float tv = t + 1.f;
    float sig = m[0];
    jac[0] = 1.f;
    float power = tv;
#pragma unroll
    for (int i = 1; i < P; ++i) {
      sig = sig + m[i] * power;
      jac[i] = power;
      power = power * tv;
    }
    return sig;
  }
};

template <int NEXP>
struct ExpSum {
  static constexpr int P = 2 * NEXP;
  static constexpr int NS = 0;
  __device__ __forceinline__ static float eval(const float* m,
                                               const float* /*supp*/,
                                               float t, float dt,
                                               float* jac) {
    return eval(m, t, dt, jac);
  }
  __device__ __forceinline__ static float eval(const float* m, float t,
                                               float dt, float* jac) {
    const float tv = t * dt;
    float sig = 0.f;
#pragma unroll
    for (int i = 0; i < NEXP; ++i) {
      const float e = expf(-m[2 * i + 1] * tv);
      const float term = m[2 * i] * e;
      sig = i == 0 ? term : sig + term;
      jac[2 * i] = e;
      jac[2 * i + 1] = -tv * term;
    }
    return sig;
  }
};

// The model at one time index: signal, latent-space Jacobian
// (model-space Jacobian times the hoisted chain factors).
template <class M>
__device__ __forceinline__ float eval_latent(const float* mrow,
                                             const float* chain, float t,
                                             float dt, float* jac) {
  const float sig = M::eval(mrow, t, dt, jac);
#pragma unroll
  for (int i = 0; i < M::P; ++i) jac[i] *= chain[i];
  return sig;
}

// the same with the voxel's suppdata (the whole-loop kernel's functors)
template <class M>
__device__ __forceinline__ float eval_latent(const float* mrow,
                                             const float* chain,
                                             const float* supp, float t,
                                             float dt, float* jac) {
  const float sig = M::eval(mrow, supp, t, dt, jac);
#pragma unroll
  for (int i = 0; i < M::P; ++i) jac[i] *= chain[i];
  return sig;
}

// model-space rows and chain factors at latent means (time-independent,
// hoisted out of the time loops)
template <int P>
__device__ __forceinline__ void model_rows(const int* tcode,
                                           const float* latent, float* mrow,
                                           float* chain) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    mrow[i] = to_model(tcode[i], latent[i]);
    chain[i] = chain_factor(tcode[i], latent[i]);
  }
}

// Unrolled Cholesky of the packed symmetric a (+jit on the diagonal)
// into the packed lower factor ch.
template <int P>
__device__ __forceinline__ void cholesky(const float* a, float jit,
                                         float* ch) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = a[tri(i, i)] + jit;
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - ch[tri(i, k)] * ch[tri(i, k)];
    ch[tri(i, i)] = sqrtf(s);
    const float inv_d = 1.f / ch[tri(i, i)];
#pragma unroll
    for (int j = i + 1; j < P; ++j) {
      float s2 = a[tri(j, i)];
#pragma unroll
      for (int k = 0; k < i; ++k) s2 = s2 - ch[tri(j, k)] * ch[tri(i, k)];
      ch[tri(j, i)] = s2 * inv_d;
    }
  }
}

// The jitter retry of ops/smallmat.cholesky_jittered: a voxel whose
// plain factor has a non-finite diagonal refactorizes with +1e-10.
template <int P>
__device__ __forceinline__ void cholesky_jittered(const float* a,
                                                  float* ch) {
  cholesky<P>(a, 0.f, ch);
  bool bad = false;
#pragma unroll
  for (int i = 0; i < P; ++i) bad = bad || !isfinite(ch[tri(i, i)]);
  if (bad) cholesky<P>(a, 1e-10f, ch);
}

// A^-1 = L^-T L^-1 from the packed factor, into packed cov.
template <int P>
__device__ __forceinline__ void inverse_from_chol(const float* ch,
                                                  float* cov) {
  float invl[P * (P + 1) / 2];
#pragma unroll
  for (int i = 0; i < P; ++i) invl[tri(i, i)] = 1.f / ch[tri(i, i)];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = i - 1; j >= 0; --j) {
      float s = 0.f;
#pragma unroll
      for (int k = j + 1; k <= i; ++k) s = s + ch[tri(k, j)] * invl[tri(i, k)];
      invl[tri(i, j)] = -s / ch[tri(j, j)];
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

// Solve L L' x = b in place (b -> x) for the packed lower factor L:
// forward, then back substitution.
template <int P>
__device__ __forceinline__ void chol_solve(const float* ch, float* b) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - ch[tri(i, k)] * b[k];
    b[i] = s / ch[tri(i, i)];
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s = s - ch[tri(k, i)] * b[k];
    b[i] = s / ch[tri(i, i)];
  }
}

// Eq 19/20 from the per-group quadratics (packed jtj[Q][tri], jtr[Q][P]):
// prec = sum_q phi_q J'Q_qJ + diag(pp); cov; means = cov rhs with
// rhs = sum_q phi_q (J'Q_q r + J'Q_qJ centre) + pp pm. ch receives the
// packed Cholesky factor of prec.
template <int P, int Q, bool JITTER>
__device__ __forceinline__ void posterior_solve(
    const float (&jtj)[Q][P * (P + 1) / 2], const float (&jtr)[Q][P],
    const float* phi, const float* centre, const float* pm, const float* pp,
    float* prec, float* cov, float* means, float* ch) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) v = v + phi[q] * jtj[q][tri(i, j)];
      if (i == j) v = v + pp[i];
      prec[tri(i, j)] = v;
    }
  }
  if (JITTER) {
    cholesky_jittered<P>(prec, ch);
  } else {
    cholesky<P>(prec, 0.f, ch);
  }
  inverse_from_chol<P>(ch, cov);
  float rhs[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float g = jtr[q][a];
#pragma unroll
      for (int j = 0; j < P; ++j) g = g + jtj[q][tri(a, j)] * centre[j];
      v = v + phi[q] * g;
    }
    rhs[a] = v + pp[a] * pm[a];
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) m = m + cov[tri(i, j)] * rhs[j];
    means[i] = m;
  }
}

// tr(Sigma G) for packed symmetric Sigma and G (full double sum, as the
// TPU code)
template <int P>
__device__ __forceinline__ float trace_packed(const float* cov,
                                              const float* g) {
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) tr = tr + cov[tri(i, j)] * g[tri(i, j)];
  }
  return tr;
}

template <int P, int Q>
__device__ __forceinline__ void zero_sums(float (&jtj)[Q][P * (P + 1) / 2],
                                          float (&jtr)[Q][P], float (&s)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    s[q] = 0.f;
#pragma unroll
    for (int i = 0; i < P * (P + 1) / 2; ++i) jtj[q][i] = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) jtr[q][i] = 0.f;
  }
}

template <int P, int Q>
__device__ __forceinline__ void add_sums(
    float (&jtj)[Q][P * (P + 1) / 2], float (&jtr)[Q][P], float (&s)[Q],
    const float (&bjtj)[Q][P * (P + 1) / 2], const float (&bjtr)[Q][P],
    const float (&bs)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    s[q] = s[q] + bs[q];
#pragma unroll
    for (int i = 0; i < P * (P + 1) / 2; ++i) jtj[q][i] = jtj[q][i] + bjtj[q][i];
#pragma unroll
    for (int i = 0; i < P; ++i) jtr[q][i] = jtr[q][i] + bjtr[q][i];
  }
}

// The free energy's per-group quadratics at the given latent means:
// k'Q_qk and tr(Sigma J'Q_qJ), k = y - g(means) (the TPU kernels' pass C),
// the samples and the [T,Q] group weights read through col (tile.cuh).
// supp: the voxel's suppdata (M::NS values; none for NS = 0).
template <class M, int Q, class C>
__device__ __forceinline__ void f_pass(const int* tcode, float dt,
                                       const float* means, const float* cov,
                                       const C& col, int nt, float* fkqk,
                                       float* ftr,
                                       const float* supp = nullptr) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
  float mrow[P], chain[P];
  model_rows<P>(tcode, means, mrow, chain);
  float kqk[Q], jtj[Q][NT], unused[Q][P];
  zero_sums<P, Q>(jtj, unused, kqk);
  for (int t0 = 0; t0 < nt; t0 += kTB) {
    float bkqk[Q], bjtj[Q][NT], bunused[Q][P];
    zero_sums<P, Q>(bjtj, bunused, bkqk);
    const int t1 = min(t0 + kTB, nt);
    for (int t = t0; t < t1; ++t) {
      float jac[P];
      const float sig = eval_latent<M>(mrow, chain, supp, (float)t, dt, jac);
      const float kb = col.sample(t) - sig;
      const float k2 = kb * kb;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float w = col.weight(t * Q + q);
        bkqk[q] = bkqk[q] + w * k2;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float wj = w * jac[i];
#pragma unroll
          for (int j = 0; j <= i; ++j)
            bjtj[q][tri(i, j)] = bjtj[q][tri(i, j)] + wj * jac[j];
        }
      }
    }
    add_sums<P, Q>(jtj, unused, kqk, bjtj, bunused, bkqk);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    fkqk[q] = kqk[q];
    ftr[q] = trace_packed<P>(cov, jtj[q]);
  }
}

// packed symmetric -> full P x P planes [P*P, V]
template <int P>
__device__ __forceinline__ void store_full(const float* packed,
                                           float* __restrict__ out,
                                           long long V, long long v) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      out[(size_t)(i * P + j) * V + v] = packed[tri(i, j)];
  }
}

// Everything a launch passes by value: the per-parameter transform
// codes, dt, the loop controls and the per-group noise constants.
struct VBParams {
  int tcode[kMaxP];
  float dt;
  int n_iters;
  int need_f;
  float locked_sd;        // > 0: noise sd locked to this value
  float inv_b0[kMaxQ];    // 1 / b0 of the noise prior
  float c_post[kMaxQ];    // (n_q - 1)/2 + c0
  float b_init[kMaxQ];
  float c_init[kMaxQ];
  int nt;
  long long V;
};

}  // namespace fabber
