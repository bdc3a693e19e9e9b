// vb_device.cuh: device code shared by the nonlinear kernels
// (fused_nl_loop.cuh, fused_vb_iter.cuh, fused_nlls.cuh), for Hopper
// (sm_90a).
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

#include <type_traits>

#include "tile.cuh"

// The unroll pragma of the loops over P, Q and the packed triangles of
// this header and the nonlinear kernels. A unit built past ops/_cuda.py
// rolled_loops' sizes (P > 16, or more than 600 per-group sums) defines
// FABBER_ROLL_LOOPS and rolls them: a lane's packed state then lives in
// local memory, indexed by the loop counters, and nvcc's time no longer
// grows as P^3 (a fully unrolled Cholesky, inverse and rebuild at P = 40
// would be tens of thousands of instructions per kernel), at 25-32 times
// the unrolled kernel's time at P = 10. Kernel 7 past those sizes runs its
// cooperative form (fused_vb_iter.cuh) instead.
#if defined(FABBER_ROLL_LOOPS)
#define FABBER_UNROLL _Pragma("unroll 1")
#else
#define FABBER_UNROLL _Pragma("unroll")
#endif

// Every (model functor, P, Q) both nonlinear kernels are compiled for,
// as X(kind, P, functor, Q); kind 0 = PolyModel, 1 = ExpSum (the
// KERNEL_POLY / KERNEL_EXP codes of models/base.py). This list is the
// one source of the C entry points' dispatch and of
// fabber_nl_has_instance, which the engine's route gate asks. Any other
// (functor, P, Q) up to (kWideMaxP, kWideMaxQ; kernel 7 kCoopMaxP) is a
// per-shape instance, built at its route's first launch (ops/_cuda.py
// build_instance "nl").
#define FABBER_NL_INSTANCES(X)                                        \
  X(1, 2, ExpSum<1>, 1) X(1, 2, ExpSum<1>, 2) X(1, 2, ExpSum<1>, 3)   \
  X(1, 2, ExpSum<1>, 4) X(1, 4, ExpSum<2>, 1) X(1, 4, ExpSum<2>, 2)   \
  X(1, 4, ExpSum<2>, 3) X(1, 4, ExpSum<2>, 4)                         \
  X(1, 6, ExpSum<3>, 1) X(1, 6, ExpSum<3>, 2)                         \
  X(1, 8, ExpSum<4>, 1) X(1, 8, ExpSum<4>, 2)                         \
  X(0, 1, PolyModel<1>, 1) X(0, 1, PolyModel<1>, 2)                   \
  X(0, 2, PolyModel<2>, 1) X(0, 2, PolyModel<2>, 2)                   \
  X(0, 3, PolyModel<3>, 1) X(0, 3, PolyModel<3>, 2)                   \
  X(0, 4, PolyModel<4>, 1) X(0, 4, PolyModel<4>, 2)

namespace fabber {

// largest P of FABBER_NL_INSTANCES: the prebuilt entry points take no
// larger model (the host blocks VBParams, NLLSParams have room for no
// more)
constexpr int kMaxP = 8;
constexpr int kMaxQ = 4;   // largest Q of FABBER_NL_INSTANCES
// The largest P and Q of a per-shape instance of kernels 6-8 (ops/_cuda.py
// build_instance "nl", the generated functors past kMaxP, kMaxQ; gen_limits
// and instance_limits read these two lines): P 42 is the JAX engine's
// kernel 8 bound (fused_nlls.py pick_nlls_block) and above its kernel 6
// bound (39), Q 35 is a noise pattern's most groups (1-9, A-Z). Kernel 7
// has no JAX picker: its own bound is kCoopMaxP.
// (a namespace of their own: the fixed-design families' sources define
// kWideMaxP, kWideMaxQ of theirs beside `using namespace fabber`)
namespace nl {
constexpr int kWideMaxP = 42;
constexpr int kWideMaxQ = 35;
// kernel 7's own bound (its cooperative form, fused_vb_iter.cuh
// CoopLayout; the JAX engine has no picker for it): the largest P whose
// folded state at kWideMaxQ groups one block's shared memory holds. The
// functors generated for kernel 7 share it.
constexpr int kCoopMaxP = 143;
}  // namespace nl
// samples per block of the two-level time sums: each pass sums kTB
// samples into block sums and adds the blocks into its totals. One
// float32 accumulator over all T samples loses the accuracy the TPU
// kernel's [TB,B] partial planes keep, and on biexp that moves ~7% of
// voxels into a worse basin in ten iterations.
constexpr int kTB = 8;

// A per-shape instance's constants in a device buffer (kernels 4, 5 and
// 9 past their instance lists), read through the read-only cache: every
// lane of a warp reads the same word.
struct DevRows {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const {
    return __ldg(p + i);
  }
};

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
FABBER_UNROLL
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
FABBER_UNROLL
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
// (model-space Jacobian times the hoisted chain factors), with the
// voxel's suppdata supp (M::NS values; the kernels whose functors read
// none pass null).
template <class M>
__device__ __forceinline__ float eval_latent(const float* mrow,
                                             const float* chain,
                                             const float* supp, float t,
                                             float dt, float* jac) {
  const float sig = M::eval(mrow, supp, t, dt, jac);
FABBER_UNROLL
  for (int i = 0; i < M::P; ++i) jac[i] *= chain[i];
  return sig;
}

// model-space rows and chain factors at latent means (time-independent,
// hoisted out of the time loops)
template <int P>
__device__ __forceinline__ void model_rows(const int* tcode,
                                           const float* latent, float* mrow,
                                           float* chain) {
FABBER_UNROLL
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
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
    float s = a[tri(i, i)] + jit;
FABBER_UNROLL
    for (int k = 0; k < i; ++k) s = s - ch[tri(i, k)] * ch[tri(i, k)];
    ch[tri(i, i)] = sqrtf(s);
    const float inv_d = 1.f / ch[tri(i, i)];
FABBER_UNROLL
    for (int j = i + 1; j < P; ++j) {
      float s2 = a[tri(j, i)];
FABBER_UNROLL
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
FABBER_UNROLL
  for (int i = 0; i < P; ++i) bad = bad || !isfinite(ch[tri(i, i)]);
  if (bad) cholesky<P>(a, 1e-10f, ch);
}

// A^-1 = L^-T L^-1 from the packed factor, into packed cov (not ch's
// storage). BY_RECIP: each division by L_jj a product with the 1 / L_jj
// already taken (fewer instructions, another rounding; kernel 5's step).
// L^-1 is built in cov's storage and cov in place over it (row i, then
// column j <= i: entry (i, j) reads L^-1 only in rows >= i and columns i
// and j, none written yet), with no local array of its own: optimized by
// the CUDA 12.9 toolkit (nvcc V12.9.86), a unit whose loops are rolled
// (FABBER_ROLL_LOOPS) laid such an array's local-memory slot over the
// caller's factor ch while both were live, and kernel 6 under trialmode
// at P = 10 lost every lane (probes/wide_nl.py --bisect, --repair;
// probes/csrc/inverse_local.cuh keeps that form).
template <int P, bool BY_RECIP = false>
__device__ __forceinline__ void inverse_from_chol(const float* ch,
                                                  float* cov) {
  float* const invl = cov;
FABBER_UNROLL
  for (int i = 0; i < P; ++i) invl[tri(i, i)] = 1.f / ch[tri(i, i)];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
FABBER_UNROLL
    for (int j = i - 1; j >= 0; --j) {
      float s = 0.f;
FABBER_UNROLL
      for (int k = j + 1; k <= i; ++k) s = s + ch[tri(k, j)] * invl[tri(i, k)];
      invl[tri(i, j)] = BY_RECIP ? -s * invl[tri(j, j)] : -s / ch[tri(j, j)];
    }
  }
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
FABBER_UNROLL
    for (int j = 0; j <= i; ++j) {
      float s = 0.f;
FABBER_UNROLL
      for (int k = i; k < P; ++k) s = s + invl[tri(k, i)] * invl[tri(k, j)];
      cov[tri(i, j)] = s;
    }
  }
}

// Solve L L' x = b in place (b -> x) for the packed lower factor L:
// forward, then back substitution.
template <int P>
__device__ __forceinline__ void chol_solve(const float* ch, float* b) {
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
    float s = b[i];
FABBER_UNROLL
    for (int k = 0; k < i; ++k) s = s - ch[tri(i, k)] * b[k];
    b[i] = s / ch[tri(i, i)];
  }
FABBER_UNROLL
  for (int i = P - 1; i >= 0; --i) {
    float s = b[i];
FABBER_UNROLL
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
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
FABBER_UNROLL
    for (int j = 0; j <= i; ++j) {
      float v = 0.f;
FABBER_UNROLL
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
FABBER_UNROLL
  for (int a = 0; a < P; ++a) {
    float v = 0.f;
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) {
      float g = jtr[q][a];
FABBER_UNROLL
      for (int j = 0; j < P; ++j) g = g + jtj[q][tri(a, j)] * centre[j];
      v = v + phi[q] * g;
    }
    rhs[a] = v + pp[a] * pm[a];
  }
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
    float m = 0.f;
FABBER_UNROLL
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
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
FABBER_UNROLL
    for (int j = 0; j < P; ++j) tr = tr + cov[tri(i, j)] * g[tri(i, j)];
  }
  return tr;
}

template <int P, int Q>
__device__ __forceinline__ void zero_sums(float (&jtj)[Q][P * (P + 1) / 2],
                                          float (&jtr)[Q][P], float (&s)[Q]) {
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) {
    s[q] = 0.f;
FABBER_UNROLL
    for (int i = 0; i < P * (P + 1) / 2; ++i) jtj[q][i] = 0.f;
FABBER_UNROLL
    for (int i = 0; i < P; ++i) jtr[q][i] = 0.f;
  }
}

template <int P, int Q>
__device__ __forceinline__ void add_sums(
    float (&jtj)[Q][P * (P + 1) / 2], float (&jtr)[Q][P], float (&s)[Q],
    const float (&bjtj)[Q][P * (P + 1) / 2], const float (&bjtr)[Q][P],
    const float (&bs)[Q]) {
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) {
    s[q] = s[q] + bs[q];
FABBER_UNROLL
    for (int i = 0; i < P * (P + 1) / 2; ++i) jtj[q][i] = jtj[q][i] + bjtj[q][i];
FABBER_UNROLL
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
FABBER_UNROLL
      for (int q = 0; q < Q; ++q) {
        const float w = col.weight(t * Q + q);
        bkqk[q] = bkqk[q] + w * k2;
FABBER_UNROLL
        for (int i = 0; i < P; ++i) {
          const float wj = w * jac[i];
FABBER_UNROLL
          for (int j = 0; j <= i; ++j)
            bjtj[q][tri(i, j)] = bjtj[q][tri(i, j)] + wj * jac[j];
        }
      }
    }
    add_sums<P, Q>(jtj, unused, kqk, bjtj, bunused, bkqk);
  }
FABBER_UNROLL
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
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
FABBER_UNROLL
    for (int j = 0; j < P; ++j)
      out[(size_t)(i * P + j) * V + v] = packed[tri(i, j)];
  }
}

// Everything a launch passes by value: the per-parameter transform
// codes (room for NC), dt, the loop controls and the per-group noise
// constants. The C entry points fill a VBParams (kMaxP codes); an
// instance takes VBParamsFor<P>: at P <= 4 the block of 4 codes the
// instances had when kMaxP was 4, whose type their SASS depends on.
template <int NC, int NQ = kMaxQ>
struct VBParamsN {
  static constexpr int NCODES = NC, NGROUPS = NQ;
  int tcode[NC];
  float dt;
  int n_iters;
  int need_f;
  float locked_sd;        // > 0: noise sd locked to this value
  float inv_b0[NQ];       // 1 / b0 of the noise prior
  float c_post[NQ];       // (n_q - 1)/2 + c0
  float b_init[NQ];
  float c_init[NQ];
  int nt;
  long long V;
};
using VBParams = VBParamsN<kMaxP>;
// the block of a (P, Q) instance: past kMaxP or kMaxQ (a per-shape
// instance) sized to its own shape, 4 (2P + 4Q + 8) bytes at most
// (1,000 at P = 42, Q = 35, well under a launch's 4 KB of parameters)
template <int P, int Q = 1>
using VBParamsFor = VBParamsN<(P <= 4 ? 4 : (P <= kMaxP ? kMaxP : P)),
                              (Q <= kMaxQ ? kMaxQ : Q)>;

// k (a host block with room for P codes and Q groups) as the block of a
// (P, Q) instance (the codes and groups it reads and the rest), on the
// host
template <int P, int Q = 1, class H>
VBParamsFor<P, Q> params_for(const H& k) {
  using N = VBParamsFor<P, Q>;
  static_assert(H::NCODES >= P && H::NGROUPS >= Q, "a block with room");
  N n = {};
  for (int i = 0; i < P; ++i) n.tcode[i] = k.tcode[i];
  n.dt = k.dt;
  n.n_iters = k.n_iters;
  n.need_f = k.need_f;
  n.locked_sd = k.locked_sd;
  constexpr int nq = N::NGROUPS < H::NGROUPS ? N::NGROUPS : H::NGROUPS;
  for (int i = 0; i < nq; ++i) {
    n.inv_b0[i] = k.inv_b0[i];
    n.c_post[i] = k.c_post[i];
    n.b_init[i] = k.b_init[i];
    n.c_init[i] = k.c_init[i];
  }
  n.nt = k.nt;
  n.V = k.V;
  return n;
}

#if defined(FABBER_INST_KIND)
// A per-shape instance's functor (ops/_cuda.py build_instance "nl": the
// unit defines FABBER_INST_KIND, P and Q): kind 0 PolyModel, 1 ExpSum
using InstModel =
    std::conditional_t<FABBER_INST_KIND == 0, PolyModel<FABBER_INST_P>,
                       ExpSum<FABBER_INST_P / 2>>;
#endif

}  // namespace fabber
