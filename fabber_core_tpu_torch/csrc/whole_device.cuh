// whole_device.cuh: the fixed point of fixed-design white-noise VB that
// kernel 4 (fused_whole.cu, statistics from the data) and kernel 5
// (fused_loop.cu, statistics read) share, for Hopper (sm_90a): the (P,
// Q) instance list, the constants a launch passes by value, a lane's
// state and one fixed-point step (fused_loop.py:257-305,
// fused_whole.py:449-553 of the JAX package; plain version
// ops/fused_loop.py fixed_point_step).
//
// A per-shape instance (ops/_cuda.py build_instance compiles
// fused_whole.cu and fused_loop.cu with FABBER_INST_P and FABBER_INST_Q
// defined: P to kWideMaxP, Q to kWideMaxQ, any shape outside
// FABBER_WHOLE_INSTANCES) takes WideConsts: D'Q_qD, Q P^2 floats (4 KB
// at P = 16, Q = 4), stays in a device buffer and is read through the
// read-only cache (every lane of a warp reads the same word), and the
// lane's state is the same template at the larger P, its packed
// matrices in local memory where they outgrow the registers.
//
// Included once per translation unit; its definitions sit in that
// unit's anonymous namespace, so each kernel's mangled name carries its
// own source file's.

#pragma once

#include "detectors.cuh"
#include "vb_device.cuh"

// Every (P, Q) kernels 4 and 5 are compiled for, as X(P, Q); each gives
// kernel 4 in MODEs 0-2 (fused_whole.cu) and kernel 5 (fused_loop.cu).
// This list is the one source of both C entry points' dispatch and of
// fabber_whole_has_instance, which the engine's route gate asks. Q = 3
// stops at P = 5: from P = 6 ptxas spills one of its instances.
#define FABBER_WHOLE_INSTANCES(X)                                   \
  X(1, 1) X(1, 2) X(1, 3) X(2, 1) X(2, 2) X(2, 3) X(3, 1) X(3, 2)   \
  X(3, 3) X(4, 1) X(4, 2) X(4, 3) X(5, 1) X(5, 2) X(5, 3) X(6, 1)   \
  X(6, 2) X(7, 1) X(7, 2) X(8, 1) X(8, 2)

namespace {

using namespace fabber;

constexpr int kWMaxP = 8;   // largest P of FABBER_WHOLE_INSTANCES
constexpr int kWMaxQ = 3;   // largest Q of FABBER_WHOLE_INSTANCES

// Everything a launch passes by value: D'Q_qD ([Q][P][P] row-major at the
// launch's P), the per-group noise constants, the loop controls and, in
// the detector modes, the detector and the ELBO constants.
struct WholeConsts {
  float dtqd[kWMaxQ * kWMaxP * kWMaxP];
  float inv_b0[kWMaxQ];     // 1 / b0 of the noise prior
  float c_post[kWMaxQ];     // (n_q - 1)/2 + c0
  float b_init[kWMaxQ];
  float c_init[kWMaxQ];
  float locked_sd;          // > 0: noise sd locked to this value
  int n_iters;
  int nt;
  long long V;
  DetParams d;
  float lb_coeff[kWMaxQ];   // n_q/2 + c0_q, the coefficient of log b_q
  float f_const;            // voxel-invariant ELBO terms at c_post
};

// A per-shape instance's largest P and Q (the JAX engine's kernel 4
// admits no larger P at any T)
constexpr int kWideMaxP = 20;
constexpr int kWideMaxQ = 4;

// A per-shape instance's launch constants: WholeConsts's, with D'Q_qD
// ([Q][P][P]) in a device buffer.
struct WideConsts {
  DevRows dtqd;
  float inv_b0[kWideMaxQ];
  float c_post[kWideMaxQ];
  float b_init[kWideMaxQ];
  float c_init[kWideMaxQ];
  float locked_sd;
  int n_iters;
  int nt;
  long long V;
  DetParams d;
  float lb_coeff[kWideMaxQ];
  float f_const;
};

#define DTQD(q, i, j) k.dtqd[((q) * P + (i)) * P + (j)]

// The lane's state: posterior (packed prec/cov), noise, and (detector
// modes) the lane's F.
template <int P, int Q>
struct WholeState {
  float means[P];
  float prec[P * (P + 1) / 2];
  float cov[P * (P + 1) / 2];
  float b[Q], c[Q];
  float f;
};

// One fixed-point step from s (its noise, and its means as the lm
// centre) into n; kqk/trq receive the new state's per-group quadratics
// and logdet log det prec (for F). LEAN (kernel 5: maxits, alpha 0, no F)
// takes fewer instructions, in another rounding: the inverse multiplies
// by the diagonal reciprocals where kernel 4 divides, the quadratic and
// trace of the noise update run over the P(P+1)/2 distinct terms with
// dsym [Q][P(P+1)/2] (D_aa, and D_aj + D_ja for j < a), and logdet is
// left unset.
template <int P, int Q, bool LEAN = false, class K>
__device__ __forceinline__ void whole_step(
    const K& k, const float* m0, const float* rtqr,
    const float (&dtqr)[Q][P], const float (&dtqy)[Q][P], const float* pm,
    const float* pp, const WholeState<P, Q>& s, float alpha,
    WholeState<P, Q>& n, float* kqk, float* trq, float& logdet,
    const float* dsym = nullptr) {
  constexpr int NT = P * (P + 1) / 2;
  float phi[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) phi[q] = s.b[q] * s.c[q];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) v = v + phi[q] * DTQD(q, i, j);
      if (i == j) v = v + pp[i];
      n.prec[tri(i, j)] = v;
    }
  }
  float ch[NT];
  cholesky_jittered<P>(n.prec, ch);
  inverse_from_chol<P, LEAN>(ch, n.cov);
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
    for (int j = 0; j < P; ++j) m = m + n.cov[tri(i, j)] * rhs[j];
    n.means[i] = m;
  }
  if (alpha > 0.f) {
    // LM-damped step about the previous means (white.py
    // update_theta_stats); prec and cov stay undamped
    float dc[P], delta[P], damped[NT], dch[NT];
#pragma unroll
    for (int a = 0; a < P; ++a) dc[a] = s.means[a] - m0[a];
#pragma unroll
    for (int a = 0; a < P; ++a) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float g = dtqr[q][a];
#pragma unroll
        for (int j = 0; j < P; ++j) g = g - DTQD(q, a, j) * dc[j];
        v = v + phi[q] * g;
      }
      delta[a] = v + pp[a] * pm[a] - pp[a] * s.means[a];
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j)
        damped[tri(i, j)] = n.prec[tri(i, j)] +
                            (i == j ? alpha * n.prec[tri(i, i)] : 0.f);
    }
    cholesky_jittered<P>(damped, dch);
    chol_solve<P>(dch, delta);
#pragma unroll
    for (int a = 0; a < P; ++a) n.means[a] = s.means[a] + delta[a];
  }

  float d[P];
#pragma unroll
  for (int a = 0; a < P; ++a) d[a] = n.means[a] - m0[a];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float cross = 0.f, quad = 0.f, tr = 0.f;
#pragma unroll
    for (int a = 0; a < P; ++a) cross = cross + d[a] * dtqr[q][a];
#pragma unroll
    for (int a = 0; a < P; ++a) {
      if constexpr (LEAN) {
#pragma unroll
        for (int j = 0; j <= a; ++j) {
          const float e = dsym[q * NT + tri(a, j)];
          quad = quad + e * d[a] * d[j];
          tr = tr + e * n.cov[tri(a, j)];
        }
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float daj = DTQD(q, a, j);
          quad = quad + daj * d[a] * d[j];
          tr = tr + daj * n.cov[tri(a, j)];
        }
      }
    }
    const float kq = fmaxf(rtqr[q] - 2.f * cross + quad, 0.f);
    float bq = 1.f / ((kq + tr) * 0.5f + k.inv_b0[q]);
    const float cq = k.c_post[q];
    if (k.locked_sd > 0.f) bq = 1.f / cq / (k.locked_sd * k.locked_sd);
    n.b[q] = bq;
    n.c[q] = cq;
    kqk[q] = kq;
    trq[q] = tr;
  }
  if constexpr (!LEAN) {
    float ld = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) ld = ld + 2.f * logf(ch[tri(i, i)]);
    logdet = ld;
  }
}

// the scalar constants of a launch: consts_host [Q*P*P + 4Q] (D'Q_qD,
// then 1/b0, c_post, b_init, c_init per group)
WholeConsts make_consts(int p, int q, int n_iters, float locked_sd,
                        const float* consts_host, int nt, long long V) {
  WholeConsts k = {};
  const int n = q * p * p;
  for (int i = 0; i < n; ++i) k.dtqd[i] = consts_host[i];
  for (int i = 0; i < q; ++i) {
    k.inv_b0[i] = consts_host[n + i];
    k.c_post[i] = consts_host[n + q + i];
    k.b_init[i] = consts_host[n + 2 * q + i];
    k.c_init[i] = consts_host[n + 3 * q + i];
  }
  k.locked_sd = locked_sd;
  k.n_iters = n_iters;
  k.nt = nt;
  k.V = V;
  k.d = {kMaxits, 0.f, 0, 0, 0};
  return k;
}

// make_consts for a per-shape instance: dtqd_dev holds consts_host's
// first q*p*p floats on the device
WideConsts make_wide_consts(int q, int n_iters, float locked_sd,
                            const float* consts_host, const float* dtqd_dev,
                            int n, int nt, long long V) {
  WideConsts k = {};
  k.dtqd = DevRows{dtqd_dev};
  for (int i = 0; i < q; ++i) {
    k.inv_b0[i] = consts_host[n + i];
    k.c_post[i] = consts_host[n + q + i];
    k.b_init[i] = consts_host[n + 2 * q + i];
    k.c_init[i] = consts_host[n + 3 * q + i];
  }
  k.locked_sd = locked_sd;
  k.n_iters = n_iters;
  k.nt = nt;
  k.V = V;
  k.d = {kMaxits, 0.f, 0, 0, 0};
  return k;
}

}  // namespace
