// fused_vb_iter.cuh: one white-noise VB iteration of a time-local
// nonlinear model, for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_vb.py
// make_fused_iteration (its pallas_call at line 481), with its LM branch
// (with_lm, fused_vb.py:362-391) as the template flag LM. Plain version:
// fabber_core_tpu_torch/ops/fused_vb.py fused_iteration_plain. The
// engine's per-iteration route launches it once per iteration
// (save-free-energy-history, programmatic continuation,
// engine-kernel=pallas); under the lm detector with the lane's damping
// alpha.
//
// One thread per voxel, state in registers:
//   pass A  model + latent-space Jacobian at the centre; per noise group
//           q, J'Q_qJ (packed lower triangle) and J'Q_q r;
//   solve   prec = sum_q phi_q J'Q_qJ + diag(pp), unrolled Cholesky
//           without the jitter retry (as the TPU kernel), covariance,
//           means; with LM, where alpha > 0, means = centre + x with
//           (Lambda + alpha diag Lambda) x = sum_q phi_q J'Q_q r +
//           pp (pm - centre) (plain Cholesky; prec and cov undamped);
//   pass B  k = r + J (centre - means), per group k'Q_qk, and
//           tr(Sigma J'Q_qJ) for the phi update (assembled in torch);
//   pass C  (need_f) k'Q_qk and tr(Sigma J'Q_qJ) at the new means.
// The TPU kernel stages J and r for pass B in VMEM scratch. Here that
// would be (P+1)*T*4 bytes per voxel (2 KB at biexp, T=100: 64 KB for a
// one-warp block, which would leave three blocks per SM), so pass B
// re-evaluates the model at the centre instead: the same code on the
// same inputs gives the same J and r as pass A, and k is formed
// explicitly, as the plain version (and the TPU kernel) does (the
// expansion r'Qr + 2d'J'Qr + d'J'QJd would cancel in float32 when the
// step is large).
//
// Design for this card (tile.cuh): each pass reads the voxel's data
// column, 2 or 3 reads of 4*T bytes, and at 4,000,000 voxels the 1.6 GB
// plane is 32x the 50 MB L2, so a streamed pass goes to HBM every time
// and each sample waits on one dependent load. The staged form (template
// STAGED) copies the block's [T, VB] tile and the [T, Q] group weights
// into shared memory once with cp.async; passes A, B and C read them
// there, so HBM sees the plane once. ops/_cuda.py tile_plan stages in
// one-warp blocks (VB = 32) where at least five fit an SM (T=100: 13,200
// B, 16 blocks per SM), else the streamed form (blocks of 128, the plane
// in global memory) serves. Each pass is one function for both forms
// (a Column, tile.cuh), so the two forms run the same arithmetic in the
// same order. What bounds the staged form is instruction throughput: per
// sample 2 or 3 model evaluations (NEXP expf each for exp-sum models) and
// Q*(P(P+1)/2 + P + 1) multiply-adds in pass A (biexp at 4,000,000
// voxels on an NVIDIA H100 80GB HBM3, chip_smoke.py phase 5b: 2.70 ms
// staged, 4.28 streamed).
//
// The model is the functor M (vb_device.cuh's contract, with NS = 0: the
// per-iteration route reads no suppdata): a hand-written one of
// FABBER_NL_INSTANCES (fused_vb_iter.cu's entry points), or one generated
// from a model's time_signal (models/kernelgen.py), built into a library
// of its own with this header (ops/_cuda.py build_generated, kernel
// "vb_iter"): the TPU kernel traces any time_signal into its body
// (fused_vb.py:184). Both reach M::eval through eval_latent's suppdata
// form with a null supp, the form kernel 6 calls.

#pragma once

#include "vb_device.cuh"

namespace {

using namespace fabber;

constexpr int kThreads = 128;

// pass A at the centre (model rows mrow, chain factors chain): per group
// J'Q_qJ (packed) and J'Q_q r, r = y - g(centre), samples and [T,Q]
// weights read through col (tile.cuh)
template <class M, int Q, class C>
__device__ __forceinline__ void jac_pass(
    const float* mrow, const float* chain, float dt, const C& col, int nt,
    float (&jtj)[Q][M::P * (M::P + 1) / 2], float (&jtr)[Q][M::P]) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
  float unused[Q];
  zero_sums<P, Q>(jtj, jtr, unused);
  // two-level sums: kTB samples into block sums, blocks into the totals
  for (int t0 = 0; t0 < nt; t0 += kTB) {
    float bjtj[Q][NT], bjtr[Q][P], bunused[Q];
    zero_sums<P, Q>(bjtj, bjtr, bunused);
    const int t1 = min(t0 + kTB, nt);
    for (int t = t0; t < t1; ++t) {
      float jac[P];
      const float sig = eval_latent<M>(mrow, chain, nullptr, (float)t,
                                       dt, jac);
      const float r = col.sample(t) - sig;
FABBER_UNROLL
      for (int q = 0; q < Q; ++q) {
        const float w = col.weight(t * Q + q);
FABBER_UNROLL
        for (int i = 0; i < P; ++i) {
          const float wj = w * jac[i];
FABBER_UNROLL
          for (int j = 0; j <= i; ++j)
            bjtj[q][tri(i, j)] = bjtj[q][tri(i, j)] + wj * jac[j];
          bjtr[q][i] = bjtr[q][i] + wj * r;
        }
      }
    }
    add_sums<P, Q>(jtj, jtr, unused, bjtj, bjtr, bunused);
  }
}

// pass B at the centre: per group k'Q_qk with k = r + J d, d = centre -
// means, formed explicitly (the model re-evaluated as in pass A)
template <class M, int Q, class C>
__device__ __forceinline__ void k_pass(const float* mrow, const float* chain,
                                       float dt, const float* d, const C& col,
                                       int nt, float* nkqk) {
  constexpr int P = M::P;
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) nkqk[q] = 0.f;
  for (int t0 = 0; t0 < nt; t0 += kTB) {
    float bk[Q];
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) bk[q] = 0.f;
    const int t1 = min(t0 + kTB, nt);
    for (int t = t0; t < t1; ++t) {
      float jac[P];
      const float sig = eval_latent<M>(mrow, chain, nullptr, (float)t,
                                       dt, jac);
      float kk = col.sample(t) - sig;
FABBER_UNROLL
      for (int i = 0; i < P; ++i) kk = kk + jac[i] * d[i];
      const float k2 = kk * kk;
FABBER_UNROLL
      for (int q = 0; q < Q; ++q) bk[q] = bk[q] + col.weight(t * Q + q) * k2;
    }
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) nkqk[q] = nkqk[q] + bk[q];
  }
}

// STAGED: the passes read the block's shared tile (tile.cuh)
template <class M, int Q, bool LM, bool STAGED>
__global__ void __launch_bounds__(kThreads)
fused_vb_iter_kernel(const VBParamsFor<M::P, Q> k,
                     const float* __restrict__ centre_in,
                     const float* __restrict__ pm_in,
                     const float* __restrict__ pp_in,
                     const float* __restrict__ phi_in,
                     const float* __restrict__ data,
                     const float* __restrict__ qw,
                     const float* __restrict__ alpha_in,
                     float* __restrict__ means_out,
                     float* __restrict__ prec_out,
                     float* __restrict__ cov_out,
                     float* __restrict__ nkqk_out,
                     float* __restrict__ ntr_out,
                     float* __restrict__ fkqk_out,
                     float* __restrict__ ftr_out) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
  static_assert(M::NS == 0, "kernel 7 reads no suppdata");
  const long long V = k.V;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // every thread of the block takes part in the staging copy and its
  // barrier, those past V included, before any leaves
  const Column<STAGED> col =
      stage_column<STAGED>(data, qw, k.nt, k.nt * Q, V, v);
  if (v >= V) return;

  float centre[P], pm[P], pp[P], phi[Q];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
    centre[i] = centre_in[(size_t)i * V + v];
    pm[i] = pm_in[(size_t)i * V + v];
    pp[i] = pp_in[(size_t)i * V + v];
  }
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) phi[q] = phi_in[(size_t)q * V + v];

  // ---- pass A: J'Q_qJ, J'Q_q r at the centre ----------------------------
  float mrow[P], chain[P];
  model_rows<P>(k.tcode, centre, mrow, chain);
  float jtj[Q][NT], jtr[Q][P];
  jac_pass<M, Q>(mrow, chain, k.dt, col, k.nt, jtj, jtr);

  // ---- solve (Eq 19/20) --------------------------------------------------
  float prec[NT], cov[NT], means[P], ch[NT];
  posterior_solve<P, Q, false>(jtj, jtr, phi, centre, pm, pp, prec, cov,
                               means, ch);
  if constexpr (LM) {
    const float alpha = alpha_in[v];
    if (alpha > 0.f) {
      float damped[NT], dch[NT], x[P];
FABBER_UNROLL
      for (int i = 0; i < P; ++i) {
        float s = 0.f;
FABBER_UNROLL
        for (int q = 0; q < Q; ++q) s = s + phi[q] * jtr[q][i];
        x[i] = s + pp[i] * (pm[i] - centre[i]);
FABBER_UNROLL
        for (int j = 0; j <= i; ++j)
          damped[tri(i, j)] =
              prec[tri(i, j)] + (i == j ? alpha * prec[tri(i, i)] : 0.f);
      }
      cholesky<P>(damped, 0.f, dch);
      chol_solve<P>(dch, x);
FABBER_UNROLL
      for (int i = 0; i < P; ++i) means[i] = centre[i] + x[i];
    }
  }

  // ---- pass B: k = r + J (centre - means) at the centre -----------------
  float d[P];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) d[i] = centre[i] - means[i];
  float nkqk[Q];
  k_pass<M, Q>(mrow, chain, k.dt, d, col, k.nt, nkqk);

FABBER_UNROLL
  for (int i = 0; i < P; ++i) means_out[(size_t)i * V + v] = means[i];
  store_full<P>(prec, prec_out, V, v);
  store_full<P>(cov, cov_out, V, v);

  // ---- pass C: free-energy quadratics at the new means ------------------
  float fkqk[Q], ftr[Q];
  if (k.need_f) {
    f_pass<M, Q>(k.tcode, k.dt, means, cov, col, k.nt, fkqk, ftr);
  } else {
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) fkqk[q] = ftr[q] = 0.f;
  }
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) {
    nkqk_out[(size_t)q * V + v] = nkqk[q];
    ntr_out[(size_t)q * V + v] = trace_packed<P>(cov, jtj[q]);
    fkqk_out[(size_t)q * V + v] = fkqk[q];
    ftr_out[(size_t)q * V + v] = ftr[q];
  }
}

// ---- the folded form: the groups' sums past kFoldSums --------------------
//
// The prebuilt form keeps J'Q_qJ per group, Q P(P+1)/2 floats a lane and
// as many again for the block sums: 253 KB at P = 42, Q = 35, and the card
// reserves a kernel's local memory for every thread an SM could hold
// (2,048), which no card has. Past kFoldSums per-group sums (a per-shape
// instance, ops/_cuda.py build_instance "nl", or a functor generated past
// kMaxP, kMaxQ; iter_folded) the folded form (fused_vb_iter_wide_kernel)
// keeps one P x P sum, with w_t = sum_q phi_q w_tq:
//   pass A  A = sum_t w_t J_t J_t' (= sum_q phi_q J'Q_qJ) and
//           g = sum_t w_t J_t r_t; prec = A + diag(pp), rhs = g + A centre
//           + pp pm, the same Cholesky (no jitter), covariance and means,
//           the LM step from g + pp (pm - centre);
//   pass B  per group k'Q_qk as the prebuilt form;
//   trace   per group, one more pass for J'Q_qJ alone at the centre and
//           its tr(Sigma J'Q_qJ), the prebuilt form's sums and trace;
//   pass C  (need_f) k'Q_qk and, a pass per group, tr(Sigma J'Q_qJ) at
//           the new means.
// A lane keeps O(P^2) floats whatever Q is (about 8 P(P+1)/2: 29 KB at P =
// 42) and makes 3 + 2Q passes for the prebuilt form's 3. Only A and g sum
// in another order (phi inside the time sum; sums of positive terms); the
// traces are the prebuilt form's arithmetic: taken per sample (J' Sigma J)
// they lost every digit to cancellation at P = 24, where the covariance
// of a sum of twelve exponentials holds entries of 1e10 and more.
constexpr int kFoldSums = 1024;

// the (M, Q) instance takes the folded form
template <class M, int Q>
constexpr bool iter_folded = Q * M::P * (M::P + 1) / 2 > kFoldSums;

// pass A of the folded form at the centre: A (packed) and g
template <class M, int Q, class C>
__device__ __forceinline__ void wide_jac_pass(const float* mrow,
                                              const float* chain, float dt,
                                              const float* phi, const C& col,
                                              int nt, float* a, float* g) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
FABBER_UNROLL
  for (int i = 0; i < NT; ++i) a[i] = 0.f;
FABBER_UNROLL
  for (int i = 0; i < P; ++i) g[i] = 0.f;
  for (int t0 = 0; t0 < nt; t0 += kTB) {
    float ba[NT], bg[P];
FABBER_UNROLL
    for (int i = 0; i < NT; ++i) ba[i] = 0.f;
FABBER_UNROLL
    for (int i = 0; i < P; ++i) bg[i] = 0.f;
    const int t1 = min(t0 + kTB, nt);
    for (int t = t0; t < t1; ++t) {
      float jac[P];
      const float sig = eval_latent<M>(mrow, chain, nullptr, (float)t,
                                       dt, jac);
      const float r = col.sample(t) - sig;
      float w = 0.f;
FABBER_UNROLL
      for (int q = 0; q < Q; ++q) w = w + phi[q] * col.weight(t * Q + q);
FABBER_UNROLL
      for (int i = 0; i < P; ++i) {
        const float wj = w * jac[i];
FABBER_UNROLL
        for (int j = 0; j <= i; ++j)
          ba[tri(i, j)] = ba[tri(i, j)] + wj * jac[j];
        bg[i] = bg[i] + wj * r;
      }
    }
FABBER_UNROLL
    for (int i = 0; i < NT; ++i) a[i] = a[i] + ba[i];
FABBER_UNROLL
    for (int i = 0; i < P; ++i) g[i] = g[i] + bg[i];
  }
}

// tr(Sigma J'Q_qJ) of group q at the rows mrow, chain: J'Q_qJ summed in
// the prebuilt form's order (jac_pass, f_pass), then trace_packed
template <class M, int Q, class C>
__device__ __forceinline__ float group_trace(const float* mrow,
                                             const float* chain, float dt,
                                             const float* cov, const C& col,
                                             int nt, int q) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
  float jtj[NT];
FABBER_UNROLL
  for (int i = 0; i < NT; ++i) jtj[i] = 0.f;
  for (int t0 = 0; t0 < nt; t0 += kTB) {
    float bjtj[NT];
FABBER_UNROLL
    for (int i = 0; i < NT; ++i) bjtj[i] = 0.f;
    const int t1 = min(t0 + kTB, nt);
    for (int t = t0; t < t1; ++t) {
      float jac[P];
      eval_latent<M>(mrow, chain, nullptr, (float)t, dt, jac);
      const float w = col.weight(t * Q + q);
FABBER_UNROLL
      for (int i = 0; i < P; ++i) {
        const float wj = w * jac[i];
FABBER_UNROLL
        for (int j = 0; j <= i; ++j)
          bjtj[tri(i, j)] = bjtj[tri(i, j)] + wj * jac[j];
      }
    }
FABBER_UNROLL
    for (int i = 0; i < NT; ++i) jtj[i] = jtj[i] + bjtj[i];
  }
  return trace_packed<P>(cov, jtj);
}

// passes B (STEP: k = r + J d at the centre) and C (k = r at the new
// means) of the folded form: per group k'Q_qk
template <class M, int Q, bool STEP, class C>
__device__ __forceinline__ void wide_k_pass(const float* mrow,
                                            const float* chain, float dt,
                                            const float* d, const C& col,
                                            int nt, float* kqk) {
  constexpr int P = M::P;
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) kqk[q] = 0.f;
  for (int t0 = 0; t0 < nt; t0 += kTB) {
    float bk[Q];
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) bk[q] = 0.f;
    const int t1 = min(t0 + kTB, nt);
    for (int t = t0; t < t1; ++t) {
      float jac[P];
      const float sig = eval_latent<M>(mrow, chain, nullptr, (float)t,
                                       dt, jac);
      float kk = col.sample(t) - sig;
      if constexpr (STEP) {
FABBER_UNROLL
        for (int i = 0; i < P; ++i) kk = kk + jac[i] * d[i];
      }
      const float k2 = kk * kk;
FABBER_UNROLL
      for (int q = 0; q < Q; ++q) bk[q] = bk[q] + col.weight(t * Q + q) * k2;
    }
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) kqk[q] = kqk[q] + bk[q];
  }
}

// The folded form's kernel: fused_vb_iter_kernel's parameters and outputs
template <class M, int Q, bool LM, bool STAGED>
__global__ void __launch_bounds__(kThreads)
fused_vb_iter_wide_kernel(const VBParamsFor<M::P, Q> k,
                          const float* __restrict__ centre_in,
                          const float* __restrict__ pm_in,
                          const float* __restrict__ pp_in,
                          const float* __restrict__ phi_in,
                          const float* __restrict__ data,
                          const float* __restrict__ qw,
                          const float* __restrict__ alpha_in,
                          float* __restrict__ means_out,
                          float* __restrict__ prec_out,
                          float* __restrict__ cov_out,
                          float* __restrict__ nkqk_out,
                          float* __restrict__ ntr_out,
                          float* __restrict__ fkqk_out,
                          float* __restrict__ ftr_out) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
  static_assert(M::NS == 0, "kernel 7 reads no suppdata");
  const long long V = k.V;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const Column<STAGED> col =
      stage_column<STAGED>(data, qw, k.nt, k.nt * Q, V, v);
  if (v >= V) return;

  float centre[P], pm[P], pp[P], phi[Q];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
    centre[i] = centre_in[(size_t)i * V + v];
    pm[i] = pm_in[(size_t)i * V + v];
    pp[i] = pp_in[(size_t)i * V + v];
  }
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) phi[q] = phi_in[(size_t)q * V + v];

  // ---- pass A: A = J'WJ, g = J'W r at the centre ------------------------
  float mrow[P], chain[P];
  model_rows<P>(k.tcode, centre, mrow, chain);
  float a[NT], g[P];
  wide_jac_pass<M, Q>(mrow, chain, k.dt, phi, col, k.nt, a, g);

  // ---- solve (Eq 19/20) --------------------------------------------------
  float prec[NT], cov[NT], means[P], ch[NT];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
FABBER_UNROLL
    for (int j = 0; j <= i; ++j)
      prec[tri(i, j)] = a[tri(i, j)] + (i == j ? pp[i] : 0.f);
  }
  cholesky<P>(prec, 0.f, ch);
  inverse_from_chol<P>(ch, cov);
  float rhs[P];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
    float r = g[i];
FABBER_UNROLL
    for (int j = 0; j < P; ++j) r = r + a[tri(i, j)] * centre[j];
    rhs[i] = r + pp[i] * pm[i];
  }
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
    float m = 0.f;
FABBER_UNROLL
    for (int j = 0; j < P; ++j) m = m + cov[tri(i, j)] * rhs[j];
    means[i] = m;
  }
  if constexpr (LM) {
    const float alpha = alpha_in[v];
    if (alpha > 0.f) {
      float damped[NT], dch[NT], x[P];
FABBER_UNROLL
      for (int i = 0; i < P; ++i) {
        x[i] = g[i] + pp[i] * (pm[i] - centre[i]);
FABBER_UNROLL
        for (int j = 0; j <= i; ++j)
          damped[tri(i, j)] =
              prec[tri(i, j)] + (i == j ? alpha * prec[tri(i, i)] : 0.f);
      }
      cholesky<P>(damped, 0.f, dch);
      chol_solve<P>(dch, x);
FABBER_UNROLL
      for (int i = 0; i < P; ++i) means[i] = centre[i] + x[i];
    }
  }

  // ---- pass B: k = r + J (centre - means) at the centre -----------------
  float d[P];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) d[i] = centre[i] - means[i];
  float nkqk[Q], ntr[Q];
  wide_k_pass<M, Q, true>(mrow, chain, k.dt, d, col, k.nt, nkqk);
  for (int q = 0; q < Q; ++q)
    ntr[q] = group_trace<M, Q>(mrow, chain, k.dt, cov, col, k.nt, q);

FABBER_UNROLL
  for (int i = 0; i < P; ++i) means_out[(size_t)i * V + v] = means[i];
  store_full<P>(prec, prec_out, V, v);
  store_full<P>(cov, cov_out, V, v);

  // ---- pass C: free-energy quadratics at the new means ------------------
  float fkqk[Q], ftr[Q];
  if (k.need_f) {
    model_rows<P>(k.tcode, means, mrow, chain);
    wide_k_pass<M, Q, false>(mrow, chain, k.dt, nullptr, col, k.nt, fkqk);
    for (int q = 0; q < Q; ++q)
      ftr[q] = group_trace<M, Q>(mrow, chain, k.dt, cov, col, k.nt, q);
  } else {
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) fkqk[q] = ftr[q] = 0.f;
  }
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) {
    nkqk_out[(size_t)q * V + v] = nkqk[q];
    ntr_out[(size_t)q * V + v] = ntr[q];
    fkqk_out[(size_t)q * V + v] = fkqk[q];
    ftr_out[(size_t)q * V + v] = ftr[q];
  }
}

// ---- launch ---------------------------------------------------------------

// the dynamic shared memory of vb (0: streamed) at nt samples and Q
// groups, -1 where it is refused (tile.cuh tile_bytes)
inline long long iter_smem(int vb, int nt, int q) {
  return vb == 0 ? 0 : tile_bytes(vb, nt, nt * q, kThreads);
}

// One instance's launch, or (occ not null) its blocks per SM: vb = 0
// streams in blocks of kThreads, vb > 0 stages in blocks of vb lanes with
// smem bytes of dynamic shared memory; past kFoldSums the folded form.
template <class M, int Q, bool LM, bool STAGED, class HK>
int launch_form(const HK& k, int vb, long long smem,
                const float* const* ins, float* const* outs,
                cudaStream_t stream, int* occ) {
  const auto kernel = [] {
    if constexpr (iter_folded<M, Q>)
      return fused_vb_iter_wide_kernel<M, Q, LM, STAGED>;
    else
      return fused_vb_iter_kernel<M, Q, LM, STAGED>;
  }();
  const int threads = STAGED ? vb : kThreads;
  const int err = tile_setup(kernel, STAGED ? vb : 0, smem);
  if (err != 0) return err;
  if (occ != nullptr) {
    *occ = tile_occupancy(kernel, threads, smem);
    return 0;
  }
  const unsigned grid = (unsigned)((k.V + threads - 1) / threads);
  kernel<<<grid, threads, smem, stream>>>(
      params_for<M::P, Q>(k), ins[0], ins[1], ins[2], ins[3], ins[4], ins[5],
      ins[6], outs[0], outs[1], outs[2], outs[3], outs[4], outs[5],
      outs[6]);
  return (int)cudaGetLastError();
}

template <class M, int Q, bool LM, class HK>
int launch_lm(const HK& k, int vb, long long smem,
              const float* const* ins, float* const* outs,
              cudaStream_t stream, int* occ) {
  if (vb > 0)
    return launch_form<M, Q, LM, true>(k, vb, smem, ins, outs, stream, occ);
  return launch_form<M, Q, LM, false>(k, 0, 0, ins, outs, stream, occ);
}

// lm: the LM branch (alpha given); occ: see launch_form
template <class M, int Q, class HK>
int launch(const HK& k, bool lm, int vb, long long smem,
           const float* const* ins, float* const* outs, cudaStream_t stream,
           int* occ = nullptr) {
  if (lm) return launch_lm<M, Q, true>(k, vb, smem, ins, outs, stream, occ);
  return launch_lm<M, Q, false>(k, vb, smem, ins, outs, stream, occ);
}

// the blocks per SM of the instance, with (lm) or without its LM branch,
// as launch_form reports them; -1 where refused
template <class M, int Q>
int occupancy(bool lm, int vb, long long smem) {
  VBParamsFor<M::P, Q> k = {};
  int occ = 0;
  return launch<M, Q>(k, lm, vb, smem, nullptr, nullptr, nullptr, &occ) == 0
             ? occ
             : -1;
}

// The by-value block of a launch from the C entry points' host arguments
// (see fabber_fused_vb_iter in fused_vb_iter.cu for their layout) into a
// host block with room for p codes and q groups; false when an argument
// is out of range.
template <class HK>
bool iter_setup(int p, int q, const int* tcodes_host, float dt, int need_f,
                int nt, long long V, long long smem, HK* k) {
  if (p < 1 || p > HK::NCODES || q < 1 || q > HK::NGROUPS || nt < 1 ||
      V < 1 || smem < 0)
    return false;
  *k = HK{};
  for (int i = 0; i < p; ++i) k->tcode[i] = tcodes_host[i];
  k->dt = dt;
  k->need_f = need_f;
  k->nt = nt;
  k->V = V;
  return true;
}

}  // namespace
