// fused_nl_loop.cuh: the whole VB loop of a time-local nonlinear model with
// white noise, for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_loop_nl.py
// make_fused_nl_loop (its pallas_call at line 890) in time_signal mode,
// in three modes (template MODE): maxits (0), the in-kernel pointzeroone
// and freduce detectors (1), and the in-kernel trialmode and lm
// detectors with their best-state copies (2). Plain version:
// fabber_core_tpu_torch/ops/fused_loop_nl.py fused_nl_loop_plain.
//
// One thread per voxel; the posterior, the noise and every per-iteration
// quadratic live in registers. Per iteration, one pass over the T
// samples evaluates the model and its latent-space Jacobian at the
// centre (vb_device.cuh functors) and accumulates, per noise group q,
// J'Q_qJ (packed lower triangle), J'Q_q r and r'Q_q r. Then the solve
// (jitter-retry Cholesky, inverse, means), k'Q_qk by the exact expansion
// r'Q_qr + 2 d'J'Q_qr + d'J'Q_qJ d (d = centre - means) clamped at 0,
// and the phi update b = 1/((k'Qk + tr(Sigma J'Q_qJ))/2 + 1/b0),
// c = c_post. The new means are the next centre. When F is needed one
// more pass at the final means gives the free-energy quadratics
// (fkqk, ftr); the digamma/lgamma assembly stays in torch.
// The posterior carry starts at zero and the noise at (b_init, c_init),
// as the TPU kernel's.
//
// The model is the functor M (vb_device.cuh's contract, P and NS
// suppdata values per voxel): a hand-written one of FABBER_NL_INSTANCES
// (fused_nl_loop.cu, NS = 0), or one generated from a model's evaluate()
// or time_signal() (models/kernelgen.py, ops/_cuda.py build_generated):
// the TPU kernel's generic full-time mode (fused_loop_nl.py:37-46,
// 204-227, 294-310; make_full_eval in fused_vb.py:122-181). In that mode
// the solve, the phi update and the detectors are this same code, as the
// JAX module says of its own; a voxel's suppdata (the [S,V] input) is
// read once into registers and handed to M::eval. The time sums keep
// their two levels in both modes (the TPU's generic mode reduces its one
// full-time block at once; two levels only sum more accurately).
//
// Detector modes (fused_loop_nl.py:56-84, 281-292): pass k's model
// evaluation at its centre (iteration k-1's means) yields exactly
// iteration k-1's k'Q_qk and J'Q_qJ, so iteration k-1's F is assembled
// from the current pass's quadratics, the carried posterior and host
// constants (the Gamma-function terms at the fixed c_post: lb_coeff,
// f_const), and its test (detectors.cuh) runs before iteration k's
// update, with no extra model pass. A lane whose test says done keeps
// its state and its thread leaves the loop; a lane still running after
// n_iters passes takes its last test on the F pass at the final means.
// freduce also captures the ELBO of the initial posterior on pass 0
// (f_const_init: the Gamma terms at c_init; pd0 = its variances) as the
// F a reverted lane reports, and flags the lane; the engine restores the
// initial planes. trialmode and lm keep a best state (means, b, c, prec,
// cov, F), save the carry into it where the test sets save, and after
// the loop apply the engine's finalize (best-save, then the revert
// selection). The best state is written through to the lane's own
// output columns at each save (the columns a reverted lane keeps; F
// stays in a register) rather than copied into 26 more registers at
// biexp Q=1, which measured slower on the H100 (PERF.md). lm takes the
// damped step centre + (Lambda + alpha diag Lambda)^-1 (sum_q phi_q
// J'Q_q r + pp (pm - centre)) where alpha > 0 (fused_loop_nl.py:562-591).
// Outputs
// in detector modes: fkqk[0] = F, ftr[0] = the lane's iteration count;
// freduce adds fkqk[1] = the revert flag, ftr[1] = 0.
//
// Dropped TPU machinery: the [TB,B] partial-sum planes (the time sums
// are two-level in registers instead: kTB = 8 samples into block sums,
// blocks into the totals, which keeps the accuracy the partial planes
// gave), the edge-padded time axis (the [T,Q] group weights carry
// masked samples as 0; the last block runs short), the 1024-voxel
// padding (a bounds check masks the ragged last block), the [4Q,1]
// constant column (the constants ride by value) and the tile-wide
// early-exit reduction (each thread leaves its own loop).
//
// Design for this card (tile.cuh): the data column is read once per
// iteration and once for F, 11 passes at maxits 10, and at 4,000,000
// voxels the 1.6 GB plane is 32x the 50 MB L2, so a streamed pass goes
// to HBM every time and each sample waits on one dependent load. The
// staged form (template STAGED) copies the block's [T, VB] tile and the
// [T, Q] group weights into shared memory once, with cp.async, and every
// pass (the iterations' and the F pass) reads them there: HBM sees the
// plane once. ops/_cuda.py tile_plan stages in one-warp blocks (VB =
// 32: a block's shared memory is freed as soon as its warp is done)
// where at least five fit an SM; a longer T streams, as fewer warps
// cannot hide the latency. What bounds the staged form is instruction
// throughput: per sample and iteration one model evaluation (NEXP expf for
// exp-sum models) plus Q*(P(P+1)/2 + P + 1) multiply-adds, at 16 warps
// per SM at T=100 (biexp at 4,000,000 voxels on an NVIDIA H100 80GB
// HBM3, chip_smoke.py phase 5b: 11.3 ms staged, 17.0 streamed). The
// arithmetic and its order are the streamed form's; nvcc contracts
// multiply-adds in this kernel, so the two forms need not agree bit for
// bit (they did there). In the detector modes a warp runs until its
// slowest lane is done.

#pragma once

#include "coop_device.cuh"
#include "detectors.cuh"
#include "fulltime.cuh"
#include "vb_device.cuh"

namespace {

using namespace fabber;

constexpr int kThreads = 128;

// Everything a detector-mode launch adds: the detector's options and the
// host float64 ELBO constants of VBInference._nl_fdet_consts, rounded to
// float32. NLDetConsts has room for kMaxQ groups; a per-shape instance past
// kMaxQ takes NLDetConstsFor<Q>, sized to its own.
template <int NQ>
struct NLDetConstsN {
  static constexpr int NGROUPS = NQ;
  DetParams d;
  float lb_coeff[NQ];      // n_q/2 + c0_q, the coefficient of log b_q
  float f_const;           // voxel-invariant ELBO terms at c_post
  float f_const_init;      // the same at c_init (freduce's initial F)
};
using NLDetConsts = NLDetConstsN<kMaxQ>;
template <int Q>
using NLDetConstsFor = NLDetConstsN<(Q <= kMaxQ ? kMaxQ : Q)>;

// a host block with room for Q groups as the block of a Q-group instance
template <int Q, class H>
NLDetConstsFor<Q> det_consts_for(const H& dc) {
  using N = NLDetConstsFor<Q>;
  static_assert(H::NGROUPS >= Q, "a block with room");
  N n = {};
  n.d = dc.d;
  constexpr int nq = N::NGROUPS < H::NGROUPS ? N::NGROUPS : H::NGROUPS;
  for (int i = 0; i < nq; ++i) n.lb_coeff[i] = dc.lb_coeff[i];
  n.f_const = dc.f_const;
  n.f_const_init = dc.f_const_init;
  return n;
}

// free_energy_from_parts with the noise shape fixed (the Gamma-function
// terms live in base and lb_coeff), operation order of the TPU kernel's
// assemble_f.
template <int P, int Q, class K, class D>
__device__ __forceinline__ float assemble_f(
    const K& k, const D& dc, float base, const float* cen,
    const float* b, const float* c, const float* covdiag, float logdet,
    const float* kqk, const float* trace, const float* pm, const float* pp) {
  float v = base - 0.5f * logdet;
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) {
    const float phi = b[q] * c[q];
    v = v + dc.lb_coeff[q] * logf(b[q]) - phi * k.inv_b0[q] -
        0.5f * phi * kqk[q] - 0.5f * trace[q];
  }
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
    const float dm = cen[i] - pm[i];
    v = v - 0.5f * (dm * dm + covdiag[i]) * pp[i];
  }
  return v;
}

template <int P>
__device__ __forceinline__ void packed_diag(const float* packed, float* d) {
FABBER_UNROLL
  for (int i = 0; i < P; ++i) d[i] = packed[tri(i, i)];
}

// the lane's posterior into its output columns
template <int P, int Q>
__device__ __forceinline__ void store_state(
    const float* means, const float* prec, const float* cov, const float* b,
    const float* c, float* __restrict__ means_out,
    float* __restrict__ prec_out, float* __restrict__ cov_out,
    float* __restrict__ b_out, float* __restrict__ c_out, long long V,
    long long v) {
FABBER_UNROLL
  for (int i = 0; i < P; ++i) means_out[(size_t)i * V + v] = means[i];
  store_full<P>(prec, prec_out, V, v);
  store_full<P>(cov, cov_out, V, v);
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) {
    b_out[(size_t)q * V + v] = b[q];
    c_out[(size_t)q * V + v] = c[q];
  }
}

// MODE 0: maxits; 1: pointzeroone / freduce; 2: trialmode / lm;
// STAGED: the passes read the block's shared tile (tile.cuh)
template <class M, int Q, int MODE, bool STAGED>
__global__ void __launch_bounds__(kThreads)
fused_nl_loop_kernel(const VBParamsFor<M::P, Q> k,
                     const NLDetConstsFor<Q> dc,
                     const float* __restrict__ centre0,
                     const float* __restrict__ pm_in,
                     const float* __restrict__ pp_in,
                     const float* __restrict__ pd0_in,
                     const float* __restrict__ data,
                     const float* __restrict__ supp,
                     const float* __restrict__ qw,
                     float* __restrict__ means_out,
                     float* __restrict__ prec_out,
                     float* __restrict__ cov_out, float* __restrict__ b_out,
                     float* __restrict__ c_out, float* __restrict__ fkqk_out,
                     float* __restrict__ ftr_out) {
  constexpr int P = M::P, NS = M::NS, NT = P * (P + 1) / 2;
  constexpr bool kDet = MODE != 0, kBest = MODE == 2;
  const long long V = k.V;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // every thread of the block takes part in the staging copy and its
  // barrier, those past V included, before any leaves
  const Column<STAGED> col =
      stage_column<STAGED>(data, qw, k.nt, k.nt * Q, V, v);
  if (v >= V) return;

  float centre[P], pm[P], pp[P];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
    centre[i] = centre0[(size_t)i * V + v];
    pm[i] = pm_in[(size_t)i * V + v];
    pp[i] = pp_in[(size_t)i * V + v];
  }
  // the voxel's suppdata, read once into registers (NS = 0: none)
  float sv[NS > 0 ? NS : 1];
FABBER_UNROLL
  for (int i = 0; i < NS; ++i) sv[i] = supp[(size_t)i * V + v];
  float b[Q], c[Q];
FABBER_UNROLL
  for (int q = 0; q < Q; ++q) {
    b[q] = k.b_init[q];
    c[q] = k.c_init[q];
  }
  float prec[NT], cov[NT], means[P];
FABBER_UNROLL
  for (int i = 0; i < NT; ++i) prec[i] = cov[i] = 0.f;
FABBER_UNROLL
  for (int i = 0; i < P; ++i) means[i] = centre[i];

  // detector lanes (dead code in MODE 0)
  DetState cv = fabber::det_init(dc.d);
  const bool freduce = MODE == 1 && dc.d.kind == fabber::kFreduce;
  const bool with_lm = kBest && dc.d.kind == fabber::kLM;
  // b_f: the F of the best state (MODE 2; the state itself lives in
  // the output columns)
  float logdet = 0.f, f_st = 0.f, rev_f = 0.f, part3 = 0.f, b_f = 0.f;
  if constexpr (kDet) {
    // voxel-varying but iteration-invariant ELBO piece
    part3 = dc.f_const;
FABBER_UNROLL
    for (int i = 0; i < P; ++i) part3 = part3 + 0.5f * logf(pp[i]);
  }

  for (int it = 0; it < k.n_iters; ++it) {
    float phi[Q];
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) phi[q] = b[q] * c[q];

    // ---- one pass over time at the centre ------------------------------
    float mrow[P], chain[P];
    model_rows<P>(k.tcode, centre, mrow, chain);
    float jtj[Q][NT], jtr[Q][P], rqr[Q];
    zero_sums<P, Q>(jtj, jtr, rqr);
    // two-level sums: kTB samples into block sums, blocks into the
    // totals (the TPU kernel's [TB,B] partial planes play this role)
    for (int t0 = 0; t0 < k.nt; t0 += kTB) {
      float bjtj[Q][NT], bjtr[Q][P], brqr[Q];
      zero_sums<P, Q>(bjtj, bjtr, brqr);
      const int t1 = min(t0 + kTB, k.nt);
      for (int t = t0; t < t1; ++t) {
        float jac[P];
        const float sig = eval_latent<M>(mrow, chain, sv, (float)t, k.dt,
                                         jac);
        const float r = col.sample(t) - sig;
FABBER_UNROLL
        for (int q = 0; q < Q; ++q) {
          const float w = col.weight(t * Q + q);
          const float wr = w * r;
FABBER_UNROLL
          for (int i = 0; i < P; ++i) {
            const float wj = w * jac[i];
FABBER_UNROLL
            for (int j = 0; j <= i; ++j)
              bjtj[q][tri(i, j)] = bjtj[q][tri(i, j)] + wj * jac[j];
            bjtr[q][i] = bjtr[q][i] + jac[i] * wr;
          }
          brqr[q] = brqr[q] + wr * r;
        }
      }
      add_sums<P, Q>(jtj, jtr, rqr, bjtj, bjtr, brqr);
    }

    if constexpr (kDet) {
      // ---- the deferred test of iteration it-1: this pass evaluated
      // the model at its means, so rqr is its k'Q_qk and jtj its J'Q_qJ
      float trace[Q], cdiag[P];
FABBER_UNROLL
      for (int q = 0; q < Q; ++q) trace[q] = trace_packed<P>(cov, jtj[q]);
      packed_diag<P>(cov, cdiag);
      const float f_here = assemble_f<P, Q>(k, dc, part3, centre, b, c,
                                            cdiag, logdet, rqr, trace, pm,
                                            pp);
      if (freduce && it == 0) {
        // pass 0 evaluates at the initial means: the initial-state ELBO
        // (diagonal initial covariance pd0, noise shape c_init) is the
        // F a reverted lane reports
        float pd0[P], tr0[Q];
        float ld0 = 0.f, base = dc.f_const_init;
FABBER_UNROLL
        for (int i = 0; i < P; ++i) {
          pd0[i] = pd0_in[(size_t)i * V + v];
          ld0 = ld0 - logf(pd0[i]);
          base = base + 0.5f * logf(pp[i]);
        }
FABBER_UNROLL
        for (int q = 0; q < Q; ++q) {
          float s = 0.f;
FABBER_UNROLL
          for (int i = 0; i < P; ++i) s = s + pd0[i] * jtj[q][tri(i, i)];
          tr0[q] = s;
        }
        rev_f = assemble_f<P, Q>(k, dc, base, centre, b, c, pd0, ld0, rqr,
                                 tr0, pm, pp);
      }
      if (it >= 1) {
        const bool reduced = f_here - cv.prev_f < 0.f;
        fabber::det_test(dc.d, cv, f_here);
        f_st = (freduce && reduced) ? rev_f : f_here;
        if constexpr (kBest) {
          if (cv.save) {
            // the top-of-iteration save of the engine: the carry is
            // iteration it-1's state
            store_state<P, Q>(centre, prec, cov, b, c, means_out, prec_out,
                              cov_out, b_out, c_out, V, v);
            b_f = f_here;
          }
        }
        if (cv.done) break;   // a frozen lane keeps iteration it-1's state
      }
    }

    // ---- solve (Eq 19/20) ----------------------------------------------
    float ch[NT];
    posterior_solve<P, Q, true>(jtj, jtr, phi, centre, pm, pp, prec, cov,
                                means, ch);
    if constexpr (kBest) {
      if (with_lm && cv.alpha > 0.f) {
        // LM-damped step: (Lambda + alpha diag Lambda) x = sum_q phi_q
        // J'Q_q r + pp (pm - centre), means = centre + x; prec and cov
        // stay undamped
        float damped[NT], dch[NT], delta[P];
FABBER_UNROLL
        for (int i = 0; i < P; ++i) {
FABBER_UNROLL
          for (int j = 0; j <= i; ++j)
            damped[tri(i, j)] =
                prec[tri(i, j)] + (i == j ? cv.alpha * prec[tri(i, i)] : 0.f);
          float s = pp[i] * (pm[i] - centre[i]);
FABBER_UNROLL
          for (int q = 0; q < Q; ++q) s = s + phi[q] * jtr[q][i];
          delta[i] = s;
        }
        cholesky_jittered<P>(damped, dch);
        chol_solve<P>(dch, delta);
FABBER_UNROLL
        for (int i = 0; i < P; ++i) means[i] = centre[i] + delta[i];
      }
    }

    // ---- k'Q_qk by exact expansion, then the phi update (Eq 21/22) ------
    float d[P];
FABBER_UNROLL
    for (int i = 0; i < P; ++i) d[i] = centre[i] - means[i];
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) {
      float kq = rqr[q];
FABBER_UNROLL
      for (int a = 0; a < P; ++a) kq = kq + 2.f * d[a] * jtr[q][a];
FABBER_UNROLL
      for (int i = 0; i < P; ++i) {
FABBER_UNROLL
        for (int j = 0; j <= i; ++j) {
          const float dd = d[i] * d[j];
          kq = kq + (i == j ? dd : 2.f * dd) * jtj[q][tri(i, j)];
        }
      }
      const float kqk = fmaxf(kq, 0.f);
      const float tr = trace_packed<P>(cov, jtj[q]);
      float bq = 1.f / ((kqk + tr) * 0.5f + k.inv_b0[q]);
      const float cq = k.c_post[q];
      if (k.locked_sd > 0.f) bq = 1.f / cq / (k.locked_sd * k.locked_sd);
      b[q] = bq;
      c[q] = cq;
    }
FABBER_UNROLL
    for (int i = 0; i < P; ++i) centre[i] = means[i];
    if constexpr (kDet) {
      float ld = 0.f;
FABBER_UNROLL
      for (int i = 0; i < P; ++i) ld = ld + 2.f * logf(ch[tri(i, i)]);
      logdet = ld;
    }
  }

  if constexpr (!kDet) {
FABBER_UNROLL
    for (int i = 0; i < P; ++i) means_out[(size_t)i * V + v] = means[i];
    store_full<P>(prec, prec_out, V, v);
    store_full<P>(cov, cov_out, V, v);
    float fkqk[Q], ftr[Q];
    if (k.need_f) {
      f_pass<M, Q>(k.tcode, k.dt, means, cov, col, k.nt, fkqk, ftr, sv);
    } else {
FABBER_UNROLL
      for (int q = 0; q < Q; ++q) fkqk[q] = ftr[q] = 0.f;
    }
FABBER_UNROLL
    for (int q = 0; q < Q; ++q) {
      b_out[(size_t)q * V + v] = b[q];
      c_out[(size_t)q * V + v] = c[q];
      fkqk_out[(size_t)q * V + v] = fkqk[q];
      ftr_out[(size_t)q * V + v] = ftr[q];
    }
  } else {
    if (!cv.done) {
      // the last iteration's test, on the F pass at the final means
      float kqk2[Q], trace2[Q], cdiag[P];
      f_pass<M, Q>(k.tcode, k.dt, centre, cov, col, k.nt, kqk2, trace2, sv);
      packed_diag<P>(cov, cdiag);
      const float f_last = assemble_f<P, Q>(k, dc, part3, centre, b, c,
                                            cdiag, logdet, kqk2, trace2, pm,
                                            pp);
      const bool reduced = f_last - cv.prev_f < 0.f;
      fabber::det_test(dc.d, cv, f_last);
      f_st = (freduce && reduced) ? rev_f : f_last;
    }
    // the engine's finalize: best <- final where save, then the output
    // <- best where revert (its F is the one captured at the save); a
    // lane's first save precedes any revert (the first test always
    // continues), so the best copy is always written before it is read
    const bool keep_best = kBest && cv.revert && !cv.save;
    // a lane keeping its best state has it in its output columns already
    if (keep_best)
      f_st = b_f;
    else
      store_state<P, Q>(centre, prec, cov, b, c, means_out, prec_out,
                        cov_out, b_out, c_out, V, v);
    fkqk_out[v] = f_st;
    ftr_out[v] = (float)cv.its;
    if (freduce) {
      fkqk_out[(size_t)V + v] = cv.revert ? 1.f : 0.f;
      ftr_out[(size_t)V + v] = 0.f;
    }
  }
}

// ---- the full-time form: a warp per voxel -------------------------------
//
// The TPU kernel's generic full-time mode for a model that mixes time (its
// functor M from models/kernelgen.py's full-time walk, csrc/fulltime.cuh's
// contract): one voxel a warp of kCoopThreads lanes, W voxels a block (a
// warp each, W chosen at launch: launch_full), the voxel's state in its
// warp's slice of the block's shared memory (FullLayout), the lanes meeting
// at __syncwarp and closing reductions by butterflies, with the pieces of
// kernel 7's cooperative form (coop_device.cuh). Per iteration:
//   model    M::run at the centre, every lane: the signal and the
//            model-space Jacobian of the T samples into the out plane;
//   pass     per group J'Q_qJ, J'Q_q r and r'Q_q r read straight from the
//            out plane (times the chain factors, r = y - g), each entry in
//            the two-level order of the other kernels (kTB samples into a
//            block sum, the blocks into the total in order): a lane an
//            entry, or where the entries are fewer than the lanes, R lanes
//            an entry take its blocks R at a time and one of them adds each
//            round's R block sums (FullLayout::R; two barriers a round);
//   test     (MODEs 1-2) the deferred test of the last iteration, every
//            lane on the same shared values (so every lane takes the same
//            branch), with the best-state saves of MODE 2;
//   solve    prec and rhs a lane an entry, the Cholesky factor a column a
//            step (a lane its rows) with the jitter retry, the inverse, the
//            means; lm's damped step (coop_chol_solve);
//   update   k'Q_qk by the exact expansion and the phi update, a lane a
//            group, each trace across the lanes;
// then the F pass (MODE 0 with need_f, and the last test) at the final
// means. The voxel's samples are staged in shared memory once; the [T, Q]
// group weights are read through the read-only cache (one copy for every
// voxel). What bounds it is the functor's work (each evaluation's lines
// over T samples and, for a contraction, T^2 (P + 1) multiply-adds), and
// its shared memory bounds the shapes (ops/_cuda.py fulltime_smem, per
// voxel, checked here by a static_assert). FABBER_MARK(k) marks section k
// for probes/coop_sections.py (empty in every build but the probe's).

constexpr int kFullMaxW = 4;   // the most voxels (warps) a block

template <class M, int Q>
struct FullLayout {
  static constexpr int P = M::P, NT = P * (P + 1) / 2, T = M::NT;
  static constexpr int NE = NT + P + 1;       // a group's sums
  static constexpr int NB = (T + kTB - 1) / kTB;   // kTB blocks of T
  // the lanes an entry's blocks are shared among (full_pass): as many as
  // leave no entry fewer, at most NB
  static constexpr int R = Q * NE >= kCoopThreads
                               ? 1
                               : (kCoopThreads / (Q * NE) < NB
                                      ? kCoopThreads / (Q * NE)
                                      : NB);
  static constexpr int sums = 0;              // [Q][NT] J'Q_qJ
  static constexpr int jtr = sums + Q * NT;   // [Q][P]  J'Q_q r
  static constexpr int rqr = jtr + Q * P;     // [Q]     r'Q_q r
  static constexpr int bsum = rqr + Q;        // [Q NE][R] a round's block
                                              // sums (none where R = 1)
  static constexpr int prec = bsum + (R > 1 ? Q * NE * R : 0);  // [NT] each
  static constexpr int ch = prec + NT, inv = ch + NT, dch = inv + NT,
                       cov = dch + NT;
  static constexpr int vec = cov + NT;        // [P] each
  static constexpr int centre = vec, pm = vec + P, pp = vec + 2 * P,
                       mrow = vec + 3 * P, chain = vec + 4 * P,
                       rhs = vec + 5 * P, means = vec + 6 * P,
                       d = vec + 7 * P, x = vec + 8 * P;
  static constexpr int grp = vec + 9 * P;     // [Q] each
  static constexpr int b = grp, c = grp + Q, phi = grp + 2 * Q,
                       tr = grp + 3 * Q;
  static constexpr int col = grp + 4 * Q;     // [T] the voxel's samples
  static constexpr int out = col + T;         // [(P+1) T] the model
  static constexpr int fn = out + (P + 1) * T;   // M::SMEM the functor's
  static constexpr int floats = fn + M::SMEM;  // a voxel's (a warp's)
  static constexpr long long bytes = 4LL * floats;
};

// Entry s (group q, entry e of NE) of a pass's sums over the kTB block bl
// of the samples: e < NT a packed J'Q_qJ entry, then the P rows of J'Q_q r
// (WITH_R, else 0), then r'Q_q r.
template <class M, int Q, bool WITH_R>
__device__ __forceinline__ float full_block_sum(const float* sh,
                                                const float* __restrict__ qw,
                                                int s, int bl) {
  using L = FullLayout<M, Q>;
  constexpr int P = M::P, T = M::NT, NT = L::NT, NE = L::NE;
  const float *out = sh + L::out, *col = sh + L::col,
              *chain = sh + L::chain;
  const int q = s / NE, e = s - q * NE;
  const int t0 = bl * kTB, t1 = min(t0 + kTB, T);
  float bs = 0.f;
  if (e < NT) {
    int i, j;
    untri(e, i, j);
    for (int t = t0; t < t1; ++t) {
      const float wj = __ldg(qw + t * Q + q) *
                       (out[(1 + i) * T + t] * chain[i]);
      bs = bs + wj * (out[(1 + j) * T + t] * chain[j]);
    }
  } else if (e < NT + P) {
    if (WITH_R) {
      const int i = e - NT;
      for (int t = t0; t < t1; ++t) {
        const float wj = __ldg(qw + t * Q + q) *
                         (out[(1 + i) * T + t] * chain[i]);
        bs = bs + wj * (col[t] - out[t]);
      }
    }
  } else {
    for (int t = t0; t < t1; ++t) {
      const float r = col[t] - out[t];
      bs = bs + __ldg(qw + t * Q + q) * (r * r);
    }
  }
  return bs;
}

// entry s's total into sums, jtr or rqr
template <class M, int Q>
__device__ __forceinline__ void full_put(float* sh, int s, float tot) {
  using L = FullLayout<M, Q>;
  const int q = s / L::NE, e = s - q * L::NE;
  if (e < L::NT)
    sh[L::sums + q * L::NT + e] = tot;
  else if (e < L::NT + M::P)
    sh[L::jtr + q * M::P + (e - L::NT)] = tot;
  else
    sh[L::rqr + q] = tot;
}

// The model at rows mrow (model space, shared) into the out plane, then
// the per-group sums over the samples: J'Q_qJ into sums, with WITH_R
// J'Q_q r into jtr (else 0), and r'Q_q r (r = y - g) into rqr. Each
// entry's total adds its blocks' sums in order, from a lane of its own
// (R = 1) or, R lanes an entry, a round of R blocks at a time.
template <class M, int Q, bool WITH_R>
__device__ __forceinline__ void full_pass(float* sh, const float* sv,
                                          const float* __restrict__ cst,
                                          const float* __restrict__ qw) {
  using L = FullLayout<M, Q>;
  constexpr int P = M::P, NB = L::NB, S = Q * L::NE, R = L::R;
  const int lane = coop_lane();
  float m[P];
  for (int i = 0; i < P; ++i) m[i] = sh[L::mrow + i];
  FABBER_MARK(WITH_R ? 18 : 19);
  fabber::gen::run_dual<M>(m, sv, cst, sh + L::fn, sh + L::out, lane,
                           kCoopThreads);
  FABBER_MARK(12);
  if constexpr (R == 1) {
    for (int s = lane; s < S; s += kCoopThreads) {
      float tot = 0.f;
      for (int bl = 0; bl < NB; ++bl)
        tot = tot + full_block_sum<M, Q, WITH_R>(sh, qw, s, bl);
      full_put<M, Q>(sh, s, tot);
    }
  } else {
    const int s = lane / R, r = lane - s * R;
    const bool on = s < S;
    float tot = 0.f;
    for (int b0 = 0; b0 < NB; b0 += R) {
      if (on && b0 + r < NB)
        sh[L::bsum + lane] = full_block_sum<M, Q, WITH_R>(sh, qw, s, b0 + r);
      coop_sync();
      if (on && r == 0) {
        for (int j = 0; j < R && b0 + j < NB; ++j)
          tot = tot + sh[L::bsum + lane + j];
      }
      coop_sync();
    }
    if (on && r == 0) full_put<M, Q>(sh, s, tot);
  }
  coop_sync();
  FABBER_MARK(WITH_R ? 15 : 19);
}

// the model rows and chain factors at the latent means lat (shared)
template <int P, class K>
__device__ __forceinline__ void full_rows(const K& k, const float* lat,
                                          float* mrow, float* chain) {
  for (int i = coop_lane(); i < P; i += kCoopThreads) {
    mrow[i] = to_model(k.tcode[i], lat[i]);
    chain[i] = chain_factor(k.tcode[i], lat[i]);
  }
  coop_sync();
}

// the voxel's state into its output columns, a lane an entry
template <int P, int Q>
__device__ __forceinline__ void full_store_state(
    const float* means, const float* prec, const float* cov, const float* b,
    const float* c, float* __restrict__ means_out, float* __restrict__ prec_out,
    float* __restrict__ cov_out, float* __restrict__ b_out,
    float* __restrict__ c_out, long long V, long long v) {
  const int lane = coop_lane();
  for (int i = lane; i < P; i += kCoopThreads)
    means_out[(size_t)i * V + v] = means[i];
  coop_store_full<P>(prec, prec_out, V, v);
  coop_store_full<P>(cov, cov_out, V, v);
  for (int q = lane; q < Q; q += kCoopThreads) {
    b_out[(size_t)q * V + v] = b[q];
    c_out[(size_t)q * V + v] = c[q];
  }
}

// The full-time form's kernel: fused_nl_loop_kernel's parameters and
// outputs and the functor's constants cst; W = blockDim.x / kCoopThreads
// voxels a block, a warp each, a FullLayout each in the block's shared
// memory.
template <class M, int Q, int MODE>
__global__ void __launch_bounds__(kCoopThreads * kFullMaxW)
fused_nl_loop_full_kernel(const VBParamsFor<M::P, Q> k,
                          const NLDetConstsFor<Q> dc,
                          const float* __restrict__ centre0,
                          const float* __restrict__ pm_in,
                          const float* __restrict__ pp_in,
                          const float* __restrict__ pd0_in,
                          const float* __restrict__ data,
                          const float* __restrict__ supp,
                          const float* __restrict__ qw,
                          const float* __restrict__ cst,
                          float* __restrict__ means_out,
                          float* __restrict__ prec_out,
                          float* __restrict__ cov_out,
                          float* __restrict__ b_out, float* __restrict__ c_out,
                          float* __restrict__ fkqk_out,
                          float* __restrict__ ftr_out) {
  using L = FullLayout<M, Q>;
  constexpr int P = M::P, NS = M::NS, NT = L::NT, T = M::NT;
  constexpr bool kDet = MODE != 0, kBest = MODE == 2;
  static_assert(L::bytes <= kMaxBlockSmem,
                "the voxel's state in one block's shared memory");
  const int warp = (int)(threadIdx.x / kCoopThreads);
  const long long V = k.V,
                  v = (long long)blockIdx.x * (blockDim.x / kCoopThreads) +
                      warp;
  if (v >= V) return;   // the whole warp: it meets no other
  FABBER_SEC_BEGIN();
  const int tid = coop_lane();
  float* const sh = dynamic_smem() + (size_t)warp * L::floats;
  float *sums = sh + L::sums, *jtr = sh + L::jtr, *rqr = sh + L::rqr,
        *prec = sh + L::prec, *ch = sh + L::ch, *inv = sh + L::inv,
        *dch = sh + L::dch, *cov = sh + L::cov;
  float *centre = sh + L::centre, *pm = sh + L::pm, *pp = sh + L::pp,
        *mrow = sh + L::mrow, *chain = sh + L::chain, *rhs = sh + L::rhs,
        *means = sh + L::means, *d = sh + L::d, *x = sh + L::x;
  float *b = sh + L::b, *c = sh + L::c, *phi = sh + L::phi, *tr = sh + L::tr;

  for (int i = tid; i < P; i += kCoopThreads) {
    centre[i] = centre0[(size_t)i * V + v];
    means[i] = centre[i];
    pm[i] = pm_in[(size_t)i * V + v];
    pp[i] = pp_in[(size_t)i * V + v];
  }
  for (int q = tid; q < Q; q += kCoopThreads) {
    b[q] = k.b_init[q];
    c[q] = k.c_init[q];
  }
  for (int e = tid; e < NT; e += kCoopThreads) prec[e] = cov[e] = 0.f;
  for (int t = tid; t < T; t += kCoopThreads)
    sh[L::col + t] = data[(size_t)t * V + v];
  // the voxel's suppdata, in every lane's registers (NS = 0: none)
  float sv[NS > 0 ? NS : 1];
  for (int i = 0; i < NS; ++i) sv[i] = supp[(size_t)i * V + v];
  coop_sync();

  // detector lanes (dead code in MODE 0), the same in every lane
  DetState cv = fabber::det_init(dc.d);
  const bool freduce = MODE == 1 && dc.d.kind == fabber::kFreduce;
  const bool with_lm = kBest && dc.d.kind == fabber::kLM;
  float logdet = 0.f, f_st = 0.f, rev_f = 0.f, part3 = 0.f, b_f = 0.f;
  if constexpr (kDet) {
    part3 = dc.f_const;
    for (int i = 0; i < P; ++i) part3 = part3 + 0.5f * logf(pp[i]);
  }

  FABBER_MARK(0);
  for (int it = 0; it < k.n_iters; ++it) {
    for (int q = tid; q < Q; q += kCoopThreads) phi[q] = b[q] * c[q];
    full_rows<P>(k, centre, mrow, chain);
    full_pass<M, Q, true>(sh, sv, cst, qw);

    if constexpr (kDet) {
      // the deferred test of iteration it-1 (fused_nl_loop_kernel's)
      coop_traces<P, Q>(cov, sums, tr);
      float cdiag[P];
      for (int i = 0; i < P; ++i) cdiag[i] = cov[tri(i, i)];
      const float f_here = assemble_f<P, Q>(k, dc, part3, centre, b, c,
                                            cdiag, logdet, rqr, tr, pm, pp);
      if (freduce && it == 0) {
        float pd0[P], tr0[Q];
        float ld0 = 0.f, base = dc.f_const_init;
        for (int i = 0; i < P; ++i) {
          pd0[i] = pd0_in[(size_t)i * V + v];
          ld0 = ld0 - logf(pd0[i]);
          base = base + 0.5f * logf(pp[i]);
        }
        for (int q = 0; q < Q; ++q) {
          float s = 0.f;
          for (int i = 0; i < P; ++i)
            s = s + pd0[i] * sums[q * NT + tri(i, i)];
          tr0[q] = s;
        }
        rev_f = assemble_f<P, Q>(k, dc, base, centre, b, c, pd0, ld0, rqr,
                                 tr0, pm, pp);
      }
      if (it >= 1) {
        const bool reduced = f_here - cv.prev_f < 0.f;
        fabber::det_test(dc.d, cv, f_here);
        f_st = (freduce && reduced) ? rev_f : f_here;
        if constexpr (kBest) {
          if (cv.save) {
            full_store_state<P, Q>(centre, prec, cov, b, c, means_out,
                                   prec_out, cov_out, b_out, c_out, V, v);
            b_f = f_here;
          }
        }
        if (cv.done) break;   // every lane: the same test
      }
      coop_sync();   // the test's reads before the solve's writes
    }
    FABBER_MARK(16);

    // ---- solve (Eq 19/20), posterior_solve's arithmetic ------------------
    {
      int i, j;
      untri(tid, i, j);
      for (int e = tid; e < NT; e += kCoopThreads) {
        float val = 0.f;
        for (int q = 0; q < Q; ++q) val = val + phi[q] * sums[q * NT + e];
        if (i == j) val = val + pp[i];
        prec[e] = val;
        tri_step(i, j, kCoopThreads);
      }
    }
    for (int a = tid; a < P; a += kCoopThreads) {
      float val = 0.f;
      for (int q = 0; q < Q; ++q) {
        float g = jtr[q * P + a];
        for (int j = 0; j < P; ++j)
          g = g + sums[q * NT + tri(a, j)] * centre[j];
        val = val + phi[q] * g;
      }
      rhs[a] = val + pp[a] * pm[a];
    }
    coop_sync();
    FABBER_MARK(3);
    coop_cholesky_jittered<P>(prec, ch);
    FABBER_MARK(4);
    coop_inverse<P>(ch, inv, cov);
    FABBER_MARK(5);
    for (int i = tid; i < P; i += kCoopThreads) {
      float m = 0.f;
      for (int j = 0; j < P; ++j) m = m + cov[tri(i, j)] * rhs[j];
      means[i] = m;
    }
    coop_sync();
    FABBER_MARK(6);
    if constexpr (kBest) {
      if (with_lm && cv.alpha > 0.f) {
        // the LM-damped step (fused_nl_loop_kernel's)
        {
          int i, j;
          untri(tid, i, j);
          for (int e = tid; e < NT; e += kCoopThreads) {
            inv[e] = prec[e] + (i == j ? cv.alpha * prec[tri(i, i)] : 0.f);
            tri_step(i, j, kCoopThreads);
          }
        }
        for (int i = tid; i < P; i += kCoopThreads) {
          float s = pp[i] * (pm[i] - centre[i]);
          for (int q = 0; q < Q; ++q) s = s + phi[q] * jtr[q * P + i];
          x[i] = s;
        }
        coop_sync();
        coop_cholesky_jittered<P>(inv, dch);
        coop_chol_solve<P>(dch, x);
        for (int i = tid; i < P; i += kCoopThreads) means[i] = centre[i] + x[i];
        coop_sync();
      }
    }
    FABBER_MARK(7);

    // ---- k'Q_qk by exact expansion, then the phi update (Eq 21/22) ------
    for (int i = tid; i < P; i += kCoopThreads) d[i] = centre[i] - means[i];
    coop_sync();
    for (int q = 0; q < Q; ++q) {
      const float* jtj = sums + q * NT;
      const float trq = coop_trace<P>(cov, jtj);
      if (tid != q % kCoopThreads) continue;
      float kq = rqr[q];
      for (int a = 0; a < P; ++a) kq = kq + 2.f * d[a] * jtr[q * P + a];
      for (int i = 0; i < P; ++i) {
        for (int j = 0; j <= i; ++j) {
          const float dd = d[i] * d[j];
          kq = kq + (i == j ? dd : 2.f * dd) * jtj[tri(i, j)];
        }
      }
      const float kqk = fmaxf(kq, 0.f);
      float bq = 1.f / ((kqk + trq) * 0.5f + k.inv_b0[q]);
      const float cq = k.c_post[q];
      if (k.locked_sd > 0.f) bq = 1.f / cq / (k.locked_sd * k.locked_sd);
      b[q] = bq;
      c[q] = cq;
    }
    for (int i = tid; i < P; i += kCoopThreads) centre[i] = means[i];
    if constexpr (kDet) {
      float ld = 0.f;
      for (int i = 0; i < P; ++i) ld = ld + 2.f * logf(ch[tri(i, i)]);
      logdet = ld;
    }
    coop_sync();
    FABBER_MARK(18);
  }

  if constexpr (!kDet) {
    full_store_state<P, Q>(means, prec, cov, b, c, means_out, prec_out,
                           cov_out, b_out, c_out, V, v);
    if (k.need_f) {
      full_rows<P>(k, means, mrow, chain);
      full_pass<M, Q, false>(sh, sv, cst, qw);
      coop_traces<P, Q>(cov, sums, tr);
    }
    for (int q = tid; q < Q; q += kCoopThreads) {
      fkqk_out[(size_t)q * V + v] = k.need_f ? rqr[q] : 0.f;
      ftr_out[(size_t)q * V + v] = k.need_f ? tr[q] : 0.f;
    }
  } else {
    if (!cv.done) {
      // the last iteration's test, on the F pass at the final means
      full_rows<P>(k, centre, mrow, chain);
      full_pass<M, Q, false>(sh, sv, cst, qw);
      coop_traces<P, Q>(cov, sums, tr);
      float cdiag[P];
      for (int i = 0; i < P; ++i) cdiag[i] = cov[tri(i, i)];
      const float f_last = assemble_f<P, Q>(k, dc, part3, centre, b, c,
                                            cdiag, logdet, rqr, tr, pm, pp);
      const bool reduced = f_last - cv.prev_f < 0.f;
      fabber::det_test(dc.d, cv, f_last);
      f_st = (freduce && reduced) ? rev_f : f_last;
    }
    // the engine's finalize, as fused_nl_loop_kernel's
    const bool keep_best = kBest && cv.revert && !cv.save;
    if (keep_best)
      f_st = b_f;
    else
      full_store_state<P, Q>(centre, prec, cov, b, c, means_out, prec_out,
                             cov_out, b_out, c_out, V, v);
    if (tid == 0) {
      fkqk_out[v] = f_st;
      ftr_out[v] = (float)cv.its;
      if (freduce) {
        fkqk_out[(size_t)V + v] = cv.revert ? 1.f : 0.f;
        ftr_out[(size_t)V + v] = 0.f;
      }
    }
  }
  FABBER_MARK(10);
  FABBER_SEC_END();
}

// The by-value blocks of a launch from the C entry points' host arrays
// (see fabber_fused_nl_loop in fused_nl_loop.cu for their layout) into
// host blocks with room for p codes and q groups (VBParams and
// NLDetConsts for the prebuilt entry points; a per-shape instance's own);
// false when an argument is out of range.
template <class HK, class HD>
bool nl_setup(int p, int q, const int* tcodes_host, float dt, int n_iters,
              int need_f, float locked_sd, const float* consts_host,
              int det_kind, float det_tol, int det_max_its,
              int det_max_trials, int det_init_save,
              const float* det_consts_host, const float* pd0, int nt,
              long long V, HK* k, HD* dc) {
  if (p < 1 || p > HK::NCODES || q < 1 || q > HK::NGROUPS ||
      q > HD::NGROUPS || n_iters < 1 || nt < 1 || V < 1 ||
      det_kind < fabber::kMaxits || det_kind > fabber::kLM ||
      (det_kind == fabber::kFreduce && pd0 == nullptr))
    return false;
  *k = HK{};
  for (int i = 0; i < p; ++i) k->tcode[i] = tcodes_host[i];
  k->dt = dt;
  k->n_iters = n_iters;
  k->need_f = need_f;
  k->locked_sd = locked_sd;
  for (int i = 0; i < q; ++i) {
    k->inv_b0[i] = consts_host[i];
    k->c_post[i] = consts_host[q + i];
    k->b_init[i] = consts_host[2 * q + i];
    k->c_init[i] = consts_host[3 * q + i];
  }
  k->nt = nt;
  k->V = V;
  *dc = HD{};
  dc->d = {det_kind, det_tol, det_max_its, det_max_trials, det_init_save};
  if (det_kind != fabber::kMaxits) {
    for (int i = 0; i < q; ++i) dc->lb_coeff[i] = det_consts_host[i];
    dc->f_const = det_consts_host[q];
    dc->f_const_init = det_consts_host[q + 1];
  }
  return true;
}


// ---- launch ---------------------------------------------------------------

// the dynamic shared memory of vb (0: streamed) at nt samples and Q
// groups, -1 where it is refused (tile.cuh tile_bytes)
inline long long nl_smem(int vb, int nt, int q) {
  return vb == 0 ? 0 : tile_bytes(vb, nt, nt * q, kThreads);
}

// One instance's launch, or (occ not null) its blocks per SM: vb = 0
// streams in blocks of kThreads, vb > 0 stages in blocks of vb lanes with
// smem bytes of dynamic shared memory.
template <class M, int Q, int MODE, bool STAGED, class HK, class HD>
int launch_form(const HK& k, const HD& dc, int vb, long long smem,
                const float* const* ins, float* const* outs,
                cudaStream_t stream, int* occ) {
  const auto kernel = fused_nl_loop_kernel<M, Q, MODE, STAGED>;
  const int threads = STAGED ? vb : kThreads;
  const int err = tile_setup(kernel, STAGED ? vb : 0, smem);
  if (err != 0) return err;
  if (occ != nullptr) {
    *occ = tile_occupancy(kernel, threads, smem);
    return 0;
  }
  const unsigned grid = (unsigned)((k.V + threads - 1) / threads);
  kernel<<<grid, threads, smem, stream>>>(
      params_for<M::P, Q>(k), det_consts_for<Q>(dc), ins[0], ins[1],
      ins[2], ins[3], ins[4],
      ins[5], ins[6], outs[0], outs[1], outs[2], outs[3], outs[4], outs[5],
      outs[6]);
  return (int)cudaGetLastError();
}

template <class M, int Q, int MODE, class HK, class HD>
int launch_mode(const HK& k, const HD& dc, int vb, long long smem,
                const float* const* ins, float* const* outs,
                cudaStream_t stream, int* occ) {
  if (vb > 0)
    return launch_form<M, Q, MODE, true>(k, dc, vb, smem, ins, outs, stream,
                                         occ);
  return launch_form<M, Q, MODE, false>(k, dc, 0, 0, ins, outs, stream, occ);
}

// mode: the detector kind (dc.d.kind) picks MODE; occ: see launch_form
template <class M, int Q, class HK, class HD>
int launch(const HK& k, const HD& dc, int vb, long long smem,
           const float* const* ins, float* const* outs, cudaStream_t stream,
           int* occ = nullptr) {
  switch (dc.d.kind) {
    case fabber::kMaxits:
      return launch_mode<M, Q, 0>(k, dc, vb, smem, ins, outs, stream, occ);
    case fabber::kPointZeroOne:
    case fabber::kFreduce:
      return launch_mode<M, Q, 1>(k, dc, vb, smem, ins, outs, stream, occ);
    default:
      return launch_mode<M, Q, 2>(k, dc, vb, smem, ins, outs, stream, occ);
  }
}

// the blocks per SM of MODE (0, 1, 2) as launch_form reports them
template <class M, int Q>
int occupancy(int mode, int vb, long long smem) {
  VBParamsFor<M::P, Q> k = {};
  NLDetConstsFor<Q> dc = {};
  dc.d.kind = mode == 0 ? fabber::kMaxits
                        : (mode == 1 ? fabber::kPointZeroOne
                                     : fabber::kTrialMode);
  int occ = 0;
  return launch<M, Q>(k, dc, vb, smem, nullptr, nullptr, nullptr, &occ) == 0
             ? occ
             : -1;
}

// The full-time form's launch geometry: W, the voxels a block (a warp
// each, W FullLayouts of dynamic shared memory), the W of 1, 2 and 4 whose
// blocks hold the most warps on an SM (registers, shared memory and the
// SM's 32 blocks decide: cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// the smaller on a tie. *blocks its blocks per SM. 0 where none launches.
template <class M, int Q, int MODE>
int full_geometry(int* blocks) {
  const auto kernel = fused_nl_loop_full_kernel<M, Q, MODE>;
  constexpr long long voxel = FullLayout<M, Q>::bytes;
  int best_w = 0, best_warps = 0;
  *blocks = 0;
  for (int w = 1; w <= kFullMaxW; w *= 2) {
    if (w * voxel > kMaxBlockSmem) break;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(w * voxel)) != 0)
      break;
    const int occ = tile_occupancy(kernel, w * kCoopThreads, w * voxel);
    if (occ * w > best_warps) {
      best_w = w;
      best_warps = occ * w;
      *blocks = occ;
    }
  }
  return best_w;
}

// The full-time form's launch (W voxels a block, full_geometry; nt must be
// the functor's NT), or (occ not null) its blocks per SM and (voxels not
// null) W. mode: see launch.
template <class M, int Q, int MODE, class HK, class HD>
int launch_full_mode(const HK& k, const HD& dc, const float* const* ins,
                     float* const* outs, cudaStream_t stream, int* occ,
                     int* voxels) {
  const auto kernel = fused_nl_loop_full_kernel<M, Q, MODE>;
  int blocks = 0;
  const int w = full_geometry<M, Q, MODE>(&blocks);
  if (w == 0) return (int)cudaErrorInvalidValue;
  const long long smem = w * FullLayout<M, Q>::bytes;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  if (occ != nullptr || voxels != nullptr) {
    if (occ != nullptr) *occ = blocks;
    if (voxels != nullptr) *voxels = w;
    return 0;
  }
  const unsigned grid = (unsigned)((k.V + w - 1) / w);
  kernel<<<grid, w * kCoopThreads, smem, stream>>>(
      params_for<M::P, Q>(k), det_consts_for<Q>(dc), ins[0], ins[1], ins[2],
      ins[3], ins[4], ins[5], ins[6], ins[7], outs[0], outs[1], outs[2],
      outs[3], outs[4], outs[5], outs[6]);
  return (int)cudaGetLastError();
}

template <class M, int Q, class HK, class HD>
int launch_full(const HK& k, const HD& dc, const float* const* ins,
                float* const* outs, cudaStream_t stream, int* occ = nullptr,
                int* voxels = nullptr) {
  if (k.nt != M::NT) return (int)cudaErrorInvalidValue;
  switch (dc.d.kind) {
    case fabber::kMaxits:
      return launch_full_mode<M, Q, 0>(k, dc, ins, outs, stream, occ,
                                       voxels);
    case fabber::kPointZeroOne:
    case fabber::kFreduce:
      return launch_full_mode<M, Q, 1>(k, dc, ins, outs, stream, occ,
                                       voxels);
    default:
      return launch_full_mode<M, Q, 2>(k, dc, ins, outs, stream, occ,
                                       voxels);
  }
}

}  // namespace
