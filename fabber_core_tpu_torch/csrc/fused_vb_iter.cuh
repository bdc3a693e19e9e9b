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
// The per-lane form (a per-shape unit past ops/_cuda.py rolled_loops'
// sizes compiles the cooperative form below instead): one thread per
// voxel, state in registers:
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

#include "coop_device.cuh"
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

// ---- the cooperative form: past the per-lane sizes ---------------------
//
// The per-lane form keeps J'Q_qJ per group in one thread: Q P(P+1)/2 floats
// and as many again for the block sums, and the card reserves a kernel's
// local memory for every thread an SM could hold (2,048): about 29 KB a
// lane at P = 42, and the rolled loops that reach it index local memory.
// A unit past ops/_cuda.py rolled_loops' sizes (FABBER_ROLL_LOOPS: P >
// 16, or more than 600 per-group sums) launches this form instead: one
// warp (kCoopThreads) serves one voxel, a block each, and its state lives
// in the block's shared memory (CoopLayout), so a thread holds O(1)
// floats whatever P is.
//   pass A  per chunk of kCoopChunk samples each thread evaluates the
//           model at its sample (the Jacobian row into the chunk's
//           columns, r = y - g), then each thread sums its slice of the
//           packed sums over the chunk, kTB samples into a block sum and
//           the blocks into the total, the per-lane form's order: J'Q_qJ
//           and J'Q_q r per group, or, past kCoopFoldSums per-group sums,
//           folded into one A = sum_t w_t J_t J_t' and g = sum_t w_t J_t r
//           with w_t = sum_q phi_q w_tq (Q P(P+1)/2 sums would fill a
//           block's shared memory at Q = 35);
//   solve   prec and rhs (a thread per entry, per row), the column
//           Cholesky (the diagonal by one thread, the column below it a
//           row a thread, a barrier each), L^-1 a row a thread, cov an
//           entry a thread: each entry's arithmetic that of vb_device.cuh's
//           cholesky and inverse_from_chol; with LM the damped factor and
//           its solve (one thread);
//   pass B  k = r + J d per sample, per group k'Q_qk (a thread per group);
//   traces  tr(Sigma J'Q_qJ) a thread per group, from the pass A sums, or,
//           folded, a pass per group for J'Q_qJ alone (taken per sample,
//           J' Sigma J loses every digit to cancellation at P = 24, where
//           the covariance of twelve exponentials holds entries of 1e10);
//   pass C  (need_f) the same at the new means.
// No warp shuffles: the threads meet at __syncthreads, so the host shim
// (tests/torch_hostcc.py) runs a block's threads as lanes. The pieces it
// shares with kernel 6's full-time form (the chunk sums, the column
// Cholesky, the inverse, the traces) live in coop_device.cuh. The bound of
// the form is its shared memory: kCoopMaxP (vb_device.cuh) is the largest
// P whose folded state one block holds.
// true in a unit that launches this form, false in one that launches the
// per-lane form; the unit's C entry points report it
// (fabber_inst_vb_iter_coop, fabber_gen_vb_iter_coop), and a launch takes
// its vb from that answer (ops/fused_vb.py iteration_form)
#if defined(FABBER_ROLL_LOOPS)
constexpr bool kIterCoop = true;
#else
constexpr bool kIterCoop = false;
#endif
constexpr int kCoopFoldSums = 1024;

template <int P, int Q>
constexpr bool coop_folded = Q * (P * (P + 1) / 2) > kCoopFoldSums;

// One voxel's shared memory (floats): the pass sums, the chunk, the
// solve's four packed matrices and the vectors
template <int P, int Q>
struct CoopLayout {
  static constexpr int NT = P * (P + 1) / 2;
  static constexpr int K = coop_folded<P, Q> ? 1 : Q;   // pass-A sums
  static constexpr int JS = kCoopChunk + 1;   // a Jacobian row's stride
  static constexpr int sums = 0;              // [K][NT]
  static constexpr int jtr = sums + K * NT;   // [K][P]
  static constexpr int jac = jtr + K * P;     // [P][JS]
  static constexpr int wts = jac + P * JS;     // [K][kCoopChunk]
  static constexpr int res = wts + K * kCoopChunk;   // [kCoopChunk]
  static constexpr int prec = res + kCoopChunk;      // [NT] each
  static constexpr int ch = prec + NT;
  static constexpr int inv = ch + NT;         // L^-1; the LM damped matrix
  static constexpr int cov = inv + NT;
  static constexpr int vec = cov + NT;        // [P] each
  static constexpr int centre = vec, pm = vec + P, pp = vec + 2 * P,
                       mrow = vec + 3 * P, chain = vec + 4 * P,
                       rhs = vec + 5 * P, means = vec + 6 * P,
                       d = vec + 7 * P, x = vec + 8 * P;
  static constexpr int grp = vec + 9 * P;     // [Q] each
  static constexpr int phi = grp, nkqk = grp + Q, ntr = grp + 2 * Q,
                       fkqk = grp + 3 * Q, ftr = grp + 4 * Q;
  static constexpr int floats = grp + 5 * Q;
  static constexpr long long bytes = 4LL * floats;
};
static_assert(CoopLayout<nl::kCoopMaxP, nl::kWideMaxQ>::bytes <=
                      kMaxBlockSmem &&
                  CoopLayout<nl::kCoopMaxP + 1, nl::kWideMaxQ>::bytes >
                      kMaxBlockSmem,
              "kCoopMaxP: the largest P whose state one block holds");

// One chunk [t0, t0 + nc): thread c < nc evaluates the model at sample t0
// + c (rows mrow, chain): its Jacobian row into column c of jac (JAC),
// r = y - g into res[c], or with a step d (STEP) k^2, k = r + J d. WMODE
// 1: the folded weight sum_q phi_q w_tq into wts[c]; 2: the Q group
// weights into wts[q][c]; 3: group q's weight into wts[c]; 0: none.
template <class M, int Q, bool JAC, bool STEP, int WMODE>
__device__ __forceinline__ void coop_chunk(const float* mrow,
                                           const float* chain, float dt,
                                           const float* __restrict__ data,
                                           const float* __restrict__ qw,
                                           long long V, long long v, int t0,
                                           int nc, const float* phi,
                                           const float* d, int q, float* jac,
                                           float* wts, float* res) {
  constexpr int P = M::P, JS = kCoopChunk + 1;
  const int c = (int)threadIdx.x;
  if (c < nc) {
    const int t = t0 + c;
    float row[P];
    const float sig = eval_latent<M>(mrow, chain, nullptr, (float)t, dt,
                                     row);
    float kk = __ldg(data + (size_t)t * V + v) - sig;
    if constexpr (JAC) {
      for (int i = 0; i < P; ++i) jac[i * JS + c] = row[i];
    }
    if constexpr (STEP) {
      for (int i = 0; i < P; ++i) kk = kk + row[i] * d[i];
      res[c] = kk * kk;
    } else {
      res[c] = kk;
    }
    if constexpr (WMODE == 1) {
      float w = 0.f;
      for (int g = 0; g < Q; ++g) w = w + phi[g] * __ldg(qw + t * Q + g);
      wts[c] = w;
    } else if constexpr (WMODE == 2) {
      for (int g = 0; g < Q; ++g)
        wts[g * kCoopChunk + c] = __ldg(qw + t * Q + g);
    } else if constexpr (WMODE == 3) {
      wts[c] = __ldg(qw + t * Q + q);
    }
  }
  __syncthreads();
}

// the folded form's traces at rows mrow, chain: a pass per group for
// J'Q_qJ alone (into buf), then its trace by one thread
template <class M, int Q>
__device__ __forceinline__ void coop_group_traces(
    const float* mrow, const float* chain, float dt,
    const float* __restrict__ data, const float* __restrict__ qw, int nt,
    long long V, long long v, const float* cov, float* buf, float* jac,
    float* wts, float* res, float* tr) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
  for (int q = 0; q < Q; ++q) {
    coop_zero(buf, NT);
    for (int t0 = 0; t0 < nt; t0 += kCoopChunk) {
      const int nc = min(kCoopChunk, nt - t0);
      coop_chunk<M, Q, true, false, 3>(mrow, chain, dt, data, qw, V, v, t0,
                                       nc, nullptr, nullptr, q, jac, wts,
                                       res);
      coop_sums<P>(buf, nullptr, 1, jac, wts, res, nc);
    }
    if (threadIdx.x == 0) tr[q] = trace_packed<P>(cov, buf);
    __syncthreads();
  }
}

// The cooperative form's kernel: fused_vb_iter_kernel's parameters and
// outputs; one voxel a block of kCoopThreads, CoopLayout's shared memory
template <class M, int Q, bool LM>
__global__ void __launch_bounds__(kCoopThreads)
fused_vb_iter_coop_kernel(const VBParamsFor<M::P, Q> k,
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
  using L = CoopLayout<P, Q>;
  constexpr bool FOLD = coop_folded<P, Q>;
  static_assert(M::NS == 0, "kernel 7 reads no suppdata");
  const long long V = k.V, v = blockIdx.x;
  const int tid = (int)threadIdx.x, nt = k.nt;
  float* const sh = dynamic_smem();
  float *sums = sh + L::sums, *jtr = sh + L::jtr, *jac = sh + L::jac,
        *wts = sh + L::wts, *res = sh + L::res, *prec = sh + L::prec,
        *ch = sh + L::ch, *inv = sh + L::inv, *cov = sh + L::cov;
  float *centre = sh + L::centre, *pm = sh + L::pm, *pp = sh + L::pp,
        *mrow = sh + L::mrow, *chain = sh + L::chain, *rhs = sh + L::rhs,
        *means = sh + L::means, *d = sh + L::d, *x = sh + L::x,
        *phi = sh + L::phi, *nkqk = sh + L::nkqk, *ntr = sh + L::ntr,
        *fkqk = sh + L::fkqk, *ftr = sh + L::ftr;

  for (int i = tid; i < P; i += kCoopThreads) {
    centre[i] = centre_in[(size_t)i * V + v];
    pm[i] = pm_in[(size_t)i * V + v];
    pp[i] = pp_in[(size_t)i * V + v];
    mrow[i] = to_model(k.tcode[i], centre[i]);
    chain[i] = chain_factor(k.tcode[i], centre[i]);
  }
  for (int q = tid; q < Q; q += kCoopThreads)
    phi[q] = phi_in[(size_t)q * V + v];
  __syncthreads();

  // ---- pass A: J'Q_qJ, J'Q_q r per group (folded: A, g) at the centre --
  coop_zero(sums, L::K * (NT + P));   // sums and jtr are adjacent
  for (int t0 = 0; t0 < nt; t0 += kCoopChunk) {
    const int nc = min(kCoopChunk, nt - t0);
    coop_chunk<M, Q, true, false, FOLD ? 1 : 2>(
        mrow, chain, k.dt, data, qw, V, v, t0, nc, phi, nullptr, 0, jac,
        wts, res);
    coop_sums<P>(sums, jtr, L::K, jac, wts, res, nc);
  }

  // ---- solve (Eq 19/20) --------------------------------------------------
  for (int e = tid; e < NT; e += kCoopThreads) {
    int i, j;
    untri(e, i, j);
    float val;
    if constexpr (FOLD) {
      val = sums[e] + (i == j ? pp[i] : 0.f);
    } else {
      val = 0.f;
      for (int q = 0; q < Q; ++q) val = val + phi[q] * sums[q * NT + e];
      if (i == j) val = val + pp[i];
    }
    prec[e] = val;
  }
  for (int a = tid; a < P; a += kCoopThreads) {
    float val;
    if constexpr (FOLD) {
      val = jtr[a];
      for (int j = 0; j < P; ++j) val = val + sums[tri(a, j)] * centre[j];
      val = val + pp[a] * pm[a];
    } else {
      val = 0.f;
      for (int q = 0; q < Q; ++q) {
        float g = jtr[q * P + a];
        for (int j = 0; j < P; ++j)
          g = g + sums[q * NT + tri(a, j)] * centre[j];
        val = val + phi[q] * g;
      }
      val = val + pp[a] * pm[a];
    }
    rhs[a] = val;
  }
  __syncthreads();
  coop_cholesky<P>(prec, ch);
  coop_inverse<P>(ch, inv, cov);
  for (int i = tid; i < P; i += kCoopThreads) {
    float m = 0.f;
    for (int j = 0; j < P; ++j) m = m + cov[tri(i, j)] * rhs[j];
    means[i] = m;
  }
  __syncthreads();
  if constexpr (LM) {
    const float alpha = alpha_in[v];
    if (alpha > 0.f) {   // the voxel's: the same in every thread
      float* damped = inv;   // free once cov is formed
      for (int e = tid; e < NT; e += kCoopThreads) {
        int i, j;
        untri(e, i, j);
        damped[e] = prec[e] + (i == j ? alpha * prec[tri(i, i)] : 0.f);
      }
      for (int i = tid; i < P; i += kCoopThreads) {
        float s;
        if constexpr (FOLD) {
          s = jtr[i];
        } else {
          s = 0.f;
          for (int q = 0; q < Q; ++q) s = s + phi[q] * jtr[q * P + i];
        }
        x[i] = s + pp[i] * (pm[i] - centre[i]);
      }
      __syncthreads();
      coop_cholesky<P>(damped, ch);
      if (tid == 0) {
        chol_solve<P>(ch, x);
        for (int i = 0; i < P; ++i) means[i] = centre[i] + x[i];
      }
      __syncthreads();
    }
  }

  // ---- pass B: k = r + J (centre - means) at the centre -----------------
  for (int i = tid; i < P; i += kCoopThreads) d[i] = centre[i] - means[i];
  coop_zero(nkqk, Q);
  for (int t0 = 0; t0 < nt; t0 += kCoopChunk) {
    const int nc = min(kCoopChunk, nt - t0);
    coop_chunk<M, Q, false, true, 0>(mrow, chain, k.dt, data, qw, V, v, t0,
                                     nc, phi, d, 0, jac, wts, res);
    coop_kqk<Q>(nkqk, qw, res, t0, nc);
  }
  if constexpr (FOLD) {
    coop_group_traces<M, Q>(mrow, chain, k.dt, data, qw, nt, V, v, cov,
                            sums, jac, wts, res, ntr);
  } else {
    coop_traces<P, Q>(cov, sums, ntr);
  }

  for (int i = tid; i < P; i += kCoopThreads)
    means_out[(size_t)i * V + v] = means[i];
  coop_store_full<P>(prec, prec_out, V, v);
  coop_store_full<P>(cov, cov_out, V, v);

  // ---- pass C: free-energy quadratics at the new means ------------------
  if (k.need_f) {
    for (int i = tid; i < P; i += kCoopThreads) {
      mrow[i] = to_model(k.tcode[i], means[i]);
      chain[i] = chain_factor(k.tcode[i], means[i]);
    }
    coop_zero(fkqk, Q);
    if constexpr (!FOLD) coop_zero(sums, Q * NT);
    for (int t0 = 0; t0 < nt; t0 += kCoopChunk) {
      const int nc = min(kCoopChunk, nt - t0);
      if constexpr (FOLD) {
        coop_chunk<M, Q, false, false, 0>(mrow, chain, k.dt, data, qw, V, v,
                                          t0, nc, phi, nullptr, 0, jac, wts,
                                          res);
      } else {
        coop_chunk<M, Q, true, false, 2>(mrow, chain, k.dt, data, qw, V, v,
                                         t0, nc, phi, nullptr, 0, jac, wts,
                                         res);
        coop_sums<P>(sums, nullptr, Q, jac, wts, res, nc);
      }
      // k^2 in place of r for the group sums
      if (tid < nc) res[tid] = res[tid] * res[tid];
      __syncthreads();
      coop_kqk<Q>(fkqk, qw, res, t0, nc);
    }
    if constexpr (FOLD) {
      coop_group_traces<M, Q>(mrow, chain, k.dt, data, qw, nt, V, v, cov,
                              sums, jac, wts, res, ftr);
    } else {
      coop_traces<P, Q>(cov, sums, ftr);
    }
  } else {
    for (int q = tid; q < Q; q += kCoopThreads) fkqk[q] = ftr[q] = 0.f;
    __syncthreads();
  }
  for (int q = tid; q < Q; q += kCoopThreads) {
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
// smem bytes of dynamic shared memory.
template <class M, int Q, bool LM, bool STAGED, class HK>
int launch_form(const HK& k, int vb, long long smem,
                const float* const* ins, float* const* outs,
                cudaStream_t stream, int* occ) {
  const auto kernel = fused_vb_iter_kernel<M, Q, LM, STAGED>;
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

// The cooperative form's launch (one voxel a block of kCoopThreads, its
// CoopLayout in dynamic shared memory), or (occ not null) its blocks per
// SM; it reads the plane where it is, so vb must be 0.
template <class M, int Q, bool LM, class HK>
int launch_coop(const HK& k, int vb, const float* const* ins,
                float* const* outs, cudaStream_t stream, int* occ) {
  if (vb != 0) return (int)cudaErrorInvalidValue;
  const auto kernel = fused_vb_iter_coop_kernel<M, Q, LM>;
  constexpr long long smem = CoopLayout<M::P, Q>::bytes;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  if (occ != nullptr) {
    *occ = tile_occupancy(kernel, kCoopThreads, smem);
    return 0;
  }
  kernel<<<(unsigned)k.V, kCoopThreads, smem, stream>>>(
      params_for<M::P, Q>(k), ins[0], ins[1], ins[2], ins[3], ins[4], ins[5],
      ins[6], outs[0], outs[1], outs[2], outs[3], outs[4], outs[5],
      outs[6]);
  return (int)cudaGetLastError();
}

// a unit past ops/_cuda.py rolled_loops' sizes (FABBER_ROLL_LOOPS)
// compiles the cooperative form alone (kIterCoop), every other unit the
// per-lane one
template <class M, int Q, bool LM, class HK>
int launch_lm(const HK& k, int vb, long long smem,
              const float* const* ins, float* const* outs,
              cudaStream_t stream, int* occ) {
  if constexpr (kIterCoop)
    return launch_coop<M, Q, LM>(k, vb, ins, outs, stream, occ);
  else if (vb > 0)
    return launch_form<M, Q, LM, true>(k, vb, smem, ins, outs, stream, occ);
  else
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
