// fused_ar_loop: the whole fixed point of fixed-design VB with AR(1)
// noise (1 or 2 interleaved echoes, no cross terms) from its sufficient
// statistics, for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_loop_ar.py
// make_fused_ar_loop (its pallas_call at line 366; the step at lines
// 133-230) in both its modes: maxits (MODE 0) and the in-kernel
// pointzeroone / freduce detectors (MODE 1). Plain version:
// fabber_core_tpu_torch/ops/fused_loop_ar.py fused_ar_loop_plain.
//
// One thread per voxel; the statistics m0 [P], r0'M_s r0 [S], D'M_s r0
// [S][P] (S = 3 NQ, made beforehand by noise/ar1.py make_design_stats)
// and the priors are read once, coalesced (voxels on the last axis), the
// state lives in registers, and the posterior and the AR noise state are
// written once. Per iteration, from the noise state (b, c, alpha mean,
// alpha var) of each echo group n:
//   theta  w = (phi_n, phi_n mu_n, phi_n (acov_n + mu_n^2)) per group,
//          prec = sum_s w_s D'M_sD + diag(pp), the jitter-retry Cholesky
//          (vb_device.cuh), cov, means = cov (sum_s w_s D'M_sy + pp pm)
//          with the iteration-invariant D'M_sy = D'M_sr0 + D'M_sD m0
//   noise  op_s = r0'M_sr0 - 2 d'D'M_sr0 + sum_aj D'M_sD_aj (d_a d_j +
//          cov_aj), d = means - m0; aprec_n = ap_n + phi_n op_{3n+2},
//          acov_n = 1/aprec_n, mu_n = -phi_n op_{3n+1} acov_n / 2,
//          tmp1_n = op_{3n} + mu_n op_{3n+1} + (acov_n + mu_n^2)
//          op_{3n+2}, b_n = 1/(tmp1_n/2 + 1/b0_n), c_n = c_post_n
// starting from zero means, zero alpha means and the model-default noise
// (b_init, c_init, acov_init, aprec_init). MODE 1 computes the degenerate
// AR(1) ELBO at each new state (fused_loop_ar.py:202-223; its
// Gamma-function terms in the host constant f_const) and runs the
// detector's lane state machine (detectors.cuh) in the engine's order:
// the update, F, the test; a lane whose test says done leaves its loop
// (the TPU kernel's freeze). Neither pointzeroone nor freduce sets the
// save flag (the launch refuses init_save), so the best copy of the
// engine's save/revert protocol is always the engine-initial state: a
// freduce revert selects it, and the kernel writes the initial planes
// (zero means, prec, cov; the initial noise) with b negated, for the
// engine to restore from its own initial posterior (fused_loop_ar.py:
// 325-350). MODE 1 also writes the lane's last F and iteration count.
//
// Built with -fmad=false (ops/_cuda.py SOURCE_FLAGS), and with no
// explicit multiply-add: it computes the plain version's float32
// arithmetic bit for bit on the card. With the raw degree-2 poly design
// (t^2 to 11,236 at T=106, D'M_sD ~ 1e10) the noise quadratics op_s, and
// with them the precision (the lag specs' D'M_sD enter with signs),
// cancel heavily in float32, and which lanes land worst depends on the
// rounding. Fused multiply-adds round differently, and on an H100 they
// put some lane past its near_f64 bound: nvcc's own contraction, or
// explicit __fmaf_rn at the precision and D'M_sy, 1.18-1.37x in
// chip_smoke.py phase 3f; at the right-hand side, the means and MODE 1's
// dmsum alone, prec at 1.21x in tests/test_torch_cuda.py's P=4 detector
// case. Each grouping is a build of probes/csrc/fused_ar_loop.cu, this
// kernel with the sums written as madd<group> (probes/fmad_kernel9.py,
// PERF.md row 9): fused multiply-adds wait for a plain version that
// takes the same fused operations.
//
// Dropped TPU machinery: the ROWS=8 voxel fold and edge padding, the
// sublane-replicated constant column (the constants ride by value in
// ArConsts), the VMEM block picker and the float32 0/1-mask detector
// transcription (real bools and selects here).
//
// What bounds it on this card: per voxel it reads (P + 3NQ + 3NQ P + 2P)
// floats and writes (P + 2P^2 + 5NQ) (+2 in MODE 1): 47 planes at P=3,
// NQ=1, 64 at NQ=2, 0.94 / 1.28 ms at 16,777,216 voxels at 3.35 TB/s.
// The inputs are read once, up front, and the outputs written once at
// the end; in between each lane runs its ten ar_steps serially in
// registers: a P x P Cholesky and inverse plus ~2 S P^2 operations for
// the precision and the quadratics (S = 3NQ). So instruction issue
// bounds it, not bytes: on an NVIDIA H100 the builds of
// probes/fmad_kernel9.py ran in step with the SASS instructions of a
// step (at P=3, NQ=1 maxits 498 here, 420 with every group fused: 16%
// fewer and 14% faster; 389 contracted: 22% fewer and 18% faster), and
// each multiply-add left unfused is two instructions where the ops
// bound counts one. A MODE 1 warp runs until its slowest lane is done.
//
// A per-shape instance (ops/_cuda.py build_instance: this file compiled
// with FABBER_INST_P and FABBER_INST_Q, P 9 to 16, nq 1-2, still with
// -fmad=false) runs the same body (fused_ar_loop_wide_kernel) with
// WideArConsts: D'M_sD, 3 nq P^2 floats, read from a device buffer. A
// lane's packed state outgrows the registers there (it took 253 at P =
// 8, nq = 1), and ptxas keeps the rest in local memory.

#include <type_traits>

#include "detectors.cuh"
#include "vb_device.cuh"

// Every (P, NQ) fused_ar_loop.cu is compiled for, as X(P, NQ); each gives
// MODE 0 and MODE 1. This list is the one source of the C entry point's
// dispatch and of fabber_ar_has_instance, which the engine's route gate
// asks.
#define FABBER_AR_INSTANCES(X)                                    \
  X(1, 1) X(1, 2) X(2, 1) X(2, 2) X(3, 1) X(3, 2) X(4, 1) X(4, 2) \
  X(5, 1) X(5, 2) X(6, 1) X(6, 2) X(7, 1) X(7, 2) X(8, 1) X(8, 2)

namespace {

using namespace fabber;

constexpr int kThreads = 128;
constexpr int kAMaxP = 8;   // largest P of FABBER_AR_INSTANCES
constexpr int kAMaxQ = 2;   // largest NQ of FABBER_AR_INSTANCES
constexpr int kSpecs = 3;   // basis specs per echo group

// Everything a launch passes by value: D'M_sD ([S][P][P] row-major at the
// launch's P), the alpha prior precision diagonal, the per-group noise
// constants and initial state, the loop controls and, in MODE 1, the
// detector and the ELBO constants (110 floats of constants at P=4,
// NQ=2; dmd sized for P=8, NQ=2 makes the block about 1.6 KB, under the
// 4 KB of a launch's parameters).
struct ArConsts {
  float dmd[kSpecs * kAMaxQ * kAMaxP * kAMaxP];
  float ap[2];                 // alpha prior precision ap00, ap11
  float inv_b0[kAMaxQ];        // 1 / b0 of the noise prior
  float c_post[kAMaxQ];        // (ntimes - 1)/2 + c0
  float init_b[kAMaxQ];
  float init_c[kAMaxQ];
  float init_acov[kAMaxQ];
  float init_aprec[kAMaxQ];
  int n_iters;
  long long V;
  DetParams d;
  float f_const;               // voxel-invariant ELBO terms at c_post
  float lb_coeff;              // (ntimes - 1)/2 + c0, the log b coefficient
};

// A per-shape instance's largest P (the JAX engine's kernel 9 admits no
// larger P at one echo)
constexpr int kWideMaxP = 16;

// A per-shape instance's launch constants: ArConsts's, with D'M_sD
// ([S][P][P]) in a device buffer.
struct WideArConsts {
  DevRows dmd;
  float ap[2];
  float inv_b0[kAMaxQ];
  float c_post[kAMaxQ];
  float init_b[kAMaxQ];
  float init_c[kAMaxQ];
  float init_acov[kAMaxQ];
  float init_aprec[kAMaxQ];
  int n_iters;
  long long V;
  DetParams d;
  float f_const;
  float lb_coeff;
};

#define DMD(s, i, j) k.dmd[((s) * P + (i)) * P + (j)]

// The launch constants but D'M_sD from consts_host (the layout of
// fabber_fused_ar_loop's).
template <class K>
void fill_ar_consts(K& k, int n, int nq, int n_iters,
                    const float* consts_host, int det_kind, float det_tol,
                    int det_max_its, int det_max_trials, int det_init_save,
                    float f_const, float lb_coeff, long long V) {
  k.ap[0] = consts_host[n];
  k.ap[1] = consts_host[n + 1];
  for (int q = 0; q < nq; ++q) {
    k.inv_b0[q] = consts_host[n + 2 + q];
    k.c_post[q] = consts_host[n + 2 + nq + q];
    k.init_b[q] = consts_host[n + 2 + 2 * nq + q];
    k.init_c[q] = consts_host[n + 2 + 3 * nq + q];
    k.init_acov[q] = consts_host[n + 2 + 4 * nq + q];
    k.init_aprec[q] = consts_host[n + 2 + 5 * nq + q];
  }
  k.n_iters = n_iters;
  k.V = V;
  k.d = {det_kind, det_tol, det_max_its, det_max_trials, det_init_save};
  k.f_const = f_const;
  k.lb_coeff = lb_coeff;
}

// The lane's state: posterior (packed prec/cov) and the AR noise state
// per echo group.
template <int P, int NQ>
struct ArState {
  float means[P];
  float prec[P * (P + 1) / 2];
  float cov[P * (P + 1) / 2];
  float b[NQ], c[NQ], amu[NQ], acov[NQ], aprec[NQ];
};

// The engine-initial state as the kernel writes it: zero posterior
// planes (the TPU kernel's), zero alpha means and the model-default noise.
template <int P, int NQ, class K>
__device__ __forceinline__ void initial_state(const K& k,
                                              ArState<P, NQ>& st) {
#pragma unroll
  for (int i = 0; i < P; ++i) st.means[i] = 0.f;
#pragma unroll
  for (int i = 0; i < P * (P + 1) / 2; ++i) st.prec[i] = st.cov[i] = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    st.b[q] = k.init_b[q];
    st.c[q] = k.init_c[q];
    st.amu[q] = 0.f;
    st.acov[q] = k.init_acov[q];
    st.aprec[q] = k.init_aprec[q];
  }
}

// One fixed-point step from s's noise into n; tmp1 receives each group's
// phi-update quadratic and logdet log det prec (MODE 1's ELBO).
template <int P, int NQ, class K>
__device__ __forceinline__ void ar_step(
    const K& k, const float* m0, const float* rmr,
    const float (&dmr)[kSpecs * NQ][P], const float (&dmy)[kSpecs * NQ][P],
    const float* pm, const float* pp, const ArState<P, NQ>& s,
    ArState<P, NQ>& n, float* tmp1, float& logdet) {
  constexpr int S = kSpecs * NQ;
  constexpr int NT = P * (P + 1) / 2;
  float sici[NQ], w[S];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    sici[q] = s.b[q] * s.c[q];
    w[3 * q] = sici[q];
    w[3 * q + 1] = sici[q] * s.amu[q];
    w[3 * q + 2] = sici[q] * (s.acov[q] + s.amu[q] * s.amu[q]);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < S; ++t) v = v + w[t] * DMD(t, i, j);
      if (i == j) v = v + pp[i];
      n.prec[tri(i, j)] = v;
    }
  }
  float ch[NT];
  cholesky_jittered<P>(n.prec, ch);
  inverse_from_chol<P>(ch, n.cov);
  float rhs[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < S; ++t) v = v + w[t] * dmy[t][a];
    rhs[a] = v + pp[a] * pm[a];
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) m = m + n.cov[tri(i, j)] * rhs[j];
    n.means[i] = m;
  }

  // noise quadratics: op_s = k'M_s k + tr(cov D'M_s D), with the
  // packed d d' + cov shared by every spec
  float d[P], ddc[NT], op[S];
#pragma unroll
  for (int a = 0; a < P; ++a) d[a] = n.means[a] - m0[a];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) ddc[tri(i, j)] = d[i] * d[j] + n.cov[tri(i, j)];
  }
#pragma unroll
  for (int t = 0; t < S; ++t) {
    float cross = 0.f;
#pragma unroll
    for (int a = 0; a < P; ++a) cross = cross + d[a] * dmr[t][a];
    float acc = rmr[t] - 2.f * cross;
#pragma unroll
    for (int a = 0; a < P; ++a) {
#pragma unroll
      for (int j = 0; j < P; ++j) acc = acc + DMD(t, a, j) * ddc[tri(a, j)];
    }
    op[t] = acc;
  }
  // alpha updates (diagonal), then phi with the new alpha marginals
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float aprec = k.ap[q] + sici[q] * op[3 * q + 2];
    const float acov = 1.f / aprec;
    const float amu = -0.5f * sici[q] * op[3 * q + 1] * acov;
    const float c2 = acov + amu * amu;
    const float t1 = op[3 * q] + amu * op[3 * q + 1] + c2 * op[3 * q + 2];
    n.aprec[q] = aprec;
    n.acov[q] = acov;
    n.amu[q] = amu;
    n.b[q] = 1.f / (t1 * 0.5f + k.inv_b0[q]);
    n.c[q] = k.c_post[q];
    tmp1[q] = t1;
  }
  float ld = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) ld = ld + 2.f * logf(ch[tri(i, i)]);
  logdet = ld;
}

// MODE 0: maxits; 1: pointzeroone / freduce.
template <int P, int NQ, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_ar_loop_kernel(const ArConsts k, const float* __restrict__ m0_in,
                     const float* __restrict__ rmr_in,
                     const float* __restrict__ dmr_in,
                     const float* __restrict__ pm_in,
                     const float* __restrict__ pp_in,
                     float* __restrict__ means_out,
                     float* __restrict__ prec_out,
                     float* __restrict__ cov_out,
                     float* __restrict__ amu_out,
                     float* __restrict__ acov_out,
                     float* __restrict__ aprec_out,
                     float* __restrict__ b_out, float* __restrict__ c_out,
                     float* __restrict__ f_out,
                     float* __restrict__ its_out) {
#include "fused_ar_loop_body.inc"
}

// A per-shape instance's kernel 9 (WideArConsts)
template <int P, int NQ, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_ar_loop_wide_kernel(const WideArConsts k, const float* __restrict__ m0_in,
                     const float* __restrict__ rmr_in,
                     const float* __restrict__ dmr_in,
                     const float* __restrict__ pm_in,
                     const float* __restrict__ pp_in,
                     float* __restrict__ means_out,
                     float* __restrict__ prec_out,
                     float* __restrict__ cov_out,
                     float* __restrict__ amu_out,
                     float* __restrict__ acov_out,
                     float* __restrict__ aprec_out,
                     float* __restrict__ b_out, float* __restrict__ c_out,
                     float* __restrict__ f_out,
                     float* __restrict__ its_out) {
#include "fused_ar_loop_body.inc"
}

#undef DMD

// ---- launch and C entry points ------------------------------------------

template <int P, int NQ, int MODE, class K>
void launch_ar_mode(const K& k, const float* const* ins, float* const* outs,
                    cudaStream_t stream) {
  const unsigned grid = (unsigned)((k.V + kThreads - 1) / kThreads);
  const auto kernel = [] {
    if constexpr (std::is_same_v<K, WideArConsts>)
      return fused_ar_loop_wide_kernel<P, NQ, MODE>;
    else
      return fused_ar_loop_kernel<P, NQ, MODE>;
  }();
  kernel<<<grid, kThreads, 0, stream>>>(
      k, ins[0], ins[1], ins[2], ins[3], ins[4], outs[0], outs[1], outs[2],
      outs[3], outs[4], outs[5], outs[6], outs[7], outs[8], outs[9]);
}

template <int P, int NQ, class K>
int launch_ar(const K& k, const float* const* ins, float* const* outs,
              cudaStream_t stream) {
  if (k.d.kind == kMaxits)
    launch_ar_mode<P, NQ, 0>(k, ins, outs, stream);
  else
    launch_ar_mode<P, NQ, 1>(k, ins, outs, stream);
  return (int)cudaGetLastError();
}

}  // namespace

#if !defined(FABBER_INST_P)
// 1 when fused_ar_loop.cu is compiled for (p, nq), else 0.
extern "C" int fabber_ar_has_instance(int p, int nq) {
#define FABBER_HAS(NP, NQ) \
  if (p == NP && nq == NQ) return 1;
  FABBER_AR_INSTANCES(FABBER_HAS)
#undef FABBER_HAS
  return 0;
}

// Kernel 9. (p, nq): one of FABBER_AR_INSTANCES. consts_host [3*nq*p*p +
// 2 + 6*nq] (host, by value: D'M_sD, ap00, ap11, then per group 1/b0,
// c_post, init_b, init_c, init_acov, init_aprec). det_kind: 0 maxits,
// 1 pointzeroone, 2 freduce (detectors.cuh), with the detector's
// tolerance, max_its, max_trials and initial save flag (must be 0), and
// the ELBO constants f_const, lb_coeff (unread under maxits). m0 [p,V],
// rmr [3nq,V], dmr [3nq,p,V], pm, pp [p,V] (device). Outputs (device,
// preallocated): means [p,V], prec, cov [p,p,V], amu, acov, aprec, b, c
// [nq,V]; under a detector f and its [1,V] (else null).
extern "C" int fabber_fused_ar_loop(
    int p, int nq, int n_iters, const float* consts_host, int det_kind,
    float det_tol, int det_max_its, int det_max_trials, int det_init_save,
    float f_const, float lb_coeff, const float* m0, const float* rmr,
    const float* dmr, const float* pm, const float* pp, long long V,
    float* means, float* prec, float* cov, float* amu, float* acov,
    float* aprec, float* b, float* c, float* f, float* its, void* stream) {
  if (p < 1 || p > kAMaxP || nq < 1 || nq > kAMaxQ || n_iters < 1 || V < 1 ||
      det_kind < kMaxits || det_kind > kFreduce ||
      (det_kind != kMaxits && (det_init_save != 0 || !f || !its)))
    return (int)cudaErrorInvalidValue;
  ArConsts k = {};
  const int n = kSpecs * nq * p * p;
  for (int i = 0; i < n; ++i) k.dmd[i] = consts_host[i];
  fill_ar_consts(k, n, nq, n_iters, consts_host, det_kind, det_tol,
                 det_max_its, det_max_trials, det_init_save, f_const,
                 lb_coeff, V);
  const float* const ins[5] = {m0, rmr, dmr, pm, pp};
  float* const outs[10] = {means, prec, cov, amu, acov, aprec, b, c, f, its};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABBER_LAUNCH(NP, NQ) \
  if (p == NP && nq == NQ) return launch_ar<NP, NQ>(k, ins, outs, s);
  FABBER_AR_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}
#else
// A per-shape instance's entry point (ops/_cuda.py build_instance, (P,
// nq) = (FABBER_INST_P, FABBER_INST_Q)): fabber_fused_ar_loop's arguments
// and, last before the stream, dmd [3*nq*p*p] (consts_host's first
// floats, on the device). Another (p, nq) returns cudaErrorInvalidValue.
extern "C" int fabber_inst_fused_ar_loop(
    int p, int nq, int n_iters, const float* consts_host, int det_kind,
    float det_tol, int det_max_its, int det_max_trials, int det_init_save,
    float f_const, float lb_coeff, const float* m0, const float* rmr,
    const float* dmr, const float* pm, const float* pp, long long V,
    float* means, float* prec, float* cov, float* amu, float* acov,
    float* aprec, float* b, float* c, float* f, float* its,
    const float* dmd, void* stream) {
  constexpr int P = FABBER_INST_P, NQ = FABBER_INST_Q;
  static_assert(P > kAMaxP && P <= kWideMaxP && NQ >= 1 && NQ <= kAMaxQ,
                "a kernel 9 instance past the prebuilt P");
  if (p != P || nq != NQ || n_iters < 1 || V < 1 || det_kind < kMaxits ||
      det_kind > kFreduce ||
      (det_kind != kMaxits && (det_init_save != 0 || !f || !its)))
    return (int)cudaErrorInvalidValue;
  WideArConsts k = {};
  k.dmd = DevRows{dmd};
  fill_ar_consts(k, kSpecs * NQ * P * P, NQ, n_iters, consts_host, det_kind,
                 det_tol, det_max_its, det_max_trials, det_init_save,
                 f_const, lb_coeff, V);
  const float* const ins[5] = {m0, rmr, dmr, pm, pp};
  float* const outs[10] = {means, prec, cov, amu, acov, aprec, b, c, f, its};
  return launch_ar<P, NQ>(k, ins, outs, static_cast<cudaStream_t>(stream));
}
#endif
