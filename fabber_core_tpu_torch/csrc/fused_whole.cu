// fused_whole: kernel 4, the whole fixed point of fixed-design
// white-noise VB with any number of noise groups, its statistics
// accumulated from the voxel's data column, for Hopper (sm_90a), as one
// per-voxel kernel. It replaces fabber_core_tpu/ops/fused_whole.py
// make_fused_whole_loop (its pallas_call at line 707); template MODE 0 is
// maxits, 1 the in-kernel pointzeroone detector, 2 trialmode and lm
// (with best-state copies and lm's damped update). Plain version:
// fabber_core_tpu_torch/ops/fused_whole.py fused_whole_plain. Its fixed
// point (the constants, the lane's state and one step) is shared with
// kernel 5 through whole_device.cuh; kernel 5, the same fixed point from
// statistics made beforehand, is fused_loop.cu.
//
// One thread per voxel; every statistic and the whole posterior live in
// registers. The statistics, per voxel (fused_whole.py:382-436):
//   pass 1  dty_a = sum_t (sum_q DW_q[a,t]) y[t]  (each sample lies in
//           one group or none, so the weight sum is exact)
//   solve   m0 by the jitter-retry Cholesky of the f32 A = sum_q
//           D'Q_qD (vb_device.cuh): the same f32 arithmetic that made
//           dty, or r0 is not f32-orthogonal to the design (a host-f64
//           inverse moved poly's posterior by 2%); non-finite -> 0
//   pass 2  about r0 = y - D m0: rtqr_q = sum_t q_q r0^2,
//           dtqr_{q,a} = sum_t DW_q[a,t] r0
// The (P + QP + Q) x T rows (D, DW_q = D*q_q, q_q) are staged in shared
// memory once per block (below: the staged form copies the data tile
// beside them). Then, with D'Q_qy = dtqr_q + D'Q_qD m0, each
// iteration (whole_device.cuh whole_step):
//   theta   prec = sum_q phi_q D'Q_qD + diag(pp), jitter-retry Cholesky,
//           cov, means = cov (sum_q phi_q D'Q_qy + pp pm); lm where
//           alpha > 0: means = centre + (prec + alpha diag prec)^-1
//           (sum_q phi_q (D'Q_qr0 - D'Q_qD (centre - m0)) + pp (pm -
//           centre)), prec and cov undamped
//   noise   k'Q_qk = rtqr_q - 2 d'D'Q_qr0 + d'D'Q_qDd (d = means - m0),
//           clamped at 0; tr_q = tr(Sigma D'Q_qD); b = 1/((k'Qk + tr)/2
//           + 1/b0), c = c_post; a locked sd gives b = 1/(c sd^2)
// starting from zero means and the noise at (b_init, c_init). Maxits
// writes the last iteration's (k'Q_qk, tr_q) beside the posterior; the
// engine assembles F from them. The detector modes compute F in-kernel
// at each new state (fused_whole.py:531-547; the Gamma-function terms at
// the fixed c_post in host constants, VBInference._nl_fdet_consts) and
// follow the engine's order (fused_whole.py:576-578): best-save where the
// last test set save, the update with the pre-test alpha, F, the test
// (detectors.cuh); a lane whose test says done leaves its loop. After
// the loop the engine's finalize (best <- final where save, final <-
// best where revert). Those modes write F and the lane's iteration
// count in place of the quadratics.
//
// Dropped TPU machinery: the ROWS=8 voxel fold and its sublane-
// replicated constant columns (constants ride by value), the 128-padded
// time axis (the rows carry exactly T samples), the VMEM block picker
// (the engine's gate checks the rows fit a block's shared memory), the
// float32 0/1-mask detector transcription, the concrete-layout anchors
// and the tile-wide early exit (each thread leaves its own loop).
//
// What bounds it on this card: it reads the [T,V] data, 4*T bytes per
// voxel, and writes (2P^2 + P + 4Q)*4 bytes. Per iteration the
// arithmetic is a P x P Cholesky, inverse and a few Q*P^2 products,
// ~200-400 operations at P=3, so with the maxits 10 iterations it stays
// below the bytes bound; a detector mode's warp runs to its slowest lane.
//
// Design for this card (tile.cuh): the statistics read the voxel's
// column twice (pass 1 for dty, pass 2 for r0 = y - D m0). Streamed, in
// blocks of 128 lanes, the column goes to HBM in pass 1 and, once the
// resident blocks' columns overflow the 50 MB L2, again in pass 2. The
// staged form (template STAGED) copies the block's [T, VB] tile into
// shared memory once, with cp.async, beside the design rows (one copy
// per block, as the tile's weights), and both passes read it there:
// HBM sees the plane once. ops/_cuda.py tile_plan stages in one-warp
// blocks (VB = 32) where at least five fit an SM (4 (T VB + (P + QP +
// Q) T) bytes: 18,232 at T=106, P=3, Q=2: 12 blocks per SM), else the
// streamed form serves (poly at 16,777,216 voxels on an NVIDIA H100 80GB
// HBM3, chip_smoke.py phase 5d: maxits 5.51 ms staged against 7.84
// streamed at Q=1, 7.71 against 9.51 at Q=2). The two forms run the same
// arithmetic in the same order. Built with -DFABBER_WHOLE_CONST_ROWS
// (probes/whole_rows.py), the staged form reads the design rows from
// __constant__ memory instead (a broadcast: every lane of a warp reads
// the same rows[t]), copied there on the launch's stream, and stages
// the tile alone: 16 blocks per SM, but maxits at Q=2 ran 4.4x slower
// there and trialmode 8%, so the rows stay in shared memory.
//
// A per-shape instance (ops/_cuda.py build_instance: this file compiled
// with FABBER_INST_P and FABBER_INST_Q, any (P, Q) with P <= 20, Q <= 4
// outside FABBER_WHOLE_INSTANCES) runs the same body
// (fused_whole_wide_kernel) with whole_device.cuh's WideConsts: D'Q_qD
// read from a device buffer. Past P = 8 a lane's packed state (prec, cov
// and the factor, P(P+1)/2 floats each, 136 at P = 16; MODE 2 keeps a
// best copy too) outgrows the registers and ptxas keeps the rest in
// local memory; the operations a step bound it, about P^3/2.

#include <type_traits>

#include "whole_device.cuh"

namespace {

constexpr int kThreads = 128;

#if defined(FABBER_WHOLE_CONST_ROWS)
// the staged form's design rows (kernel 4), copied by the C entry point
constexpr int kConstRows = 16000;   // floats (64,000 B)
__constant__ float c_rows[kConstRows];
#endif

// Kernel 4's statistics of one voxel from its data column col (tile.cuh:
// the block's shared tile or the plane) and the design rows.
template <int P, int Q, class C, class K>
__device__ __forceinline__ void whole_stats(const K& k,
                                            const float* rows, const C& col,
                                            float* m0, float* rtqr,
                                            float (&dtqr)[Q][P]) {
  const int T = k.nt;
  const float* dcol = rows;                  // [P][T]
  const float* dwq = rows + P * T;           // [Q][P][T]
  const float* qrow = rows + (P + Q * P) * T;  // [Q][T]

  float dty[P];
#pragma unroll
  for (int a = 0; a < P; ++a) dty[a] = 0.f;
#pragma unroll 2
  for (int t = 0; t < T; ++t) {
    const float y = col.sample(t);
#pragma unroll
    for (int a = 0; a < P; ++a) {
      float w = dwq[a * T + t];
#pragma unroll
      for (int q = 1; q < Q; ++q) w = w + dwq[(q * P + a) * T + t];
      dty[a] = fmaf(w, y, dty[a]);
    }
  }

  constexpr int NT = P * (P + 1) / 2;
  float amat[NT], ch[NT];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q) s = s + DTQD(q, i, j);
      amat[tri(i, j)] = s;
    }
  }
  cholesky_jittered<P>(amat, ch);
#pragma unroll
  for (int a = 0; a < P; ++a) m0[a] = dty[a];
  chol_solve<P>(ch, m0);
  bool ok = true;
#pragma unroll
  for (int a = 0; a < P; ++a) ok = ok && isfinite(m0[a]);
#pragma unroll
  for (int a = 0; a < P; ++a) m0[a] = ok ? m0[a] : 0.f;

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    rtqr[q] = 0.f;
#pragma unroll
    for (int a = 0; a < P; ++a) dtqr[q][a] = 0.f;
  }
#pragma unroll 2
  for (int t = 0; t < T; ++t) {
    float r = col.sample(t);
#pragma unroll
    for (int a = 0; a < P; ++a) r = r - dcol[a * T + t] * m0[a];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      rtqr[q] = fmaf(qrow[q * T + t] * r, r, rtqr[q]);
#pragma unroll
      for (int a = 0; a < P; ++a)
        dtqr[q][a] = fmaf(dwq[(q * P + a) * T + t], r, dtqr[q][a]);
    }
  }
}

// Kernel 4's data column and design rows (col.w). Staged: the block's
// tile and the rows in dynamic shared memory (tile.cuh; the rows in
// __constant__ memory with FABBER_WHOLE_CONST_ROWS). Streamed: the plane
// in global memory and the rows copied into shared memory by the block.
// Every thread of the block takes part, those past V included.
template <bool STAGED>
__device__ __forceinline__ Column<STAGED> whole_column(
    const float* __restrict__ data, const float* __restrict__ tconsts,
    int nt, int nrows, long long V, long long v) {
  if constexpr (STAGED) {
#if defined(FABBER_WHOLE_CONST_ROWS)
    Column<true> col = stage_column<true>(data, tconsts, nt, 0, V, v);
    col.w = c_rows;
    return col;
#else
    return stage_column<true>(data, tconsts, nt, nrows, V, v);
#endif
  } else {
    float* rows = dynamic_smem();
    for (int i = threadIdx.x; i < nrows; i += blockDim.x) rows[i] = tconsts[i];
    __syncthreads();
    return Column<false>{data, rows, V, v};
  }
}

// MODE 0: maxits; 1: pointzeroone; 2: trialmode / lm. STAGED: the
// statistics read the block's shared tile (tile.cuh).
template <int P, int Q, int MODE, bool STAGED>
__global__ void __launch_bounds__(kThreads)
fused_whole_kernel(const WholeConsts k, const float* __restrict__ data,
                   const float* __restrict__ tconsts,
                   const float* __restrict__ pm_in,
                   const float* __restrict__ pp_in,
                   float* __restrict__ means_out,
                   float* __restrict__ prec_out,
                   float* __restrict__ cov_out, float* __restrict__ b_out,
                   float* __restrict__ c_out, float* __restrict__ fkqk_out,
                   float* __restrict__ ftr_out) {
#include "fused_whole_body.inc"
}

// A per-shape instance's kernel 4 (WideConsts)
template <int P, int Q, int MODE, bool STAGED>
__global__ void __launch_bounds__(kThreads)
fused_whole_wide_kernel(const WideConsts k, const float* __restrict__ data,
                        const float* __restrict__ tconsts,
                        const float* __restrict__ pm_in,
                        const float* __restrict__ pp_in,
                        float* __restrict__ means_out,
                        float* __restrict__ prec_out,
                        float* __restrict__ cov_out,
                        float* __restrict__ b_out, float* __restrict__ c_out,
                        float* __restrict__ fkqk_out,
                        float* __restrict__ ftr_out) {
#include "fused_whole_body.inc"
}

// ---- launch and C entry points ------------------------------------------

// Kernel 4's dynamic shared memory at (vb, nt) with nrows design-row
// floats: streamed (vb 0) the rows; staged the [nt, vb] tile and the rows
// (the tile alone with FABBER_WHOLE_CONST_ROWS); -1 where refused
// (tile.cuh tile_bytes, or rows beyond a block's shared memory or the
// __constant__ array).
inline long long whole_smem(int vb, int nt, int nrows) {
  if (vb == 0) {
    const long long b = 4LL * nrows;
    return b <= kMaxBlockSmem ? b : -1;
  }
#if defined(FABBER_WHOLE_CONST_ROWS)
  if (nrows > kConstRows) return -1;
  return tile_bytes(vb, nt, 0, kThreads);
#else
  return tile_bytes(vb, nt, nrows, kThreads);
#endif
}

// One instance's launch, or (occ not null) its blocks per SM: STAGED in
// blocks of vb lanes, else blocks of kThreads; smem bytes of dynamic
// shared memory (raised above the 48 KB default before the launch).
template <int P, int Q, int MODE, bool STAGED, class K>
int launch_form(const K& k, int vb, long long smem, const float* const* ins,
                float* const* outs, cudaStream_t stream, int* occ) {
  const auto kernel = [] {
    if constexpr (std::is_same_v<K, WideConsts>)
      return fused_whole_wide_kernel<P, Q, MODE, STAGED>;
    else
      return fused_whole_kernel<P, Q, MODE, STAGED>;
  }();
  const int threads = STAGED ? vb : kThreads;
  if (STAGED || smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occ != nullptr) {
    *occ = tile_occupancy(kernel, threads, smem);
    return 0;
  }
  const unsigned grid = (unsigned)((k.V + threads - 1) / threads);
  kernel<<<grid, threads, smem, stream>>>(
      k, ins[0], ins[1], ins[2], ins[3], outs[0], outs[1], outs[2], outs[3],
      outs[4], outs[5], outs[6]);
  return (int)cudaGetLastError();
}

template <int P, int Q, int MODE, class K>
int launch_mode(const K& k, int vb, long long smem,
                const float* const* ins, float* const* outs,
                cudaStream_t stream, int* occ) {
  if (vb > 0)
    return launch_form<P, Q, MODE, true>(k, vb, smem, ins, outs, stream,
                                         occ);
  return launch_form<P, Q, MODE, false>(k, 0, smem, ins, outs, stream, occ);
}

// kernel 4 in the MODE of its detector (k.d.kind); occ: see launch_form
template <int P, int Q, class K>
int launch_whole(const K& k, int vb, long long smem,
                 const float* const* ins, float* const* outs,
                 cudaStream_t stream, int* occ = nullptr) {
  switch (k.d.kind) {
    case kMaxits:
      return launch_mode<P, Q, 0>(k, vb, smem, ins, outs, stream, occ);
    case kPointZeroOne:
      return launch_mode<P, Q, 1>(k, vb, smem, ins, outs, stream, occ);
    default:
      return launch_mode<P, Q, 2>(k, vb, smem, ins, outs, stream, occ);
  }
}

}  // namespace

#if !defined(FABBER_INST_P)
// 1 when kernels 4 and 5 (fused_whole.cu, fused_loop.cu) are compiled
// for (p, q), else 0.
extern "C" int fabber_whole_has_instance(int p, int q) {
#define FABBER_HAS(NP, NQ) \
  if (p == NP && q == NQ) return 1;
  FABBER_WHOLE_INSTANCES(FABBER_HAS)
#undef FABBER_HAS
  return 0;
}

// Kernel 4. (p, q): one of FABBER_WHOLE_INSTANCES. consts_host [q*p*p +
// 4q] (host, by value; see make_consts). det_kind: 0 maxits, 1
// pointzeroone, 3 trialmode, 4 lm (detectors.cuh; freduce is not served),
// with the detector's tolerance, max_its, max_trials, initial save flag
// and det_consts_host [q+1] (lb_coeff per group, f_const; unread under
// maxits). data [nt,V], tconsts [(p + q*p + q), nt] (D rows, D*q_g rows
// per group, q_g rows), pm, pp [p,V] (device). Outputs (device,
// preallocated): means [p,V], prec, cov [p,p,V], b, c [q,V]; fkqk, ftr
// [q,V] (maxits: the last iteration's k'Q_gk and tr(Sigma D'Q_gD)) or
// [1,V] (detector modes: F and the iteration count). vb: 0 streams the
// plane (blocks of 128, the rows in 4 (p + qp + q) nt bytes of shared
// memory); > 0 stages it in blocks of vb lanes (a multiple of 32, at most
// 128, with 4 (nt vb + (p + qp + q) nt) bytes of shared memory at most
// 232,448; ops/_cuda.py tile_plan); other values, or rows beyond a
// block's shared memory, return cudaErrorInvalidValue.
extern "C" int fabber_fused_whole(
    int p, int q, int n_iters, float locked_sd, const float* consts_host,
    int det_kind, float det_tol, int det_max_its, int det_max_trials,
    int det_init_save, const float* det_consts_host, const float* data,
    const float* tconsts, int nt, const float* pm, const float* pp,
    long long V, float* means, float* prec, float* cov, float* b, float* c,
    float* fkqk, float* ftr, int vb, void* stream) {
  if (p < 1 || p > kWMaxP || q < 1 || q > kWMaxQ || n_iters < 1 || nt < 1 ||
      V < 1 || det_kind < kMaxits || det_kind > kLM || det_kind == kFreduce)
    return (int)cudaErrorInvalidValue;
  const int nrows = (p + q * p + q) * nt;
  const long long smem = whole_smem(vb, nt, nrows);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  WholeConsts k = make_consts(p, q, n_iters, locked_sd, consts_host, nt, V);
  k.d = {det_kind, det_tol, det_max_its, det_max_trials, det_init_save};
  if (det_kind != kMaxits) {
    for (int i = 0; i < q; ++i) k.lb_coeff[i] = det_consts_host[i];
    k.f_const = det_consts_host[q];
  }
  const float* const ins[4] = {data, tconsts, pm, pp};
  float* const outs[7] = {means, prec, cov, b, c, fkqk, ftr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#if defined(FABBER_WHOLE_CONST_ROWS)
  if (vb > 0) {
    const cudaError_t e = cudaMemcpyToSymbolAsync(
        c_rows, tconsts, sizeof(float) * nrows, 0, cudaMemcpyDeviceToDevice,
        s);
    if (e != cudaSuccess) return (int)e;
  }
#endif
#define FABBER_LAUNCH(NP, NQ) \
  if (p == NP && q == NQ)     \
    return launch_whole<NP, NQ>(k, vb, smem, ins, outs, s);
  FABBER_WHOLE_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM of kernel 4's (p, q) instance in MODE mode (0 maxits, 1
// pointzeroone, 2 trialmode/lm) and the form vb selects
// (fabber_fused_whole's vb) at nt samples; -1 where the arguments are
// refused or the CUDA call fails.
extern "C" int fabber_whole_occupancy(int p, int q, int mode, int vb,
                                      int nt) {
  const long long smem = whole_smem(vb, nt, (p + q * p + q) * nt);
  if (smem < 0 || mode < 0 || mode > 2) return -1;
  WholeConsts k = {};
  k.d.kind = mode == 0 ? kMaxits : (mode == 1 ? kPointZeroOne : kTrialMode);
  int occ = 0;
#define FABBER_OCC(NP, NQ)                                                   \
  if (p == NP && q == NQ)                                                    \
    return launch_whole<NP, NQ>(k, vb, smem, nullptr, nullptr, nullptr,      \
                                &occ) == 0                                   \
               ? occ                                                         \
               : -1;
  FABBER_WHOLE_INSTANCES(FABBER_OCC)
#undef FABBER_OCC
  return -1;
}
#else
// A per-shape instance's entry points (ops/_cuda.py build_instance, (P,
// Q) = (FABBER_INST_P, FABBER_INST_Q)): fabber_fused_whole's arguments
// and, last before the stream, dtqd [q*p*p] (consts_host's first q*p*p
// floats, on the device). Another (p, q) returns cudaErrorInvalidValue.
extern "C" int fabber_inst_fused_whole(
    int p, int q, int n_iters, float locked_sd, const float* consts_host,
    int det_kind, float det_tol, int det_max_its, int det_max_trials,
    int det_init_save, const float* det_consts_host, const float* data,
    const float* tconsts, int nt, const float* pm, const float* pp,
    long long V, float* means, float* prec, float* cov, float* b, float* c,
    float* fkqk, float* ftr, int vb, const float* dtqd, void* stream) {
  constexpr int P = FABBER_INST_P, Q = FABBER_INST_Q;
  static_assert(P >= 1 && P <= kWideMaxP && Q >= 1 && Q <= kWideMaxQ,
                "a kernel 4 and 5 instance within their limits");
  if (p != P || q != Q || n_iters < 1 || nt < 1 || V < 1 ||
      det_kind < kMaxits || det_kind > kLM || det_kind == kFreduce)
    return (int)cudaErrorInvalidValue;
  const long long smem = whole_smem(vb, nt, (P + Q * P + Q) * nt);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  WideConsts k = make_wide_consts(Q, n_iters, locked_sd, consts_host, dtqd,
                                  Q * P * P, nt, V);
  k.d = {det_kind, det_tol, det_max_its, det_max_trials, det_init_save};
  if (det_kind != kMaxits) {
    for (int i = 0; i < Q; ++i) k.lb_coeff[i] = det_consts_host[i];
    k.f_const = det_consts_host[Q];
  }
  const float* const ins[4] = {data, tconsts, pm, pp};
  float* const outs[7] = {means, prec, cov, b, c, fkqk, ftr};
  return launch_whole<P, Q>(k, vb, smem, ins, outs,
                            static_cast<cudaStream_t>(stream));
}

// fabber_whole_occupancy for this instance
extern "C" int fabber_inst_whole_occupancy(int p, int q, int mode, int vb,
                                           int nt) {
  constexpr int P = FABBER_INST_P, Q = FABBER_INST_Q;
  const long long smem = whole_smem(vb, nt, (P + Q * P + Q) * nt);
  if (p != P || q != Q || smem < 0 || mode < 0 || mode > 2) return -1;
  WideConsts k = {};
  k.d.kind = mode == 0 ? kMaxits : (mode == 1 ? kPointZeroOne : kTrialMode);
  int occ = 0;
  return launch_whole<P, Q>(k, vb, smem, nullptr, nullptr, nullptr, &occ) ==
                 0
             ? occ
             : -1;
}
#endif
