// fused_loop: kernel 5, the whole maxits fixed point of fixed-design
// white-noise VB from sufficient statistics made beforehand, for Hopper
// (sm_90a). It replaces fabber_core_tpu/ops/fused_loop.py
// make_fused_vb_loop (its pallas_call at line 330, algebra
// make_plane_algebra at line 137); the statistics m0 [P,V], rtqr [Q,V]
// and dtqr [Q,P,V] come from noise/white.py make_design_stats. Plain
// version: fabber_core_tpu_torch/ops/fused_loop.py fused_vb_loop_plain.
//
// One thread per voxel: it reads the voxel's statistics and priors, runs
// n_iters steps of whole_device.cuh whole_step (the fixed point kernel 4
// runs after its statistics) in registers from zero means and the noise
// at (b_init, c_init), and writes the posterior once.
//
// What bounds it on this card: per voxel it reads (P + Q + QP + 2P)*4
// bytes and writes (P + 2P^2 + 2Q)*4: 168 B at P=3, Q=2, 0.841 ms at
// 16,777,216 voxels at 3.35 TB/s (chip_smoke.py phase 5d). Its ten
// steps are ~240 float operations each there (chip_smoke.py whole_ops),
// 0.605 ms at the float32 peak, but what they cost is instructions: a
// step is a dependent chain whose IEEE square roots, reciprocals and
// divisions are multi-instruction sequences with slow-path tests, 400
// SASS instructions in all with kernel 4's step (nvcc already shares the
// diagonal reciprocals and drops the unread logdet). Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (probes/loop_kernel5.py, two runs),
// with kernel 4's step: 1.656-1.660 ms; the same steps with the reads
// and writes kept in L2 1.666-1.670; the reads and writes alone
// 1.015-1.016; capped at 8, 6, 4 and 2 blocks per SM (of 9) 1.681-1.683,
// 1.790, 2.172-2.175 and 3.622-3.623. So it is bound by instruction
// throughput, its loads and stores already hidden behind the steps, and the
// design takes instructions out of the step: whole_step's LEAN form
// multiplies by the factor's diagonal reciprocals where kernel 4
// divides, and sums the noise update's quadratic and trace over the
// P(P+1)/2 distinct terms (dsym, taken once per voxel before the loop):
// 343 instructions a step, 64 registers (8 blocks of 128 per SM),
// 1.433-1.441 ms (1.427 in L2), held to the plain version at float64 as
// tightly as kernel 4's step (near_f64). No fast-math: the square roots
// and the remaining reciprocals stay IEEE (rsqrtf for the diagonal would
// take a step to 225 instructions and 1.234 ms, but MUFU.RSQ is no
// correctly rounded square root, turns a zero pivot into a jitter retry
// and came to 0.83 of near_f64's bound in phase 3d's cases, against
// 0.50).
//
// A per-shape instance (ops/_cuda.py build_instance, with fused_whole.cu:
// any (P, Q) with P <= 20, Q <= 4 outside FABBER_WHOLE_INSTANCES; the
// engine's gate serves P <= 17) runs the same body with WideConsts, D'Q_qD
// from a device buffer (fused_loop_wide_kernel).

#include <type_traits>

#include "whole_device.cuh"

namespace {

constexpr int kThreads = 128;

// K: WholeConsts, or a per-shape instance's WideConsts.
template <int P, int Q, class K>
__device__ __forceinline__ void loop_body(
    const K& k, const float* __restrict__ m0_in,
    const float* __restrict__ rtqr_in, const float* __restrict__ dtqr_in,
    const float* __restrict__ pm_in, const float* __restrict__ pp_in,
    float* __restrict__ means_out, float* __restrict__ prec_out,
    float* __restrict__ cov_out, float* __restrict__ b_out,
    float* __restrict__ c_out) {
  constexpr int NT = P * (P + 1) / 2;
  const long long V = k.V;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;

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
  // D'Q_qy = D'Q_qr0 + (D'Q_qD) m0, iteration-invariant; dsym: D'Q_qD's
  // distinct terms, D_aa and D_aj + D_ja (j < a), for the LEAN step
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
        dsym[q][tri(a, j)] =
            a == j ? DTQD(q, a, a) : DTQD(q, a, j) + DTQD(q, j, a);
    }
  }

  WholeState<P, Q> st;
#pragma unroll
  for (int i = 0; i < P; ++i) st.means[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NT; ++i) st.prec[i] = st.cov[i] = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    st.b[q] = k.b_init[q];
    st.c[q] = k.c_init[q];
  }
  float kqk[Q], trq[Q], logdet;
  for (int it = 0; it < k.n_iters; ++it)
    whole_step<P, Q, true>(k, m0, rtqr, dtqr, dtqy, pm, pp, st, 0.f, st,
                           kqk, trq, logdet, &dsym[0][0]);

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
__global__ void __launch_bounds__(kThreads)
fused_loop_kernel(const WholeConsts k, const float* __restrict__ m0_in,
                  const float* __restrict__ rtqr_in,
                  const float* __restrict__ dtqr_in,
                  const float* __restrict__ pm_in,
                  const float* __restrict__ pp_in,
                  float* __restrict__ means_out, float* __restrict__ prec_out,
                  float* __restrict__ cov_out, float* __restrict__ b_out,
                  float* __restrict__ c_out) {
  loop_body<P, Q>(k, m0_in, rtqr_in, dtqr_in, pm_in, pp_in, means_out,
                  prec_out, cov_out, b_out, c_out);
}

// A per-shape instance's kernel 5 (WideConsts)
template <int P, int Q>
__global__ void __launch_bounds__(kThreads)
fused_loop_wide_kernel(const WideConsts k, const float* __restrict__ m0_in,
                       const float* __restrict__ rtqr_in,
                       const float* __restrict__ dtqr_in,
                       const float* __restrict__ pm_in,
                       const float* __restrict__ pp_in,
                       float* __restrict__ means_out,
                       float* __restrict__ prec_out,
                       float* __restrict__ cov_out, float* __restrict__ b_out,
                       float* __restrict__ c_out) {
  loop_body<P, Q>(k, m0_in, rtqr_in, dtqr_in, pm_in, pp_in, means_out,
                  prec_out, cov_out, b_out, c_out);
}

// ---- launch and C entry points ------------------------------------------

// One instance's launch, or (occ not null) its blocks per SM.
template <int P, int Q, class K>
int launch_loop(const K& k, const float* const* ins, float* const* outs,
                cudaStream_t stream, int* occ) {
  const auto kernel = [] {
    if constexpr (std::is_same_v<K, WideConsts>)
      return fused_loop_wide_kernel<P, Q>;
    else
      return fused_loop_kernel<P, Q>;
  }();
  if (occ != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel,
                                                              kThreads, 0);
  const unsigned grid = (unsigned)((k.V + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, stream>>>(k, ins[0], ins[1], ins[2], ins[3],
                                        ins[4], outs[0], outs[1], outs[2],
                                        outs[3], outs[4]);
  return (int)cudaGetLastError();
}

}  // namespace

#if !defined(FABBER_INST_P)
// Kernel 5. (p, q): one of FABBER_WHOLE_INSTANCES (whole_device.cuh);
// consts_host [q*p*p + 4q] (host, by value: D'Q_gD, then 1/b0, c_post,
// b_init, c_init per group). m0 [p,V], rtqr [q,V], dtqr [q,p,V], pm, pp
// [p,V] (device). Outputs (device, preallocated): means [p,V], prec, cov
// [p,p,V], b, c [q,V]. Other arguments return cudaErrorInvalidValue.
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
    return launch_loop<NP, NQ>(k, ins, outs, s, nullptr);
  FABBER_WHOLE_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM of kernel 5's (p, q) instance; -1 where (p, q) is not an
// instance or the CUDA call fails.
extern "C" int fabber_loop_occupancy(int p, int q) {
  int occ = 0;
#define FABBER_OCC(NP, NQ)                                                 \
  if (p == NP && q == NQ)                                                  \
    return launch_loop<NP, NQ>(WholeConsts{}, nullptr, nullptr, nullptr,   \
                               &occ) == 0                                  \
               ? occ                                                       \
               : -1;
  FABBER_WHOLE_INSTANCES(FABBER_OCC)
#undef FABBER_OCC
  return -1;
}
#else
// A per-shape instance's entry points (ops/_cuda.py build_instance, (P,
// Q) = (FABBER_INST_P, FABBER_INST_Q)): fabber_fused_vb_loop's arguments
// and, last before the stream, dtqd [q*p*p] (consts_host's first q*p*p
// floats, on the device). Another (p, q) returns cudaErrorInvalidValue.
extern "C" int fabber_inst_fused_vb_loop(
    int p, int q, int n_iters, float locked_sd, const float* consts_host,
    const float* m0, const float* rtqr, const float* dtqr, const float* pm,
    const float* pp, long long V, float* means, float* prec, float* cov,
    float* b, float* c, const float* dtqd_dev, void* stream) {
  constexpr int P = FABBER_INST_P, Q = FABBER_INST_Q;
  if (p != P || q != Q || n_iters < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  const WideConsts k = make_wide_consts(Q, n_iters, locked_sd, consts_host,
                                        dtqd_dev, Q * P * P, 1, V);
  const float* const ins[5] = {m0, rtqr, dtqr, pm, pp};
  float* const outs[5] = {means, prec, cov, b, c};
  return launch_loop<P, Q>(k, ins, outs, static_cast<cudaStream_t>(stream),
                           nullptr);
}

// fabber_loop_occupancy for this instance
extern "C" int fabber_inst_loop_occupancy(int p, int q) {
  constexpr int P = FABBER_INST_P, Q = FABBER_INST_Q;
  if (p != P || q != Q) return -1;
  int occ = 0;
  return launch_loop<P, Q>(WideConsts{}, nullptr, nullptr, nullptr, &occ) ==
                 0
             ? occ
             : -1;
}
#endif
