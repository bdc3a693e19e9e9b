// fused_nl_loop: the whole maxits VB loop of a time-local nonlinear model
// with white noise, for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_loop_nl.py
// make_fused_nl_loop (its pallas_call at line 890) in time_signal mode
// with no in-kernel detector (maxits). Plain version:
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
// Dropped TPU machinery: the [TB,B] partial-sum planes (the time sums
// are two-level in registers instead: kTB = 8 samples into block sums,
// blocks into the totals, which keeps the accuracy the partial planes
// gave), the edge-padded time axis (the [T,Q] group weights carry
// masked samples as 0; the last block runs short), the 1024-voxel
// padding (a bounds check masks the ragged last block) and the [4Q,1]
// constant column (the constants ride by value).
//
// What bounds it on this card: the data column is read n_iters + 1
// times (once per iteration, once for F), 4*T bytes per voxel each
// time, coalesced across the warp (voxels on the last axis). At
// 4,000,000 voxels the 1.6 GB plane is far above the 50 MB L2, so each
// pass goes to HBM. Per sample and iteration the arithmetic is one
// model evaluation (NEXP expf for exp-sum models) plus
// Q*(P(P+1)/2 + P + 1) multiply-adds. The data tile is not staged in
// shared memory yet (a later change could read it once).

#include "vb_device.cuh"

namespace {

using namespace fabber;

constexpr int kThreads = 128;

template <class M, int Q>
__global__ void __launch_bounds__(kThreads)
fused_nl_loop_kernel(const VBParams k, const float* __restrict__ centre0,
                     const float* __restrict__ pm_in,
                     const float* __restrict__ pp_in,
                     const float* __restrict__ data,
                     const float* __restrict__ qw,
                     float* __restrict__ means_out,
                     float* __restrict__ prec_out,
                     float* __restrict__ cov_out, float* __restrict__ b_out,
                     float* __restrict__ c_out, float* __restrict__ fkqk_out,
                     float* __restrict__ ftr_out) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
  const long long V = k.V;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;

  float centre[P], pm[P], pp[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    centre[i] = centre0[(size_t)i * V + v];
    pm[i] = pm_in[(size_t)i * V + v];
    pp[i] = pp_in[(size_t)i * V + v];
  }
  float b[Q], c[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    b[q] = k.b_init[q];
    c[q] = k.c_init[q];
  }
  float prec[NT], cov[NT], means[P];
#pragma unroll
  for (int i = 0; i < NT; ++i) prec[i] = cov[i] = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) means[i] = centre[i];

  for (int it = 0; it < k.n_iters; ++it) {
    float phi[Q];
#pragma unroll
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
        const float sig = eval_latent<M>(mrow, chain, (float)t, k.dt, jac);
        const float r = data[(size_t)t * V + v] - sig;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float w = __ldg(qw + t * Q + q);
          const float wr = w * r;
#pragma unroll
          for (int i = 0; i < P; ++i) {
            const float wj = w * jac[i];
#pragma unroll
            for (int j = 0; j <= i; ++j)
              bjtj[q][tri(i, j)] = bjtj[q][tri(i, j)] + wj * jac[j];
            bjtr[q][i] = bjtr[q][i] + jac[i] * wr;
          }
          brqr[q] = brqr[q] + wr * r;
        }
      }
      add_sums<P, Q>(jtj, jtr, rqr, bjtj, bjtr, brqr);
    }

    // ---- solve (Eq 19/20) ----------------------------------------------
    posterior_solve<P, Q, true>(jtj, jtr, phi, centre, pm, pp, prec, cov,
                                means);

    // ---- k'Q_qk by exact expansion, then the phi update (Eq 21/22) ------
    float d[P];
#pragma unroll
    for (int i = 0; i < P; ++i) d[i] = centre[i] - means[i];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float kq = rqr[q];
#pragma unroll
      for (int a = 0; a < P; ++a) kq = kq + 2.f * d[a] * jtr[q][a];
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
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
#pragma unroll
    for (int i = 0; i < P; ++i) centre[i] = means[i];
  }

#pragma unroll
  for (int i = 0; i < P; ++i) means_out[(size_t)i * V + v] = means[i];
  store_full<P>(prec, prec_out, V, v);
  store_full<P>(cov, cov_out, V, v);
  float fkqk[Q], ftr[Q];
  if (k.need_f) {
    f_pass<M, Q>(k.tcode, k.dt, means, cov, data, qw, k.nt, V, v, fkqk,
                 ftr);
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) fkqk[q] = ftr[q] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    b_out[(size_t)q * V + v] = b[q];
    c_out[(size_t)q * V + v] = c[q];
    fkqk_out[(size_t)q * V + v] = fkqk[q];
    ftr_out[(size_t)q * V + v] = ftr[q];
  }
}

// ---- launch and C entry point -------------------------------------------

template <class M, int Q>
int launch(const VBParams& k, const float* centre0, const float* pm,
           const float* pp, const float* data, const float* qw,
           float* const* outs, cudaStream_t stream) {
  const unsigned grid = (unsigned)((k.V + kThreads - 1) / kThreads);
  fused_nl_loop_kernel<M, Q><<<grid, kThreads, 0, stream>>>(
      k, centre0, pm, pp, data, qw, outs[0], outs[1], outs[2], outs[3],
      outs[4], outs[5], outs[6]);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when both nonlinear kernels are compiled for (kind, p, q), else 0.
extern "C" int fabber_nl_has_instance(int kind, int p, int q) {
#define FABBER_HAS(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP && q == NQ) return 1;
  FABBER_NL_INSTANCES(FABBER_HAS)
#undef FABBER_HAS
  return 0;
}

// (kind, p, q): one of FABBER_NL_INSTANCES (vb_device.cuh).
// tcodes_host [p], consts_host [4q] (1/b0, c_post, b_init, c_init per
// group) are host arrays copied into the by-value parameter block.
// centre0, pm, pp [p,V]; data [nt,V]; qw [nt,q] (device). Outputs
// (device, preallocated): means [p,V], prec [p,p,V], cov [p,p,V],
// b, c, fkqk, ftr [q,V].
extern "C" int fabber_fused_nl_loop(
    int kind, int p, int q, const int* tcodes_host, float dt, int n_iters,
    int need_f, float locked_sd, const float* consts_host,
    const float* centre0, const float* pm, const float* pp, const float* data,
    const float* qw, int nt, long long V, float* means, float* prec,
    float* cov, float* b, float* c, float* fkqk, float* ftr, void* stream) {
  if (p < 1 || p > kMaxP || q < 1 || q > kMaxQ || n_iters < 1 || nt < 1 ||
      V < 1)
    return (int)cudaErrorInvalidValue;
  VBParams k = {};
  for (int i = 0; i < p; ++i) k.tcode[i] = tcodes_host[i];
  k.dt = dt;
  k.n_iters = n_iters;
  k.need_f = need_f;
  k.locked_sd = locked_sd;
  for (int i = 0; i < q; ++i) {
    k.inv_b0[i] = consts_host[i];
    k.c_post[i] = consts_host[q + i];
    k.b_init[i] = consts_host[2 * q + i];
    k.c_init[i] = consts_host[3 * q + i];
  }
  k.nt = nt;
  k.V = V;
  float* const outs[7] = {means, prec, cov, b, c, fkqk, ftr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABBER_LAUNCH(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP && q == NQ)  \
    return launch<MODEL, NQ>(k, centre0, pm, pp, data, qw, outs, s);
  FABBER_NL_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}
