// fused_vb_iter: one white-noise VB iteration of a time-local nonlinear
// model, for Hopper (sm_90a).
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
// would be (P+1)*T*4 bytes per voxel (2 KB at biexp, T=100: 256 KB for
// a 128-thread block, more than a block's shared memory), so pass B
// re-evaluates the model at the centre instead: the same code on the
// same inputs gives the same J and r as pass A, and k is formed
// explicitly, as the plain version (and the TPU kernel) does.
//
// What bounds it on this card: 2 or 3 coalesced reads of the voxel's
// data column (4*T bytes each) and 2 or 3 model evaluations per sample.

#include "vb_device.cuh"

namespace {

using namespace fabber;

constexpr int kThreads = 128;

template <class M, int Q, bool LM>
__global__ void __launch_bounds__(kThreads)
fused_vb_iter_kernel(const VBParams k, const float* __restrict__ centre_in,
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
  const long long V = k.V;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;

  float centre[P], pm[P], pp[P], phi[Q];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    centre[i] = centre_in[(size_t)i * V + v];
    pm[i] = pm_in[(size_t)i * V + v];
    pp[i] = pp_in[(size_t)i * V + v];
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) phi[q] = phi_in[(size_t)q * V + v];

  // ---- pass A: J'Q_qJ, J'Q_q r at the centre ----------------------------
  float mrow[P], chain[P];
  model_rows<P>(k.tcode, centre, mrow, chain);
  float jtj[Q][NT], jtr[Q][P], unused[Q];
  zero_sums<P, Q>(jtj, jtr, unused);
  // two-level sums: kTB samples into block sums, blocks into the totals
  for (int t0 = 0; t0 < k.nt; t0 += kTB) {
    float bjtj[Q][NT], bjtr[Q][P], bunused[Q];
    zero_sums<P, Q>(bjtj, bjtr, bunused);
    const int t1 = min(t0 + kTB, k.nt);
    for (int t = t0; t < t1; ++t) {
      float jac[P];
      const float sig = eval_latent<M>(mrow, chain, (float)t, k.dt, jac);
      const float r = data[(size_t)t * V + v] - sig;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float w = __ldg(qw + t * Q + q);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float wj = w * jac[i];
#pragma unroll
          for (int j = 0; j <= i; ++j)
            bjtj[q][tri(i, j)] = bjtj[q][tri(i, j)] + wj * jac[j];
          bjtr[q][i] = bjtr[q][i] + wj * r;
        }
      }
    }
    add_sums<P, Q>(jtj, jtr, unused, bjtj, bjtr, bunused);
  }

  // ---- solve (Eq 19/20) --------------------------------------------------
  float prec[NT], cov[NT], means[P], ch[NT];
  posterior_solve<P, Q, false>(jtj, jtr, phi, centre, pm, pp, prec, cov,
                               means, ch);
  if constexpr (LM) {
    const float alpha = alpha_in[v];
    if (alpha > 0.f) {
      float damped[NT], dch[NT], x[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) s = s + phi[q] * jtr[q][i];
        x[i] = s + pp[i] * (pm[i] - centre[i]);
#pragma unroll
        for (int j = 0; j <= i; ++j)
          damped[tri(i, j)] =
              prec[tri(i, j)] + (i == j ? alpha * prec[tri(i, i)] : 0.f);
      }
      cholesky<P>(damped, 0.f, dch);
      chol_solve<P>(dch, x);
#pragma unroll
      for (int i = 0; i < P; ++i) means[i] = centre[i] + x[i];
    }
  }

  // ---- pass B: k = r + J (centre - means) at the centre -----------------
  float d[P];
#pragma unroll
  for (int i = 0; i < P; ++i) d[i] = centre[i] - means[i];
  float nkqk[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) nkqk[q] = 0.f;
  for (int t0 = 0; t0 < k.nt; t0 += kTB) {
    float bk[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) bk[q] = 0.f;
    const int t1 = min(t0 + kTB, k.nt);
    for (int t = t0; t < t1; ++t) {
      float jac[P];
      const float sig = eval_latent<M>(mrow, chain, (float)t, k.dt, jac);
      float kk = data[(size_t)t * V + v] - sig;
#pragma unroll
      for (int i = 0; i < P; ++i) kk = kk + jac[i] * d[i];
      const float k2 = kk * kk;
#pragma unroll
      for (int q = 0; q < Q; ++q) bk[q] = bk[q] + __ldg(qw + t * Q + q) * k2;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) nkqk[q] = nkqk[q] + bk[q];
  }

#pragma unroll
  for (int i = 0; i < P; ++i) means_out[(size_t)i * V + v] = means[i];
  store_full<P>(prec, prec_out, V, v);
  store_full<P>(cov, cov_out, V, v);

  // ---- pass C: free-energy quadratics at the new means ------------------
  float fkqk[Q], ftr[Q];
  if (k.need_f) {
    f_pass<M, Q>(k.tcode, k.dt, means, cov, Column<false>{data, qw, V, v},
                 k.nt, fkqk, ftr);
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) fkqk[q] = ftr[q] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    nkqk_out[(size_t)q * V + v] = nkqk[q];
    ntr_out[(size_t)q * V + v] = trace_packed<P>(cov, jtj[q]);
    fkqk_out[(size_t)q * V + v] = fkqk[q];
    ftr_out[(size_t)q * V + v] = ftr[q];
  }
}

// ---- launch and C entry point -------------------------------------------

template <class M, int Q>
int launch(const VBParams& k, const float* const* ins, float* const* outs,
           cudaStream_t stream) {
  const unsigned grid = (unsigned)((k.V + kThreads - 1) / kThreads);
  if (ins[6] == nullptr) {
    fused_vb_iter_kernel<M, Q, false><<<grid, kThreads, 0, stream>>>(
        k, ins[0], ins[1], ins[2], ins[3], ins[4], ins[5], ins[6], outs[0],
        outs[1], outs[2], outs[3], outs[4], outs[5], outs[6]);
  } else {
    fused_vb_iter_kernel<M, Q, true><<<grid, kThreads, 0, stream>>>(
        k, ins[0], ins[1], ins[2], ins[3], ins[4], ins[5], ins[6], outs[0],
        outs[1], outs[2], outs[3], outs[4], outs[5], outs[6]);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// (kind, p, q): one of FABBER_NL_INSTANCES (vb_device.cuh).
// tcodes_host [p] (host). centre, pm, pp [p,V]; phi [q,V]; data [nt,V];
// qw [nt,q]; alpha [V], the lm detector's damping, or null for the
// plain iteration (device). Outputs (device, preallocated): means [p,V],
// prec [p,p,V], cov [p,p,V], nkqk, ntr, fkqk, ftr [q,V] (the last two
// zero when need_f is 0).
extern "C" int fabber_fused_vb_iter(
    int kind, int p, int q, const int* tcodes_host, float dt, int need_f,
    const float* centre, const float* pm, const float* pp, const float* phi,
    const float* data, const float* qw, const float* alpha, int nt,
    long long V, float* means,
    float* prec, float* cov, float* nkqk, float* ntr, float* fkqk,
    float* ftr, void* stream) {
  if (p < 1 || p > kMaxP || q < 1 || q > kMaxQ || nt < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  VBParams k = {};
  for (int i = 0; i < p; ++i) k.tcode[i] = tcodes_host[i];
  k.dt = dt;
  k.need_f = need_f;
  k.nt = nt;
  k.V = V;
  const float* const ins[7] = {centre, pm, pp, phi, data, qw, alpha};
  float* const outs[7] = {means, prec, cov, nkqk, ntr, fkqk, ftr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABBER_LAUNCH(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP && q == NQ)  \
    return launch<MODEL, NQ>(k, ins, outs, s);
  FABBER_NL_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}
