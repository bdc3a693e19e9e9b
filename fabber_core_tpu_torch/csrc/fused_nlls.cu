// fused_nlls: the whole damped Gauss-Newton (NLLS) loop of a time-local
// nonlinear model, for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_nlls.py
// make_fused_nlls_loop (its pallas_call at line 426). Plain version:
// fabber_core_tpu_torch/ops/fused_nlls.py fused_nlls_loop_plain.
//
// One thread per voxel; the params, the packed lower triangle of J'J,
// J'r, the cost, lambda, the done flag and the step count live in
// registers. A pass over the T samples evaluates the model and its
// latent-space Jacobian at a point (vb_device.cuh functors and transform
// codes) and sums J'J, J'r and r'r over the unmasked samples (w in {0,1},
// folded into r once), two-level as the VB kernels sum (kTB samples into
// block sums, blocks into the totals). A step solves (J'J + lam damp)
// delta = J'r by vb_device.cuh's jitter-retry Cholesky (damp = I, or
// diag(J'J) with MARQ), evaluates the trial point and accepts it where
// its cost is finite and lower (lam *= shrink) or rejects it (lam *=
// grow); the lane is done past lam_max, at a relative gain <= cftol, or
// on a rejected plateau (lam >= plateau, trial within cftol of the cost).
// The constants come by value from the wrapper (its one copy).
//
// Modes (template MODE):
//   kFresh   the one-pass form: one pass at params0 seeds J'J, J'r and
//            the cost; each step passes once, at the trial point, and an
//            accepted trial's sums become the carry; the posterior uses
//            the carried J'J;
//   kPhase1  the same loop; params and state [4,V] = (lam, cost, done,
//            its) out, no posterior;
//   kResume  from state: the two-pass form (the sums at params, then the
//            trial's cost), then one more pass at the final params for
//            J'J and the posterior.
// Posterior: prec = J'J / (cost / dof) with diag floored at prec_floor
// (NaN kept), cov = prec^-1 through the jitter-retry factor.
//
// Phase 1 + resume gives the fresh launch's outputs bit for bit: a lane's
// trajectory depends on its own column only, every pass goes through one
// function in one summation order, and the source is compiled with
// -fmad=false (ops/_cuda.py SOURCE_FLAGS), so no call site or mode
// contracts a multiply-add the others do not (the cost-only pass of the
// resume form computes r'r as the full pass does).
//
// Dropped TPU machinery: the edge-padded time axis (the [T] weights carry
// masked samples as 0; the last block runs short), the [TB,B] partial-sum
// planes, the voxel padding to the block (a bounds check masks the ragged
// last block), the float32 0/1 masks standing in for bools, and the
// tile-wide early exit: each thread leaves its loop when its lane is done
// or has made max_its steps (a done lane never commits, so the outcome is
// the tile loop's).
//
// What bounds it on this card: each step reads the data column once
// (4*T bytes per voxel, coalesced across the warp, voxels on the last
// axis); at 4,000,000 voxels the 1.6 GB plane is far above the 50 MB L2,
// so every pass goes to HBM, 20-40 passes per voxel on biexp. Per sample
// and pass the arithmetic is one model evaluation (NEXP expf for exp-sum
// models) plus P(P+1)/2 + P + 1 multiply-adds. A warp runs until its
// slowest lane is done. Not staged in shared memory yet.

#include "vb_device.cuh"

namespace {

using namespace fabber;

constexpr int kThreads = 128;

enum Mode : int { kFresh = 0, kPhase1 = 1, kResume = 2 };

// Everything a launch passes by value.
struct NLLSParams {
  int tcode[kMaxP];
  float dt;
  int max_its;        // step budget (resume: the remaining one)
  float lam_init, grow, shrink, lam_max, prec_floor, cftol, plateau;
  float dof;          // unmasked samples - P (the mse divisor)
  int nt;
  long long V;
};

// J'J (packed), J'r and r'r at latent params x (JAC false: r'r alone,
// computed as the full pass computes it).
template <class M, bool JAC>
__device__ __forceinline__ void nlls_pass(const NLLSParams& k, const float* x,
                                          const float* __restrict__ data,
                                          const float* __restrict__ w,
                                          long long v, float* jtj, float* jtr,
                                          float& rr) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
  float mrow[P], chain[P];
  model_rows<P>(k.tcode, x, mrow, chain);
  float sjtj[NT], sjtr[P], srr = 0.f;
#pragma unroll
  for (int i = 0; i < NT; ++i) sjtj[i] = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) sjtr[i] = 0.f;
  for (int t0 = 0; t0 < k.nt; t0 += kTB) {
    float bjtj[NT], bjtr[P], brr = 0.f;
#pragma unroll
    for (int i = 0; i < NT; ++i) bjtj[i] = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) bjtr[i] = 0.f;
    const int t1 = min(t0 + kTB, k.nt);
    for (int t = t0; t < t1; ++t) {
      float jac[P];
      const float sig = eval_latent<M>(mrow, chain, (float)t, k.dt, jac);
      const float wt = __ldg(w + t);
      const float d = data[(size_t)t * k.V + v] - sig;
      const float r = wt * d;
      if constexpr (JAC) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float wj = wt * jac[i];
#pragma unroll
          for (int j = 0; j <= i; ++j)
            bjtj[tri(i, j)] = bjtj[tri(i, j)] + wj * jac[j];
          bjtr[i] = bjtr[i] + jac[i] * r;
        }
      }
      brr = brr + r * d;
    }
    srr = srr + brr;
    if constexpr (JAC) {
#pragma unroll
      for (int i = 0; i < NT; ++i) sjtj[i] = sjtj[i] + bjtj[i];
#pragma unroll
      for (int i = 0; i < P; ++i) sjtr[i] = sjtr[i] + bjtr[i];
    }
  }
  rr = srr;
  if constexpr (JAC) {
#pragma unroll
    for (int i = 0; i < NT; ++i) jtj[i] = sjtj[i];
#pragma unroll
    for (int i = 0; i < P; ++i) jtr[i] = sjtr[i];
  }
}

// trial = params + (J'J + lam damp)^-1 J'r
template <int P, bool MARQ>
__device__ __forceinline__ void solve_step(const float* jtj, const float* jtr,
                                           const float* params, float lam,
                                           float* trial) {
  constexpr int NT = P * (P + 1) / 2;
  float a[NT], ch[NT], delta[P];
#pragma unroll
  for (int i = 0; i < NT; ++i) a[i] = jtj[i];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    a[tri(i, i)] = jtj[tri(i, i)] + lam * (MARQ ? jtj[tri(i, i)] : 1.f);
    delta[i] = jtr[i];
  }
  cholesky_jittered<P>(a, ch);
  chol_solve<P>(ch, delta);
#pragma unroll
  for (int i = 0; i < P; ++i) trial[i] = params[i] + delta[i];
}

template <class M, int MODE, bool MARQ>
__global__ void __launch_bounds__(kThreads)
fused_nlls_kernel(const NLLSParams k, const float* __restrict__ params0,
                  const float* __restrict__ data, const float* __restrict__ w,
                  const float* __restrict__ state_in,
                  float* __restrict__ params_out, float* __restrict__ cost_out,
                  float* __restrict__ its_out, float* __restrict__ prec_out,
                  float* __restrict__ cov_out, float* __restrict__ state_out) {
  constexpr int P = M::P, NT = P * (P + 1) / 2;
  const long long V = k.V;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;

  float params[P], jtj[NT], jtr[P];
#pragma unroll
  for (int i = 0; i < P; ++i) params[i] = params0[(size_t)i * V + v];
  float cost, lam, its;
  bool done;
  if constexpr (MODE == kResume) {
    lam = state_in[v];
    cost = state_in[V + v];
    done = state_in[2 * V + v] > 0.5f;
    its = state_in[3 * V + v];
  } else {
    nlls_pass<M, true>(k, params, data, w, v, jtj, jtr, cost);
    lam = k.lam_init;
    done = false;
    its = 0.f;
  }

  for (int it = 0; it < k.max_its && !done; ++it) {
    float trial[P], tjtj[NT], tjtr[P], tcost;
    if constexpr (MODE == kResume) {
      float rr_here;
      nlls_pass<M, true>(k, params, data, w, v, jtj, jtr, rr_here);
      solve_step<P, MARQ>(jtj, jtr, params, lam, trial);
      nlls_pass<M, false>(k, trial, data, w, v, tjtj, tjtr, tcost);
    } else {
      solve_step<P, MARQ>(jtj, jtr, params, lam, trial);
      nlls_pass<M, true>(k, trial, data, w, v, tjtj, tjtr, tcost);
    }
    const bool fin = isfinite(tcost);
    const bool better = tcost < cost && fin;
    const float newl = better ? lam * k.shrink : lam * k.grow;
    const bool converged =
        better && cost - tcost <= k.cftol * fmaxf(fabsf(tcost), 1e-30f);
    const bool plateau =
        !better && fin && lam >= k.plateau &&
        tcost - cost <= k.cftol * fmaxf(fabsf(cost), 1e-30f);
    if (better) {
#pragma unroll
      for (int i = 0; i < P; ++i) params[i] = trial[i];
      cost = tcost;
      if constexpr (MODE != kResume) {
#pragma unroll
        for (int i = 0; i < NT; ++i) jtj[i] = tjtj[i];
#pragma unroll
        for (int i = 0; i < P; ++i) jtr[i] = tjtr[i];
      }
    }
    lam = newl;
    done = newl > k.lam_max || converged || plateau;
    its = its + 1.f;
  }

#pragma unroll
  for (int i = 0; i < P; ++i) params_out[(size_t)i * V + v] = params[i];
  if constexpr (MODE == kPhase1) {
    state_out[v] = lam;
    state_out[V + v] = cost;
    state_out[2 * V + v] = done ? 1.f : 0.f;
    state_out[3 * V + v] = its;
    return;
  }
  if constexpr (MODE == kResume) {
    float rr_final;
    nlls_pass<M, true>(k, params, data, w, v, jtj, jtr, rr_final);
  }
  const float mse = cost / k.dof;
  float prec[NT], ch[NT], cov[NT];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float val = jtj[tri(i, j)] / mse;
      // the floor keeps a NaN, as jnp.maximum does
      if (i == j && val < k.prec_floor) val = k.prec_floor;
      prec[tri(i, j)] = val;
    }
  }
  cholesky_jittered<P>(prec, ch);
  inverse_from_chol<P>(ch, cov);
  cost_out[v] = cost;
  its_out[v] = its;
  store_full<P>(prec, prec_out, V, v);
  store_full<P>(cov, cov_out, V, v);
}

// ---- launch and C entry point -------------------------------------------

template <class M, int MODE, bool MARQ>
int launch_mode(const NLLSParams& k, const float* const* ins,
                float* const* outs, cudaStream_t stream) {
  const unsigned grid = (unsigned)((k.V + kThreads - 1) / kThreads);
  fused_nlls_kernel<M, MODE, MARQ><<<grid, kThreads, 0, stream>>>(
      k, ins[0], ins[1], ins[2], ins[3], outs[0], outs[1], outs[2], outs[3],
      outs[4], outs[5]);
  return (int)cudaGetLastError();
}

template <class M>
int launch(const NLLSParams& k, int mode, int marq, const float* const* ins,
           float* const* outs, cudaStream_t s) {
  switch (mode * 2 + (marq ? 1 : 0)) {
    case 0: return launch_mode<M, kFresh, false>(k, ins, outs, s);
    case 1: return launch_mode<M, kFresh, true>(k, ins, outs, s);
    case 2: return launch_mode<M, kPhase1, false>(k, ins, outs, s);
    case 3: return launch_mode<M, kPhase1, true>(k, ins, outs, s);
    case 4: return launch_mode<M, kResume, false>(k, ins, outs, s);
    default: return launch_mode<M, kResume, true>(k, ins, outs, s);
  }
}

}  // namespace

// 1 when the NLLS kernel is compiled for (kind, p): every (kind, P) of
// FABBER_NL_INSTANCES (vb_device.cuh; its Q does not apply here).
extern "C" int fabber_nlls_has_instance(int kind, int p) {
#define FABBER_HAS(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP) return 1;
  FABBER_NL_INSTANCES(FABBER_HAS)
#undef FABBER_HAS
  return 0;
}

// (kind, p): one of FABBER_NL_INSTANCES. tcodes_host [p] and consts_host
// [7] (lam_init, grow, shrink, lam_max, prec_floor, cftol, plateau) are
// host arrays copied into the by-value parameter block. mode: 0 fresh,
// 1 phase 1, 2 resume; marquardt: damp diag(J'J) instead of I; max_its
// >= 0; dof = unmasked samples - p. Device: params0 [p,V], data [nt,V],
// w [nt] (0/1), state_in [4,V] (resume only, else may be null). Outputs
// (device, preallocated): params [p,V] always; fresh and resume: cost,
// its [V], prec, cov [p,p,V] (state_out may be null); phase 1: state_out
// [4,V] (cost, its, prec, cov may be null).
extern "C" int fabber_fused_nlls(
    int kind, int p, const int* tcodes_host, float dt,
    const float* consts_host, int mode, int marquardt, int max_its,
    float dof, const float* params0, const float* data, const float* w,
    const float* state_in, int nt, long long V, float* params_out,
    float* cost_out, float* its_out, float* prec_out, float* cov_out,
    float* state_out, void* stream) {
  const bool post = mode != kPhase1;
  if (p < 1 || p > kMaxP || mode < kFresh || mode > kResume || max_its < 0 ||
      nt < 1 || V < 1 || params_out == nullptr ||
      (mode == kResume && state_in == nullptr) ||
      (post && (cost_out == nullptr || its_out == nullptr ||
                prec_out == nullptr || cov_out == nullptr)) ||
      (!post && state_out == nullptr))
    return (int)cudaErrorInvalidValue;
  NLLSParams k = {};
  for (int i = 0; i < p; ++i) k.tcode[i] = tcodes_host[i];
  k.dt = dt;
  k.max_its = max_its;
  k.lam_init = consts_host[0];
  k.grow = consts_host[1];
  k.shrink = consts_host[2];
  k.lam_max = consts_host[3];
  k.prec_floor = consts_host[4];
  k.cftol = consts_host[5];
  k.plateau = consts_host[6];
  k.dof = dof;
  k.nt = nt;
  k.V = V;
  const float* const ins[4] = {params0, data, w, state_in};
  float* const outs[6] = {params_out, cost_out, its_out, prec_out, cov_out,
                          state_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABBER_LAUNCH(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP) return launch<MODEL>(k, mode, marquardt, ins, outs, s);
  FABBER_NL_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}
