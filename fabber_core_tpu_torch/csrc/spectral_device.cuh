// spectral_device.cuh: the per-voxel bodies of the spectral route's
// kernels, for Hopper (sm_90a), shared by spectral_stats.cu (kernel 1),
// spectral_core.cu (kernel 2) and spectral_fused.cu (kernel 3, both in
// one thread).
//
//   stats_voxel  the single-group statistics of one voxel:
//                dty = (DW)'y, m0 by an unrolled f32 Cholesky of the f32
//                A = D'QD (a non-finite m0 becomes 0), then about
//                r0 = y - D m0: rtqr = sum_t q r0^2, dtqr = (DW)'r0.
//                The per-timepoint rows (D, DW, q: (2P+1) x T floats)
//                are read from the block's shared-memory copy, the data
//                column through a column object's sample(t): the plane
//                (PlaneColumn: kernel 3, kernel 1 streamed) or kernel
//                1's staged tile (spectral_stats.cu StatsTile), so each
//                pass is one function for both forms and they agree bit
//                for bit.
//   core_voxel   the eigenbasis rotation, the scalar fixed point (maxits,
//                or the lane's detector state machine, DET) and the
//                posterior reconstruction of one voxel, written to its
//                output columns.
//
// The comments of spectral_stats.cu and spectral_core.cu describe the
// arithmetic; the functions are force-inlined into each kernel.

#pragma once

#include <cuda_runtime.h>

#include "detectors.cuh"

namespace fabber_spectral {

constexpr int kMaxP = 8;

struct SolveConsts {
  float a[kMaxP * kMaxP];  // A = D'QD, row-major P x P (first P*P used)
};

struct CoreConsts {
  float v[4 * kMaxP * kMaxP + 2 * kMaxP + 6];
};

// A voxel's column in the [T, V] plane, read through the read-only path
// (x = data + v).
struct PlaneColumn {
  const float* __restrict__ x;
  long long V;

  __device__ __forceinline__ float sample(int t) const {
    return __ldg(x + (size_t)t * V);
  }
};

template <int P, class Col>
__device__ __forceinline__ void stats_voxel(const float* rows, int T,
                                            const Col& col,
                                            const SolveConsts& ac, float* m0,
                                            float& rtqr_out, float* dtqr) {
  const float* dcol = rows;
  const float* dw = rows + P * T;
  const float* q = rows + 2 * P * T;

  // ---- pass 1: dty = (DW)' y ----------------------------------------
  float dty[P];
#pragma unroll
  for (int a = 0; a < P; ++a) dty[a] = 0.f;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const float y = col.sample(t);
#pragma unroll
    for (int a = 0; a < P; ++a) dty[a] = fmaf(dw[a * T + t], y, dty[a]);
  }

  // ---- m0 by f32 Cholesky of the constant A --------------------------
  float l[P][P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = ac.a[i * P + i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[i][k] * l[i][k];
    l[i][i] = sqrtf(s);
    const float inv_d = 1.f / l[i][i];
#pragma unroll
    for (int j = i + 1; j < P; ++j) {
      float s2 = ac.a[j * P + i];
#pragma unroll
      for (int k = 0; k < i; ++k) s2 -= l[j][k] * l[i][k];
      l[j][i] = s2 * inv_d;
    }
  }
  float fwd[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = dty[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[i][k] * fwd[k];
    fwd[i] = s / l[i][i];
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = fwd[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s -= l[k][i] * m0[k];
    m0[i] = s / l[i][i];
  }
  bool ok = true;
#pragma unroll
  for (int a = 0; a < P; ++a) ok = ok && isfinite(m0[a]);
#pragma unroll
  for (int a = 0; a < P; ++a) m0[a] = ok ? m0[a] : 0.f;

  // ---- pass 2: rtqr and dtqr about r0 = y - D m0 ---------------------
  float rtqr = 0.f;
#pragma unroll
  for (int a = 0; a < P; ++a) dtqr[a] = 0.f;
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const float y = col.sample(t);
    float fit = 0.f;
#pragma unroll
    for (int a = 0; a < P; ++a) fit = fmaf(dcol[a * T + t], m0[a], fit);
    const float r = y - fit;
    rtqr = fmaf(q[t] * r, r, rtqr);
#pragma unroll
    for (int a = 0; a < P; ++a) dtqr[a] = fmaf(dw[a * T + t], r, dtqr[a]);
  }
  rtqr_out = rtqr;
}

template <int P, bool DET>
__device__ __forceinline__ void core_voxel(
    const float* m0, const float rtqr, const float* dtqr, const float* pm,
    const CoreConsts& k, const fabber::DetParams& det, int n_iters,
    long long V, long long v, float* __restrict__ means_out,
    float* __restrict__ prec_out, float* __restrict__ cov_out,
    float* __restrict__ b_out, float* __restrict__ c_out,
    float* __restrict__ f_out, float* __restrict__ tr_out) {
  // constant-block offsets; every index below is a compile-time
  // constant after unrolling, so each read is a direct constant-bank
  // operand (no pointer into the parameter space, no local copy)
  constexpr int oA = 0, oETW = P * P, oETWI = 2 * P * P, oEW = 3 * P * P,
                oLAM = 4 * P * P, oPP = oLAM + P, oS = oPP + P;
#define A(i, j) k.v[oA + (i) * P + (j)]
#define ETW(i, a) k.v[oETW + (i) * P + (a)]
#define ETWI(i, a) k.v[oETWI + (i) * P + (a)]
#define EW(a, i) k.v[oEW + (a) * P + (i)]
#define LAM(i) k.v[oLAM + (i)]
#define PP(i) k.v[oPP + (i)]
  const float inv_b0 = k.v[oS], c_post = k.v[oS + 1], b_init = k.v[oS + 2],
              c_init = k.v[oS + 3], f_const = k.v[oS + 4],
              lb_coeff = k.v[oS + 5];

  // ---- rotation into the whitened eigenbasis -------------------------
  float dtqy[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) s += A(a, j) * m0[j];
    dtqy[a] = dtqr[a] + s;
  }
  float ut[P], u0t[P], vt[P], m0t[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float su = 0.f, s0 = 0.f, sv = 0.f, sm = 0.f;
#pragma unroll
    for (int a = 0; a < P; ++a) {
      su += ETW(i, a) * dtqy[a];
      s0 += ETW(i, a) * dtqr[a];
      sv += ETW(i, a) * (PP(a) * pm[a]);
      sm += ETWI(i, a) * m0[a];
    }
    ut[i] = su;
    u0t[i] = s0;
    vt[i] = sv;
    m0t[i] = sm;
  }

  float s = b_init * c_init;
  bool sel_init = false;
  int its = n_iters;
  if constexpr (!DET) {
    // ---- scalar fixed point: n_iters-1 noise updates -----------------
    for (int it = 0; it < n_iters - 1; ++it) {
      float cross = 0.f, quad = 0.f, tr = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float rd = 1.f / (s * LAM(i) + 1.f);
        const float d = (s * ut[i] + vt[i]) * rd - m0t[i];
        cross += d * u0t[i];
        quad += LAM(i) * d * d;
        tr += LAM(i) * rd;
      }
      const float kqk = fmaxf(rtqr - 2.f * cross + quad, 0.f);
      s = 1.f / ((kqk + tr) * 0.5f + inv_b0) * c_post;
    }
  } else {
    // ---- detector mode: the lane's state machine in the loop ---------
    // cur: the phi of the next update; gen: the phi that generated the
    // current posterior; best: the saved generating phi; the *_init
    // flags mark the engine-initial posterior
    float cur_s = s, gen_s = s, best_s = s;
    bool is_init = true, best_init = true;
    fabber::DetState cv = fabber::det_init(det);
    for (int it = 0; it < n_iters && !cv.done; ++it) {
      if (cv.save) {
        best_s = gen_s;
        best_init = is_init;
      }
      const float g = cur_s;
      float cross = 0.f, quad = 0.f, tr = 0.f, logden = 0.f, rdensum = 0.f,
            mv2 = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float den = g * LAM(i) + 1.f;
        const float rd = 1.f / den;
        const float mt = (g * ut[i] + vt[i]) * rd;
        const float d = mt - m0t[i];
        cross += d * u0t[i];
        quad += LAM(i) * d * d;
        tr += LAM(i) * rd;
        logden += logf(den);
        rdensum += rd;
        mv2 += (mt - vt[i]) * (mt - vt[i]);
      }
      const float kqk = fmaxf(rtqr - 2.f * cross + quad, 0.f);
      const float b_new = 1.f / ((kqk + tr) * 0.5f + inv_b0);
      const float f = f_const - 0.5f * logden + lb_coeff * logf(b_new) -
                      b_new * c_post * (inv_b0 + 0.5f * kqk) - 0.5f * tr -
                      0.5f * mv2 - 0.5f * rdensum;
      fabber::det_test(det, cv, f);
      cur_s = b_new * c_post;
      gen_s = g;
      is_init = false;
    }
    // the engine's finalize: best-save, then revert
    if (cv.save) {
      best_s = gen_s;
      best_init = is_init;
    }
    s = cv.revert ? best_s : gen_s;
    sel_init = cv.revert ? best_init : is_init;
    its = cv.its;
  }

  // ---- reconstruction from the phi that generated the posterior ------
  float mt[P], rden[P];
  float cross = 0.f, quad = 0.f, tr = 0.f, logden = 0.f, rdensum = 0.f,
        mv2 = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float den = s * LAM(i) + 1.f;
    rden[i] = 1.f / den;
    mt[i] = (s * ut[i] + vt[i]) * rden[i];
    const float d = mt[i] - m0t[i];
    cross += d * u0t[i];
    quad += LAM(i) * d * d;
    tr += LAM(i) * rden[i];
    logden += logf(den);
    rdensum += rden[i];
    mv2 += (mt[i] - vt[i]) * (mt[i] - vt[i]);
  }
  const float kqk = fmaxf(rtqr - 2.f * cross + quad, 0.f);
  const float b = 1.f / ((kqk + tr) * 0.5f + inv_b0);

#pragma unroll
  for (int a = 0; a < P; ++a) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) m += EW(a, i) * mt[i];
    means_out[(size_t)a * V + v] = m;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float c = 0.f;
#pragma unroll
      for (int kk = 0; kk < P; ++kk)
        c += EW(i, kk) * EW(j, kk) * rden[kk];
      const size_t o = (size_t)(i * P + j) * V + v;
      cov_out[o] = c;
      prec_out[o] = s * A(i, j) + (i == j ? PP(i) : 0.f);
    }
  }
  const float f = f_const - 0.5f * logden + lb_coeff * logf(b) -
                  b * c_post * (inv_b0 + 0.5f * kqk) - 0.5f * tr -
                  0.5f * mv2 - 0.5f * rdensum;
  b_out[v] = sel_init ? -b : b;
  c_out[v] = c_post;
  f_out[v] = f;
  tr_out[v] = DET ? (float)its : tr;
#undef A
#undef ETW
#undef ETWI
#undef EW
#undef LAM
#undef PP
}

}  // namespace fabber_spectral
