// spectral_core: the eigenbasis fixed point of fixed-design white-noise
// VB (maxits mode) and the posterior reconstruction, for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_spectral.py
// make_spectral_core_kernel (its pallas_call at line 840; body
// _spectral_core at line 162, output writes _write_outputs at line 350),
// in its maxits (no detector) mode.
//
// One thread per voxel, all state in registers. The 4P^2+2P+6 scalar
// constants (A, E'W, E'W^-1, WE, lam, pp, 1/b0, c_post, b_init, c_init,
// f_const, lb_coeff; layout of pack_spectral_consts) ride as a by-value
// kernel parameter, i.e. in constant memory, read as uniform operands.
// Per voxel:
//   rotate   ut = E'W (dtqr + A m0), u0t = E'W dtqr, vt = E'W (pp*pm),
//            m0t = E'W^-1 m0
//   loop     s0 = b_init*c_init, then n_iters-1 noise updates
//            s <- c_post / ((kqk + tr)/2 + 1/b0), kqk clamped at 0
//   rebuild  from the final s: means = WE mt, prec = s A + diag(pp),
//            cov_ij = sum_k WE_ik WE_jk / (s lam_k + 1), the noise b and
//            c = c_post, F (the eigenbasis ELBO) and tr
// The off-by-one (n_iters-1 updates, then the rebuild from the s that
// generated the last posterior) is the TPU kernel's and the XLA
// spectral route's; the engine reports its = n_iters.
//
// What bounds it on this card: the output write, (2P^2+P+4)*4 bytes per
// voxel (100 B at P=3) plus the (3P+1)*4-byte statistics read; the
// fixed point is ~25 flops per voxel-iteration, far below the card's
// rate. Every output plane is written coalesced (voxels on the last
// axis, one thread per voxel).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 8;
constexpr int kThreads = 256;

struct CoreConsts {
  float v[4 * kMaxP * kMaxP + 2 * kMaxP + 6];
};

template <int P>
__global__ void __launch_bounds__(kThreads)
spectral_core_kernel(const float* __restrict__ m0_in,
                     const float* __restrict__ rtqr_in,
                     const float* __restrict__ dtqr_in,
                     const float* __restrict__ pm_in, const CoreConsts k,
                     int n_iters, long long V, float* __restrict__ means_out,
                     float* __restrict__ prec_out, float* __restrict__ cov_out,
                     float* __restrict__ b_out, float* __restrict__ c_out,
                     float* __restrict__ f_out, float* __restrict__ tr_out) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
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

  float m0[P], dtqr[P], pm[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    m0[a] = m0_in[(size_t)a * V + v];
    dtqr[a] = dtqr_in[(size_t)a * V + v];
    pm[a] = pm_in[(size_t)a * V + v];
  }
  const float rtqr = rtqr_in[v];

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

  // ---- scalar fixed point: n_iters-1 noise updates -------------------
  float s = b_init * c_init;
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
  b_out[v] = b;
  c_out[v] = c_post;
  f_out[v] = f;
  tr_out[v] = tr;
#undef A
#undef ETW
#undef ETWI
#undef EW
#undef LAM
#undef PP
}

template <int P>
int launch(const float* m0, const float* rtqr, const float* dtqr,
           const float* pm, const CoreConsts& k, int n_iters, long long V,
           float* const* outs, cudaStream_t stream) {
  const unsigned grid = (unsigned)((V + kThreads - 1) / kThreads);
  spectral_core_kernel<P><<<grid, kThreads, 0, stream>>>(
      m0, rtqr, dtqr, pm, k, n_iters, V, outs[0], outs[1], outs[2], outs[3],
      outs[4], outs[5], outs[6]);
  return (int)cudaGetLastError();
}

}  // namespace

// m0, dtqr, pm [P,V], rtqr [1,V] (device); consts_host [4P^2+2P+6]
// (host, by value). Outputs (device, preallocated): means [P,V],
// prec [P,P,V], cov [P,P,V], b, c, F, tr [1,V].
extern "C" int fabber_spectral_core(int p, int n_iters, const float* m0,
                                    const float* rtqr, const float* dtqr,
                                    const float* pm, const float* consts_host,
                                    long long V, float* means, float* prec,
                                    float* cov, float* b, float* c, float* f,
                                    float* tr, void* stream) {
  if (p < 1 || p > kMaxP || n_iters < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  CoreConsts k = {};
  for (int i = 0; i < 4 * p * p + 2 * p + 6; ++i) k.v[i] = consts_host[i];
  float* const outs[7] = {means, prec, cov, b, c, f, tr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch<1>(m0, rtqr, dtqr, pm, k, n_iters, V, outs, s);
    case 2: return launch<2>(m0, rtqr, dtqr, pm, k, n_iters, V, outs, s);
    case 3: return launch<3>(m0, rtqr, dtqr, pm, k, n_iters, V, outs, s);
    case 4: return launch<4>(m0, rtqr, dtqr, pm, k, n_iters, V, outs, s);
    case 5: return launch<5>(m0, rtqr, dtqr, pm, k, n_iters, V, outs, s);
    case 6: return launch<6>(m0, rtqr, dtqr, pm, k, n_iters, V, outs, s);
    case 7: return launch<7>(m0, rtqr, dtqr, pm, k, n_iters, V, outs, s);
    default: return launch<8>(m0, rtqr, dtqr, pm, k, n_iters, V, outs, s);
  }
}
