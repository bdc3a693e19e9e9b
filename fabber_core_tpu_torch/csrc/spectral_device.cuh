// spectral_device.cuh: the per-voxel bodies of the spectral route's
// kernels, for Hopper (sm_90a), shared by spectral_stats.cu (kernel 1),
// spectral_core.cu (kernel 2) and spectral_fused.cu (kernel 3, both in
// one thread).
//
//   stage_stats  the staged form's copy of a block's [T, VB] tile of the
//                data plane and the design rows into shared memory
//                (kernels 1 and 3): 16-byte cp.async chunks, each tile
//                row rotated by its first sample's offset from 16-byte
//                alignment (StatsTile undoes it).
//   stats_voxel  the single-group statistics of one voxel:
//                dty = (DW)'y, m0 by an unrolled f32 Cholesky of the f32
//                A = D'QD (a non-finite m0 becomes 0), then about
//                r0 = y - D m0: rtqr = sum_t q r0^2, dtqr = (DW)'r0.
//                The per-timepoint rows (D, DW, q: (2P+1) x T floats)
//                are read from the block's shared-memory copy, the data
//                column through a column object's sample(t): the plane
//                (PlaneColumn: the streamed forms) or the staged tile
//                (StatsTile), so each pass is one function for both
//                forms and they agree bit for bit.
//   core_voxel   the eigenbasis rotation, the scalar fixed point (maxits,
//                or the lane's detector state machine: KIND, one
//                instance per detector, detectors.cuh det_test_kind) and
//                the posterior reconstruction of one voxel, written to
//                its output columns.
//
// The comments of spectral_stats.cu and spectral_core.cu describe the
// arithmetic; the functions are force-inlined into each kernel.
//
// Past kMaxP (a per-shape instance, ops/_cuda.py build_instance: P 9 to
// kWideMaxP) the constants do not ride by value: 4P^2 + 2P + 6 core
// floats are 6.6 KB at P = 20, past a launch's classic 4 KB of
// parameters. The wide kernels copy them from a device buffer into the
// block's shared memory once (SharedCore), and the factor of A, which
// every lane's m0 solve reads, is taken once per block into shared
// memory (factor_block) where the P <= kMaxP instances take it in each
// lane's registers (400 floats at P = 20, past a thread's 255
// registers). The fixed point and the rebuild read both through the
// same index macros, so the arithmetic is the same.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "detectors.cuh"
#include "tile.cuh"

namespace fabber_spectral {

constexpr int kMaxP = 8;
// the largest P of a per-shape instance: the JAX engine's spectral gate
// admits no larger P at any T
constexpr int kWideMaxP = 25;
// kernels 1 and 3: the streamed block and the widest staged one
constexpr int kStatsThreads = 256;

struct SolveConsts {
  float a[kMaxP * kMaxP];  // A = D'QD, row-major P x P (first P*P used)
};

struct CoreConsts {
  float v[4 * kMaxP * kMaxP + 2 * kMaxP + 6];
};

// A per-shape instance's constants in the block's shared memory: the
// lower factor of A (row-major P x P, the upper triangle unset) and the
// core constants (pack_spectral_consts' layout, read as CoreConsts.v).
struct SharedFactor {
  const float* l;
};
struct SharedCore {
  const float* v;
};

__host__ __device__ constexpr int core_floats(int p) {
  return 4 * p * p + 2 * p + 6;
}

// A voxel's column in the [T, V] plane, read through the read-only path
// (x = data + v).
struct PlaneColumn {
  const float* __restrict__ x;
  long long V;

  __device__ __forceinline__ float sample(int t) const {
    return __ldg(x + (size_t)t * V);
  }
};

// The staged form's [T, vb] tile in shared memory (kernels 1 and 3).
// Row t holds the
// block's vb samples of plane row t rotated by rot(t), the offset in
// floats of the row's first sample from 16-byte alignment: sample j sits
// in word (rot(t) + j) mod vb, so each 16-byte aligned chunk of the plane
// lands on 16-byte aligned words. rot(t) = (r0 + t vm) mod 4, r0 the
// first row's offset and vm = V mod 4: 0 throughout for an aligned plane
// with V a multiple of 4.
struct StatsTile {
  const float* tile;
  int vb, lane;
  unsigned r0, vm;

  __device__ __forceinline__ int rot(int t) const {
    return (int)((r0 + (unsigned)t * vm) & 3u);
  }
  __device__ __forceinline__ float sample(int t) const {
    int w = lane + rot(t);
    if (w >= vb) w -= vb;
    return tile[t * vb + w];
  }
};

// The staged form's copies, by every thread of the block (those past V
// included, which must meet the barrier), then the wait and the barrier:
//   words 4 .. vb-1 of row t, chunk c = 1 .. vb/4 - 1: 16 bytes from the
//     plane's aligned chunk whose first sample is j = 4c - rot(t) (fewer
//     floats past V, zero filled); a row's chunks on consecutive lanes,
//     four rows at a time (lane = (vb/4) r + c; the c = 0 lanes idle);
//   words 0 .. 3 of row t: samples (w - rot(t)) mod vb, the row's
//     unaligned head and tail, one float each;
//   the (2P+1) x T design rows after the tile, one float each.
template <int P>
__device__ __forceinline__ StatsTile stage_stats(
    const float* __restrict__ data, const float* __restrict__ tconsts,
    int T, long long V) {
  const int vb = (int)blockDim.x, lane = (int)threadIdx.x, nc = vb / 4;
  float* tile = fabber::dynamic_smem();
  const long long v0 = (long long)blockIdx.x * vb;
  const long long left = V - v0;   // the block's samples in a row: > 0
  const StatsTile col{
      tile, vb, lane,
      (unsigned)((reinterpret_cast<uintptr_t>(data) / sizeof(float) +
                  (unsigned long long)v0) & 3u),
      (unsigned)(V & 3)};
  const int c = lane % nc;
  if (c != 0) {
    for (int t = lane / nc; t < T; t += 4) {
      const int j = 4 * c - col.rot(t);
      const long long n = left - j, row = (long long)t * V + v0;
      // past V nothing is read: the address stays the row's first chunk
      fabber::cp_async16(tile + t * vb + 4 * c,
                         data + row + (n > 0 ? j : -col.rot(t)),
                         n >= 4 ? 4 : n > 0 ? (int)n : 0);
    }
  }
  for (int i = lane; i < 4 * T; i += vb) {
    const int t = i >> 2, w = i & 3;
    int j = w - col.rot(t);
    if (j < 0) j += vb;
    const bool in = j < left;
    fabber::cp_async4(tile + t * vb + w,
                      data + ((long long)t * V + v0 + (in ? j : 0)), in);
  }
  float* rows = tile + T * vb;
  for (int i = lane; i < (2 * P + 1) * T; i += vb)
    fabber::cp_async4(rows + i, tconsts + i, true);
  fabber::cp_async_wait_block();
  return col;
}

// Dynamic shared memory of a kernel 1 or 3 launch at (vb, T): streamed
// (vb 0) the rows; staged the [T, vb] tile and the rows; -1 where
// refused (tile.cuh tile_bytes: vb not a multiple of 32 or above
// kStatsThreads, or a tile above a block's shared memory; rows beyond
// it).
// A per-shape instance adds extra floats after the rows (its factor of
// A, and kernel 3's core constants).
inline long long stats_smem(int p, int vb, int T, int extra = 0) {
  if (vb == 0) {
    const long long b = 4LL * ((2 * p + 1) * T + extra);
    return b <= fabber::kMaxBlockSmem ? b : -1;
  }
  return fabber::tile_bytes(vb, T, (2 * p + 1) * T + extra, kStatsThreads);
}

// A per-shape instance's factor of the constant A (a [P*P] device
// buffer) into l in shared memory, by the block: the same float32
// operations as the unrolled per-lane Cholesky of stats_voxel, column by
// column, lane 0 taking the pivot and the block's lanes the rows below
// it, with a barrier after each (every thread of the block calls it,
// those past V included; it ends with a barrier).
template <int P>
__device__ __forceinline__ void factor_block(const float* __restrict__ a,
                                             float* l) {
  const int lane = (int)threadIdx.x, n = (int)blockDim.x;
  for (int i = 0; i < P; ++i) {
    if (lane == 0) {
      float s = __ldg(a + i * P + i);
      for (int k = 0; k < i; ++k) s -= l[i * P + k] * l[i * P + k];
      l[i * P + i] = sqrtf(s);
    }
    __syncthreads();
    const float inv_d = 1.f / l[i * P + i];
    for (int j = i + 1 + lane; j < P; j += n) {
      float s2 = __ldg(a + j * P + i);
      for (int k = 0; k < i; ++k) s2 -= l[j * P + k] * l[i * P + k];
      l[j * P + i] = s2 * inv_d;
    }
    __syncthreads();
  }
}

// The block's copy of n floats of a device buffer into shared memory
// (no barrier: the caller's next one covers it).
__device__ __forceinline__ void copy_block(const float* __restrict__ src,
                                           float* dst, int n) {
  for (int i = (int)threadIdx.x; i < n; i += (int)blockDim.x)
    dst[i] = __ldg(src + i);
}

// m0 = A^-1 dty by the substitutions alone on the block's factor of A
// (SharedFactor; the P <= kMaxP instances factor A per lane, inline in
// stats_voxel, whose code a function of its own rescheduled).
template <int P>
__device__ __forceinline__ void solve_m0(const SharedFactor& f,
                                         const float* dty, float* m0) {
  const float* l = f.l;
  float fwd[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = dty[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[i * P + k] * fwd[k];
    fwd[i] = s / l[i * P + i];
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = fwd[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s -= l[k * P + i] * m0[k];
    m0[i] = s / l[i * P + i];
  }
}

template <int P, class Col, class AC>
__device__ __forceinline__ void stats_voxel(const float* rows, int T,
                                            const Col& col,
                                            const AC& ac, float* m0,
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
  if constexpr (std::is_same_v<AC, SharedFactor>) {
    solve_m0<P>(ac, dty, m0);
  } else {
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

// The core constants (pack_spectral_consts' layout) by name; every index
// is a compile-time constant after unrolling, so each read is a direct
// constant-bank operand (no pointer into the parameter space, no local
// copy). k and P are the enclosing function's.
#define FS_A(i, j) k.v[(i) * P + (j)]
#define FS_ETW(i, a) k.v[P * P + (i) * P + (a)]
#define FS_ETWI(i, a) k.v[2 * P * P + (i) * P + (a)]
#define FS_EW(a, i) k.v[3 * P * P + (a) * P + (i)]
#define FS_LAM(i) k.v[4 * P * P + (i)]
#define FS_PP(i) k.v[4 * P * P + P + (i)]
#define FS_S(i) k.v[4 * P * P + 2 * P + (i)]   // 1/b0, c_post, b_init,
                                               // c_init, f_const, lb_coeff

// A lane's statistics rotated into the whitened eigenbasis:
// ut = E'W (dtqr + A m0), u0t = E'W dtqr, vt = E'W (pp*pm),
// m0t = E'W^-1 m0, with rtqr beside them.
template <int P>
struct Rotated {
  float ut[P], u0t[P], vt[P], m0t[P], rtqr;
};

template <int P, class K>
__device__ __forceinline__ Rotated<P> rotate(const float* m0, float rtqr,
                                             const float* dtqr,
                                             const float* pm,
                                             const K& k) {
  Rotated<P> r;
  float dtqy[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) s += FS_A(a, j) * m0[j];
    dtqy[a] = dtqr[a] + s;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float su = 0.f, s0 = 0.f, sv = 0.f, sm = 0.f;
#pragma unroll
    for (int a = 0; a < P; ++a) {
      su += FS_ETW(i, a) * dtqy[a];
      s0 += FS_ETW(i, a) * dtqr[a];
      sv += FS_ETW(i, a) * (FS_PP(a) * pm[a]);
      sm += FS_ETWI(i, a) * m0[a];
    }
    r.ut[i] = su;
    r.u0t[i] = s0;
    r.vt[i] = sv;
    r.m0t[i] = sm;
  }
  r.rtqr = rtqr;
  return r;
}

// The detector loop's state of one lane. cur: the phi of the next
// update; gen: the phi that generated the current posterior; best: the
// saved generating phi; the *_init flags mark the engine-initial
// posterior; it: the trips made; cv: the detector's state.
struct DetLoop {
  float cur_s, gen_s, best_s;
  bool is_init, best_init;
  int it;
  fabber::DetState cv;
};

// The loop's start: every phi the engine-initial s0 = b_init c_init.
__device__ __forceinline__ DetLoop det_loop_start(float s0,
                                                  const fabber::DetParams& d) {
  DetLoop l;
  l.cur_s = l.gen_s = l.best_s = s0;
  l.is_init = l.best_init = true;
  l.it = 0;
  l.cv = fabber::det_init(d);
  return l;
}

// Trips of the detector loop until the lane is done or has made end
// trips: per trip, best-save where the detector's save flag is set, the
// update generated by the current phi, the noise, the eigenbasis ELBO F
// and the detector's test.
template <int P, int KIND, class K>
__device__ __forceinline__ void det_loop(const Rotated<P>& r,
                                         const K& k,
                                         const fabber::DetParams& det,
                                         int end, DetLoop& l) {
  const float inv_b0 = FS_S(0), c_post = FS_S(1), f_const = FS_S(4),
              lb_coeff = FS_S(5);
  for (; l.it < end && !l.cv.done; ++l.it) {
    if (l.cv.save) {
      l.best_s = l.gen_s;
      l.best_init = l.is_init;
    }
    const float g = l.cur_s;
    float cross = 0.f, quad = 0.f, tr = 0.f, logden = 0.f, rdensum = 0.f,
          mv2 = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float den = g * FS_LAM(i) + 1.f;
      const float rd = 1.f / den;
      const float mt = (g * r.ut[i] + r.vt[i]) * rd;
      const float d = mt - r.m0t[i];
      cross += d * r.u0t[i];
      quad += FS_LAM(i) * d * d;
      tr += FS_LAM(i) * rd;
      logden += logf(den);
      rdensum += rd;
      mv2 += (mt - r.vt[i]) * (mt - r.vt[i]);
    }
    const float kqk = fmaxf(r.rtqr - 2.f * cross + quad, 0.f);
    const float b_new = 1.f / ((kqk + tr) * 0.5f + inv_b0);
    const float f = f_const - 0.5f * logden + lb_coeff * logf(b_new) -
                    b_new * c_post * (inv_b0 + 0.5f * kqk) - 0.5f * tr -
                    0.5f * mv2 - 0.5f * rdensum;
    fabber::det_test_kind<KIND>(det, l.cv, f);
    l.cur_s = b_new * c_post;
    l.gen_s = g;
    l.is_init = false;
  }
}

// The engine's finalize after the loop: best-save, then the revert
// selection of the generating phi. Returns the selected phi; sel_init:
// whether it generated the engine-initial posterior; its: the
// detector's count.
__device__ __forceinline__ float det_finish(DetLoop& l, bool& sel_init,
                                            int& its) {
  if (l.cv.save) {
    l.best_s = l.gen_s;
    l.best_init = l.is_init;
  }
  sel_init = l.cv.revert ? l.best_init : l.is_init;
  its = l.cv.its;
  return l.cv.revert ? l.best_s : l.gen_s;
}

// The posterior rebuilt from the phi s that generated it, written to the
// lane's output columns: means = WE mt, prec = s A + diag(pp), cov, the
// noise b (with a minus sign where sel_init) and c = c_post, F, and tr
// (maxits) or the detector's count its.
template <int P, int KIND, class K>
__device__ __forceinline__ void rebuild(
    const Rotated<P>& r, float s, bool sel_init, int its,
    const K& k, long long V, long long v,
    float* __restrict__ means_out, float* __restrict__ prec_out,
    float* __restrict__ cov_out, float* __restrict__ b_out,
    float* __restrict__ c_out, float* __restrict__ f_out,
    float* __restrict__ tr_out) {
  const float inv_b0 = FS_S(0), c_post = FS_S(1), f_const = FS_S(4),
              lb_coeff = FS_S(5);
  float mt[P], rden[P];
  float cross = 0.f, quad = 0.f, tr = 0.f, logden = 0.f, rdensum = 0.f,
        mv2 = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float den = s * FS_LAM(i) + 1.f;
    rden[i] = 1.f / den;
    mt[i] = (s * r.ut[i] + r.vt[i]) * rden[i];
    const float d = mt[i] - r.m0t[i];
    cross += d * r.u0t[i];
    quad += FS_LAM(i) * d * d;
    tr += FS_LAM(i) * rden[i];
    logden += logf(den);
    rdensum += rden[i];
    mv2 += (mt[i] - r.vt[i]) * (mt[i] - r.vt[i]);
  }
  const float kqk = fmaxf(r.rtqr - 2.f * cross + quad, 0.f);
  const float b = 1.f / ((kqk + tr) * 0.5f + inv_b0);

#pragma unroll
  for (int a = 0; a < P; ++a) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) m += FS_EW(a, i) * mt[i];
    means_out[(size_t)a * V + v] = m;
  }
  if constexpr (P <= kMaxP) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float c = 0.f;
#pragma unroll
        for (int kk = 0; kk < P; ++kk)
          c += FS_EW(i, kk) * FS_EW(j, kk) * rden[kk];
        const size_t o = (size_t)(i * P + j) * V + v;
        cov_out[o] = c;
        prec_out[o] = s * FS_A(i, j) + (i == j ? FS_PP(i) : 0.f);
      }
    }
  } else {
    // a per-shape instance: the P x P planes row by row, each entry a
    // sum over the eigenbasis unrolled (rden stays in registers), the
    // rows and columns in loops, so the code grows as P^2, not P^3
#pragma unroll 1
    for (int i = 0; i < P; ++i) {
#pragma unroll 1
      for (int j = 0; j < P; ++j) {
        float c = 0.f;
#pragma unroll
        for (int kk = 0; kk < P; ++kk)
          c += FS_EW(i, kk) * FS_EW(j, kk) * rden[kk];
        const size_t o = (size_t)(i * P + j) * V + v;
        cov_out[o] = c;
        prec_out[o] = s * FS_A(i, j) + (i == j ? FS_PP(i) : 0.f);
      }
    }
  }
  const float f = f_const - 0.5f * logden + lb_coeff * logf(b) -
                  b * c_post * (inv_b0 + 0.5f * kqk) - 0.5f * tr -
                  0.5f * mv2 - 0.5f * rdensum;
  b_out[v] = sel_init ? -b : b;
  c_out[v] = c_post;
  f_out[v] = f;
  tr_out[v] = KIND != fabber::kMaxits ? (float)its : tr;
}

// One voxel's whole core: rotate, the fixed point (maxits: n_iters-1
// noise updates from s0 = b_init c_init; a detector KIND: its loop to
// n_iters trips and the finalize), rebuild. KIND: fabber::kMaxits, or
// the detector of the instance (kPointZeroOne, kFreduce, kTrialMode),
// whose test is compiled alone (det_test_kind): the lane keeps only that
// detector's state and branch.
template <int P, int KIND, class K>
__device__ __forceinline__ void core_voxel(
    const float* m0, const float rtqr, const float* dtqr, const float* pm,
    const K& k, const fabber::DetParams& det, int n_iters,
    long long V, long long v, float* __restrict__ means_out,
    float* __restrict__ prec_out, float* __restrict__ cov_out,
    float* __restrict__ b_out, float* __restrict__ c_out,
    float* __restrict__ f_out, float* __restrict__ tr_out) {
  const Rotated<P> r = rotate<P>(m0, rtqr, dtqr, pm, k);
  float s = FS_S(2) * FS_S(3);
  if constexpr (KIND == fabber::kMaxits) {
    // ---- scalar fixed point: n_iters-1 noise updates -----------------
    const float inv_b0 = FS_S(0), c_post = FS_S(1);
    for (int it = 0; it < n_iters - 1; ++it) {
      float cross = 0.f, quad = 0.f, tr = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float rd = 1.f / (s * FS_LAM(i) + 1.f);
        const float d = (s * r.ut[i] + r.vt[i]) * rd - r.m0t[i];
        cross += d * r.u0t[i];
        quad += FS_LAM(i) * d * d;
        tr += FS_LAM(i) * rd;
      }
      const float kqk = fmaxf(r.rtqr - 2.f * cross + quad, 0.f);
      s = 1.f / ((kqk + tr) * 0.5f + inv_b0) * c_post;
    }
    rebuild<P, KIND>(r, s, false, n_iters, k, V, v, means_out, prec_out,
                     cov_out, b_out, c_out, f_out, tr_out);
  } else {
    DetLoop l = det_loop_start(s, det);
    det_loop<P, KIND>(r, k, det, n_iters, l);
    bool sel_init;
    int its;
    s = det_finish(l, sel_init, its);
    rebuild<P, KIND>(r, s, sel_init, its, k, V, v, means_out, prec_out,
                     cov_out, b_out, c_out, f_out, tr_out);
  }
}

#undef FS_A
#undef FS_ETW
#undef FS_ETWI
#undef FS_EW
#undef FS_LAM
#undef FS_PP
#undef FS_S

}  // namespace fabber_spectral
