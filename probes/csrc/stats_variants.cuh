// stats_variants.cuh: kernel 1's per-voxel statistics as probes/csrc/
// spectral_stats.cu measured them on an NVIDIA H100: csrc/
// spectral_device.cuh stats_voxel over a tile.cuh Column, with the rows
// optionally interleaved per sample (R4, -DFABBER_STATS_ROWS4), which
// csrc/ does not keep. Same arithmetic, same order.

#pragma once

#include "spectral_device.cuh"
#include "tile.cuh"

namespace fabber_probe {

using fabber_spectral::SolveConsts;

// Sample t of a voxel's column: the staged tile's word, or the plane's
// through the read-only path (__ldg) as the streamed kernels always read
// it (their column is {data + v, rows, V, 0}).
template <bool STAGED>
__device__ __forceinline__ float stats_sample(
    const fabber::Column<STAGED>& col, int t) {
  if constexpr (STAGED)
    return col.sample(t);
  else
    return __ldg(col.x + (size_t)t * col.stride);
}

// The rows interleaved per sample (kernel 1's staged form built with
// FABBER_STATS_ROWS4, spectral_stats.cu): [T][RS], sample t's DW_0 ..
// DW_{P-1}, q, D_0 .. D_{P-1} in RS = 2P+1 rounded up to 4 floats, read
// as 16-byte broadcasts (one shared-memory load per 4 values).
template <int P>
__host__ __device__ constexpr int rows4_stride() {
  return (2 * P + 4) / 4 * 4;
}
#if defined(__CUDACC__)
using RowQuad = float4;
#else
struct RowQuad {
  float x, y, z, w;
};
#endif

// The first 4 N floats of sample t's interleaved rows.
template <int P, int N>
__device__ __forceinline__ void load_rows4(const float* rows, int t,
                                           RowQuad (&r)[N]) {
  const RowQuad* src =
      reinterpret_cast<const RowQuad*>(rows + t * rows4_stride<P>());
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = src[k];
}

// Float i of loaded quads (i a constant once unrolled: a register).
template <int N>
__device__ __forceinline__ float quad_at(const RowQuad (&r)[N], int i) {
  const RowQuad& q = r[i >> 2];
  switch (i & 3) {
    case 0: return q.x;
    case 1: return q.y;
    case 2: return q.z;
    default: return q.w;
  }
}

// R4: the rows interleaved (rows4_stride) instead of [2P+1][T].
template <int P, bool STAGED, bool R4 = false>
__device__ __forceinline__ void stats_voxel(const float* rows, int T,
                                            const fabber::Column<STAGED>& col,
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
    const float y = stats_sample(col, t);
    if constexpr (R4) {
      RowQuad r4[(P + 3) / 4];
      load_rows4<P>(rows, t, r4);
#pragma unroll
      for (int a = 0; a < P; ++a) dty[a] = fmaf(quad_at(r4, a), y, dty[a]);
    } else {
#pragma unroll
      for (int a = 0; a < P; ++a) dty[a] = fmaf(dw[a * T + t], y, dty[a]);
    }
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
    const float y = stats_sample(col, t);
    float fit = 0.f;
    if constexpr (R4) {
      RowQuad r4[rows4_stride<P>() / 4];
      load_rows4<P>(rows, t, r4);
#pragma unroll
      for (int a = 0; a < P; ++a)
        fit = fmaf(quad_at(r4, P + 1 + a), m0[a], fit);
      const float r = y - fit;
      rtqr = fmaf(quad_at(r4, P) * r, r, rtqr);
#pragma unroll
      for (int a = 0; a < P; ++a) dtqr[a] = fmaf(quad_at(r4, a), r, dtqr[a]);
    } else {
#pragma unroll
      for (int a = 0; a < P; ++a) fit = fmaf(dcol[a * T + t], m0[a], fit);
      const float r = y - fit;
      rtqr = fmaf(q[t] * r, r, rtqr);
#pragma unroll
      for (int a = 0; a < P; ++a) dtqr[a] = fmaf(dw[a * T + t], r, dtqr[a]);
    }
  }
  rtqr_out = rtqr;
}

}  // namespace fabber_probe
