// coop_device.cuh: the pieces of the cooperative kernels, for Hopper
// (sm_90a): one voxel a warp of kCoopThreads lanes, its state in the
// block's shared memory. The lanes of a voxel meet at __syncwarp
// (coop_sync) and close their reductions by butterflies (__shfl_xor_sync,
// coop_sum: every lane ends with the same value), never at a block-wide
// barrier, so a block may hold several voxels, a warp each. The host build
// in tests/torch_hostcc.py runs each lane as a host thread; its shim's
// __syncwarp and shuffles meet the 32 threads of one warp.
//
// Shared by kernel 7's cooperative form (fused_vb_iter.cuh
// fused_vb_iter_coop_kernel, past ops/_cuda.py rolled_loops' sizes) and
// kernel 6's full-time form (fused_nl_loop.cuh fused_nl_loop_full_kernel,
// a functor generated from a model that mixes time):
//   coop_sums     the per-group sums over a chunk of kCoopChunk samples in
//                 register tiles of kCoopTile x kCoopTile packed entries a
//                 lane: a sample's Jacobian values of a tile's rows and
//                 columns read once for kCoopTile^2 multiply-adds (a
//                 per-entry loop reads three floats for each), each entry
//                 in the two-level kTB order, so the sums are a per-entry
//                 loop's bit for bit;
//   coop_cholesky right-looking, a lane its rows of the packed triangle:
//                 a column a step, its square root in every lane, the
//                 column scaled, the trailing triangle updated by every
//                 lane in step (P steps of independent work, where a
//                 diagonal on one thread is ~P^2 dependent multiply-adds);
//   coop_inverse  L^-1 a lane its rows, the lanes in step over the
//                 columns; cov = L^-T L^-1 a row at a time, a lane its
//                 columns;
//   coop_trace, coop_chol_solve  split across the lanes and closed by
//                 butterflies.
// Each entry of the factor, L^-1 and cov is vb_device.cuh's arithmetic
// (cholesky, inverse_from_chol: the per-lane kernels' and the plain
// version's order), so the means follow the plain version's rounding; the
// traces' and the LM solve's orders are not trace_packed's and
// chol_solve's: the kernels' gates hold them to float64 lane by lane.

#pragma once

#include "vb_device.cuh"

// clock64 marks per section (probes/csrc/sections.cuh,
// probes/coop_sections.py), empty unless the unit is built with
// -DFABBER_SECTION_CLOCKS
#if defined(FABBER_SECTION_CLOCKS)
#include "sections.cuh"
#else
#ifndef FABBER_MARK
#define FABBER_MARK(k)
#endif
#define FABBER_SEC_BEGIN()
#define FABBER_SEC_END()
#endif

namespace {

using namespace fabber;

constexpr int kCoopThreads = 32;   // the lanes of a voxel's warp
constexpr int kCoopChunk = kCoopThreads;   // samples per chunk, one a lane
static_assert(kCoopChunk % kTB == 0, "chunks of whole time blocks");
constexpr int kCoopTile = 4;   // a coop_sums tile's rows and columns
constexpr unsigned kCoopMask = 0xffffffffu;

__device__ __forceinline__ int coop_lane() {
  return (int)(threadIdx.x % kCoopThreads);
}
__device__ __forceinline__ void coop_sync() { __syncwarp(kCoopMask); }

// the sum of x over the warp's lanes, in every lane (a butterfly: lanes l
// and l ^ o add the same two values at each level)
template <class T>
__device__ __forceinline__ T coop_sum(T x) {
  for (int o = kCoopThreads / 2; o > 0; o >>= 1)
    x = x + __shfl_xor_sync(kCoopMask, x, o);
  return x;
}

// (i, j <= i) of the packed index e
__device__ __forceinline__ void untri(int e, int& i, int& j) {
  i = (int)((sqrtf(8.f * (float)e + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > e) --i;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

// (i, j) of a packed lower triangle moved on by n entries
__device__ __forceinline__ void tri_step(int& i, int& j, int n) {
  j += n;
  while (j > i) {
    j -= i + 1;
    ++i;
  }
}

// ns packed sums [ns][NT] (and, with rvec, the [ns][P] sums J'W r) plus
// the chunk's, weights wts[ns][kCoopChunk], Jacobian rows jac[P][JS]: a
// lane a kCoopTile x kCoopTile tile of a group's packed triangle (a
// diagonal tile's lane the rvec rows of its block too), each entry kTB
// samples into a block sum, the blocks into the total (the per-entry
// loop's arithmetic and order: wj = w_c J_ic, then bs + wj J_jc)
template <int P>
__device__ __forceinline__ void coop_sums(float* sums, float* rvec, int ns,
                                          const float* jac,
                                          const float* wts,
                                          const float* res, int nc) {
  constexpr int R = kCoopTile, NB = (P + R - 1) / R;
  constexpr int NTILE = NB * (NB + 1) / 2, NT = P * (P + 1) / 2,
                JS = kCoopChunk + 1;
  for (int item = coop_lane(); item < ns * NTILE; item += kCoopThreads) {
    const int s = item / NTILE;
    int bi, bj;
    untri(item - s * NTILE, bi, bj);
    const bool diag = bi == bj, with_r = diag && rvec != nullptr;
    const float* w = wts + s * kCoopChunk;
    float* sm = sums + s * NT;
    float* rv = with_r ? rvec + s * P : nullptr;
    const float* ra[R];
    const float* rb[R];
    float tot[R][R], rt[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = bi * R + a, jb = bj * R + a;
      ra[a] = jac + min(i, P - 1) * JS;
      rb[a] = jac + min(jb, P - 1) * JS;
      rt[a] = (with_r && i < P) ? rv[i] : 0.f;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int j = bj * R + b;
        tot[a][b] = (i < P && j <= i) ? sm[tri(i, j)] : 0.f;
      }
    }
    for (int b0 = 0; b0 < nc; b0 += kTB) {
      const int b1 = min(b0 + kTB, nc);
      float bs[R][R], br[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        br[a] = 0.f;
#pragma unroll
        for (int b = 0; b < R; ++b) bs[a][b] = 0.f;
      }
      for (int c = b0; c < b1; ++c) {
        const float wc = w[c];
        float wj[R], y[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          wj[a] = wc * ra[a][c];
          y[a] = rb[a][c];
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
          for (int b = 0; b < R; ++b) bs[a][b] = bs[a][b] + wj[a] * y[b];
        }
        if (with_r) {
          const float rc = res[c];
#pragma unroll
          for (int a = 0; a < R; ++a) br[a] = br[a] + wj[a] * rc;
        }
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
        rt[a] = rt[a] + br[a];
#pragma unroll
        for (int b = 0; b < R; ++b) tot[a][b] = tot[a][b] + bs[a][b];
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int i = bi * R + a;
      if (i >= P) continue;
      if (with_r) rv[i] = rt[a];
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int j = bj * R + b;
        if (j <= i) sm[tri(i, j)] = tot[a][b];
      }
    }
  }
  coop_sync();
}

// per group k'Q_qk over the chunk (res holds k^2), a lane a group
template <int Q>
__device__ __forceinline__ void coop_kqk(float* kqk,
                                         const float* __restrict__ qw,
                                         const float* res, int t0, int nc) {
  for (int q = coop_lane(); q < Q; q += kCoopThreads) {
    float tot = kqk[q];
    for (int b0 = 0; b0 < nc; b0 += kTB) {
      const int b1 = min(b0 + kTB, nc);
      float bk = 0.f;
      for (int c = b0; c < b1; ++c)
        bk = bk + __ldg(qw + (t0 + c) * Q + q) * res[c];
      tot = tot + bk;
    }
    kqk[q] = tot;
  }
  coop_sync();
}

__device__ __forceinline__ void coop_zero(float* x, int n) {
  for (int e = coop_lane(); e < n; e += kCoopThreads) x[e] = 0.f;
  coop_sync();
}

// The rows of a packed lower triangle that a lane owns: i = lane + 32 s,
// s < kCoopRows<P>. Row i starts at tri(i, 0) = i (i + 1) / 2, and the
// starts of any 32 consecutive rows fall in 32 distinct banks (the
// triangular numbers mod 32), so the lanes' entries (i, j) at one column j
// are read and written without bank conflicts, and an entry of one row
// read by every lane is a broadcast.
template <int P>
constexpr int kCoopRows = (P + kCoopThreads - 1) / kCoopThreads;

// the lane's last row, -1 where it owns none
template <int P>
__device__ __forceinline__ int coop_last_row(int lane) {
  return lane < P ? lane + kCoopThreads * ((P - 1 - lane) / kCoopThreads)
                  : -1;
}

// the packed lower factor ch of a (+jit on the diagonal where JITTER),
// right-looking, a lane its rows: at column k every lane takes the
// square root of the diagonal, scales its rows' entries of the column,
// then (after the warp's barrier) subtracts L_ik L_jk from its rows'
// entries (i, j) of the trailing triangle, the lanes in step over j so
// that L_jk is a broadcast. Each entry is vb_device.cuh cholesky's
// arithmetic (a_ij - sum_k L_ik L_jk in k order, times 1 / L_jj), so the
// factor is the per-lane kernels' bit for bit.
template <int P, bool JITTER = false>
__device__ __forceinline__ void coop_cholesky(const float* a, float* ch,
                                              float jit = 0.f) {
  constexpr int S = kCoopRows<P>;
  const int lane = coop_lane();
  const int last = coop_last_row<P>(lane);
  for (int s = 0; s < S; ++s) {
    const int i = lane + kCoopThreads * s;
    if (i >= P) break;
    const int r = i * (i + 1) / 2;
    for (int j = 0; j < i; ++j) ch[r + j] = a[r + j];
    ch[r + i] = JITTER ? a[r + i] + jit : a[r + i];
  }
  coop_sync();
  for (int k = 0; k < P; ++k) {
    const float d = sqrtf(ch[tri(k, k)]);
    const float inv_d = 1.f / d;
    float l[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = lane + kCoopThreads * s;
      l[s] = 0.f;
      if (i > k && i < P) {
        const int e = i * (i + 1) / 2 + k;
        l[s] = ch[e] * inv_d;
        ch[e] = l[s];
      }
    }
    coop_sync();   // the column scaled, ch_kk read by every lane
    if (lane == k % kCoopThreads) ch[tri(k, k)] = d;
    // four columns j at a time: their L_jk, then each row's four entries,
    // loaded together before they are stored (column k is read alone)
    int tj = (k + 1) * (k + 2) / 2;   // tri(j, 0)
    for (int j = k + 1; j <= last; j += 4) {
      float lj[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        lj[u] = j + u <= last ? ch[tj + k] : 0.f;
        tj += j + u + 1;
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = lane + kCoopThreads * s;
        if (i < P && j <= i) {
          float* x = ch + i * (i + 1) / 2 + j;
          float y[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) y[u] = j + u <= i ? x[u] : 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (j + u <= i) x[u] = y[u] - l[s] * lj[u];
          }
        }
      }
    }
    coop_sync();
  }
}

// vb_device.cuh cholesky_jittered's retry: a factor with a non-finite
// diagonal is taken again with +1e-10 (every lane reads the diagonal
// after the warp's barrier, so all take the same branch)
template <int P>
__device__ __forceinline__ void coop_cholesky_jittered(const float* a,
                                                       float* ch) {
  coop_cholesky<P, true>(a, ch, 0.f);
  bool bad = false;
  for (int i = 0; i < P; ++i) bad = bad || !isfinite(ch[tri(i, i)]);
  coop_sync();
  if (bad) coop_cholesky<P, true>(a, ch, 1e-10f);
}

// cov = L^-T L^-1 from the packed factor, vb_device.cuh inverse_from_chol's
// arithmetic entry by entry (so the per-lane kernels' bits): X = L^-1 into
// inv a lane its rows, X_ij = -(sum_{k=j+1..i} L_kj X_ik) / L_jj for j
// from i - 1 down, the lanes in step over j and k so that L_kj is a
// broadcast (each lane reads only its own rows of X: no barrier); then
// cov_ij = sum_{k=i..P-1} X_ki X_kj, row i at a time, a lane its columns
// j <= i (X_ki a broadcast)
template <int P>
__device__ __forceinline__ void coop_inverse(const float* ch, float* inv,
                                             float* cov) {
  constexpr int S = kCoopRows<P>;
  const int lane = coop_lane();
  const int last = coop_last_row<P>(lane);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = lane + kCoopThreads * s;
    if (i < P) {
      const int e = i * (i + 1) / 2 + i;
      inv[e] = 1.f / ch[e];
    }
  }
  for (int j = P - 2; j >= 0; --j) {
    if (j >= last) continue;   // no row of the lane below j
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    int tk = (j + 1) * (j + 2) / 2;   // tri(k, 0)
#pragma unroll 4
    for (int k = j + 1; k <= last; ++k) {
      const float lkj = ch[tk + j];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = lane + kCoopThreads * s;
        if (k <= i && i < P)
          acc[s] = acc[s] + lkj * inv[i * (i + 1) / 2 + k];
      }
      tk += k + 1;
    }
    const float djj = ch[tri(j, j)];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = lane + kCoopThreads * s;
      if (j < i && i < P) inv[i * (i + 1) / 2 + j] = -acc[s] / djj;
    }
  }
  coop_sync();
  for (int i = 0; i < P; ++i) {
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    int tk = i * (i + 1) / 2;   // tri(k, 0)
    for (int k = i; k < P; ++k) {
      const float xki = inv[tk + i];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = lane + kCoopThreads * s;
        if (j <= i) acc[s] = acc[s] + xki * inv[tk + j];
      }
      tk += k + 1;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = lane + kCoopThreads * s;
      if (j <= i) cov[i * (i + 1) / 2 + j] = acc[s];
    }
  }
  coop_sync();
}

// tr(Sigma G) of packed symmetric cov and g (trace_packed's function: an
// off-diagonal product counted twice), in every lane
template <int P>
__device__ __forceinline__ float coop_trace(const float* cov,
                                            const float* g) {
  constexpr int NT = P * (P + 1) / 2;
  const int lane = coop_lane();
  int i, j;
  untri(lane, i, j);
  float part = 0.f;
  for (int e = lane; e < NT; e += kCoopThreads) {
    const float x = cov[e] * g[e];
    part = part + x;
    if (i != j) part = part + x;
    tri_step(i, j, kCoopThreads);
  }
  return coop_sum(part);
}

// tr(Sigma J'Q_qJ) of the groups' sums [Q][NT]
template <int P, int Q>
__device__ __forceinline__ void coop_traces(const float* cov,
                                            const float* sums, float* tr) {
  constexpr int NT = P * (P + 1) / 2;
  for (int q = 0; q < Q; ++q) {
    const float t = coop_trace<P>(cov, sums + q * NT);
    if (coop_lane() == 0) tr[q] = t;
  }
  coop_sync();
}

// L L' x = b in place (b -> x; vb_device.cuh chol_solve's function): a
// row a step, its dot product with the solved entries split across the
// lanes and closed by a butterfly; entry i lives with lane i % 32, which
// alone reads and writes it, so the steps need no barrier
template <int P>
__device__ __forceinline__ void coop_chol_solve(const float* ch, float* b) {
  const int lane = coop_lane();
  for (int i = 0; i < P; ++i) {
    float part = 0.f;
    for (int k = lane; k < i; k += kCoopThreads)
      part = part + ch[tri(i, k)] * b[k];
    const float s = coop_sum(part);
    if (lane == i % kCoopThreads) b[i] = (b[i] - s) / ch[tri(i, i)];
  }
  for (int i = P - 1; i >= 0; --i) {
    float part = 0.f;
    for (int k = i + 1 + (lane - (i + 1) % kCoopThreads + kCoopThreads) %
                             kCoopThreads;
         k < P; k += kCoopThreads)
      part = part + ch[tri(k, i)] * b[k];
    const float s = coop_sum(part);
    if (lane == i % kCoopThreads) b[i] = (b[i] - s) / ch[tri(i, i)];
  }
  coop_sync();
}

// packed symmetric -> full P x P planes [P*P, V], an entry a lane
template <int P>
__device__ __forceinline__ void coop_store_full(const float* packed,
                                                float* __restrict__ out,
                                                long long V, long long v) {
  for (int e = coop_lane(); e < P * P; e += kCoopThreads)
    out[(size_t)e * V + v] = packed[tri(e / P, e % P)];
}

}  // namespace
