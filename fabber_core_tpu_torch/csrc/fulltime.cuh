// fulltime.cuh: the device contract of a full-time model functor, for Hopper
// (sm_90a).
//
// The counterpart of make_full_eval (fabber_core_tpu/ops/fused_vb.py:122-
// 181), the TPU kernel 6's generic full-time mode: a model whose evaluate
// mixes the time axis (a sum, mean or extremum over time, a reversal, a
// slice, a concatenation, a pad, a contraction over time) is
// evaluated over the whole time axis of one voxel at once. The functor,
// generated from the model by models/kernelgen.py's full-time walk, is
//
//   struct GenModel {
//     P, NS, NT (the samples), SMEM (shared floats), NCONST (constants);
//     template <class S, class R>
//     static void run(const S* m, const R* supp, const R* cst, R* sh,
//                     R* out, int lane, int lanes);
//   };
//
// run is called by every thread of a block that serves one voxel (a warp,
// fused_nl_loop.cuh fused_nl_loop_full_kernel): lane `lane` of `lanes` takes
// the samples lane, lane + lanes, ... of each loop. m holds the P
// model-space parameters as dual numbers (dual.cuh, seeded with unit
// tangents), so S carries the Jacobian; supp the voxel's NS suppdata
// values; cst the functor's constants (a device buffer, read through the
// read-only cache); sh SMEM floats of the block's shared memory; out
// (P+1) x NT floats: the signal of sample t at out[t], its derivative by
// parameter i at out[(1+i) NT + t], complete when run returns.
//
// Between two time-mixing ops the lines run per lane, in registers. A
// value a time-mixing op reads is stored by the loop that computes it into
// a plane of sh (ft_store: n samples of an S value's P + 1 components or
// of an R value's one), and the loop ends in the warp's barrier
// (__syncwarp), so every read of a plane follows its last write. Index
// maps (a reversal, a slice, a select, a concatenation, a pad) read the
// plane at another sample; reductions (ft_sum, ft_prod, ft_amax, ft_amin)
// run across the lanes: each lane folds its strided slice of the plane and
// a butterfly of shuffles (ft_close) combines the lanes' results, so each
// lane holds the same result and no second barrier is needed (an extremum
// over time and other axes reads one plane that holds all their elements;
// jax's tie rule: the extreme value by one butterfly, the ties' count and
// tangents by another). A contraction with a constant matrix (ft_dot_rows)
// runs before the loop that reads it: each lane takes its rows, a few at a
// time, so a plane sample is read once for all of them, into a plane of
// its own (then a barrier); the matrix is stored by columns so a warp's
// loads of it are coalesced; a contraction to one sample (ft_dot1) and one
// of two planes that both depend on the parameters (ft_vdot, dot(s, s))
// are reductions. A value with two time axes (outer(s, s)) is never
// stored: a lane owns a sample of the axis its reduction keeps and runs
// the other in a loop of its own, reading the planes there (ft_tie keeps
// jax's rule for an extremum across that loop). The host build
// (tests/torch_hostcc.py) runs each lane as a host thread, its shim's
// __syncwarp and shuffles meeting the warp's 32 threads; with lanes 1 one
// thread takes every sample and no lane is met.
//
// What bounds the functor is its shared memory (the planes, bounded with the
// kernel's state by ops/_cuda.py fulltime_smem) and, for a contraction or
// a value with two time axes, the T^2 (P + 1) operations of each
// evaluation; the matrix columns come from the L1 cache (40 KB at T = 100,
// one copy for every voxel).

#pragma once

#include "dual.cuh"

// clock64 marks per section (probes/csrc/sections.cuh), empty unless the
// unit is built with -DFABBER_SECTION_CLOCKS
#if defined(FABBER_SECTION_CLOCKS)
#include "sections.cuh"
#elif !defined(FABBER_MARK)
#define FABBER_MARK(k)
#endif

namespace fabber {
namespace gen {

template <class T>
__host__ __device__ __forceinline__ T ft_ldg(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// A plane's element type: an S value (a dual number, P + 1 components a
// sample) or an R value (one).
template <class K>
struct PlaneOf {
  static constexpr int W = 1;
  __host__ __device__ static K load(const K* pl, int, int i) { return pl[i]; }
  __host__ __device__ static void store(K* pl, int, int i, K x) {
    pl[i] = x;
  }
};
template <int N, class T>
struct PlaneOf<Dual<N, T>> {
  static constexpr int W = N + 1;
  __host__ __device__ static Dual<N, T> load(const T* pl, int n, int i) {
    Dual<N, T> x;
    x.v = pl[i];
#pragma unroll
    for (int k = 0; k < N; ++k) x.d[k] = pl[(1 + k) * n + i];
    return x;
  }
  __host__ __device__ static void store(T* pl, int n, int i,
                                        const Dual<N, T>& x) {
    pl[i] = x.v;
#pragma unroll
    for (int k = 0; k < N; ++k) pl[(1 + k) * n + i] = x.d[k];
  }
};

// sample i of a plane of n samples
template <class K, class T>
__host__ __device__ __forceinline__ K ft_load(const T* pl, int n, int i) {
  return PlaneOf<K>::load(pl, n, i);
}
template <int N, class T>
__host__ __device__ __forceinline__ void ft_store(T* pl, int n, int i,
                                                  const Dual<N, T>& x) {
  PlaneOf<Dual<N, T>>::store(pl, n, i, x);
}
template <class T>
__host__ __device__ __forceinline__ void ft_store(T* pl, int n, int i, T x) {
  pl[i] = x;
}

// ---- reductions across the lanes ------------------------------------------
//
// Each reduction over a plane runs in every lane of the warp that serves
// the voxel: lane `lane` of `lanes` folds the samples lane, lane + lanes,
// ... in order, then a butterfly over the lanes (ft_close) combines the
// lanes' partial results, so every lane ends with the same value (lanes
// 1: one thread folds the whole plane, sample 0 first).

// the value x of lane `lane ^ o` (a dual number's components one by one)
template <class T>
__host__ __device__ __forceinline__ T ft_xor(T x, int o) {
#if defined(__CUDA_ARCH__) || !defined(__CUDACC__)
  return __shfl_xor_sync(0xffffffffu, x, o);
#else
  return x;   // nvcc's host pass: never called there
#endif
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> ft_xor(const Dual<N, T>& x,
                                                      int o) {
#if defined(__CUDACC__)
  Dual<N, T> r;
  r.v = ft_xor(x.v, o);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = ft_xor(x.d[k], o);
  return r;
#else
  return __shfl_xor_sync(0xffffffffu, x, o);   // the host shim: whole
#endif
}

struct FtAdd {
  template <class K>
  __host__ __device__ K operator()(const K& a, const K& b) const {
    return a + b;
  }
};
struct FtMul {
  template <class K>
  __host__ __device__ K operator()(const K& a, const K& b) const {
    return a * b;
  }
};
template <bool MAX>
struct FtExt {
  template <class T>
  __host__ __device__ T operator()(T a, T b) const {
    return MAX ? g_max(a, b) : g_min(a, b);
  }
};

// The lanes' partial results x combined by op in a butterfly (lanes a
// power of two), the lower lane's operand first, so both lanes of a pair
// compute the same bits. all: every lane folded a sample; else has says
// whether this one did (a plane of fewer samples than lanes), and a lane
// without one takes its partner's.
template <class K, class Op>
__host__ __device__ __forceinline__ K ft_close(K x, bool all, bool has,
                                               int lane, int lanes, Op op) {
  for (int o = lanes / 2; o > 0; o >>= 1) {
    const K y = ft_xor(x, o);
    const bool yh = all || ft_xor((int)has, o) != 0;
    if ((all || has) && yh)
      x = (lane & o) ? op(y, x) : op(x, y);
    else if (yh)
      x = y;
    has = has || yh;
  }
  return x;
}

// A plane's n samples folded by op, each lane its strided slice, then
// closed across the lanes (each component: the value and the tangents).
template <class K, class T, class Op>
__host__ __device__ __forceinline__ K ft_fold(const T* pl, int n, int lane,
                                              int lanes, Op op) {
  FABBER_MARK(12);
  K acc = g_lift<K>(T(0));
  bool has = false;
  for (int i = lane; i < n; i += lanes) {
    const K x = ft_load<K>(pl, n, i);
    acc = has ? op(acc, x) : x;
    has = true;
  }
  acc = ft_close(acc, n >= lanes, has, lane, lanes, op);
  FABBER_MARK(13);
  return acc;
}

// The sum of a plane's n samples.
template <class K, class T>
__host__ __device__ __forceinline__ K ft_sum(const T* pl, int n, int lane,
                                             int lanes) {
  return ft_fold<K>(pl, n, lane, lanes, FtAdd());
}

// The product (a dual number's product rule at each step).
template <class K, class T>
__host__ __device__ __forceinline__ K ft_prod(const T* pl, int n, int lane,
                                              int lanes) {
  return ft_fold<K>(pl, n, lane, lanes, FtMul());
}

// amax / amin over the plane, jax's (and torch's) rule: the extreme value
// (NaN if any is NaN), its tangent the mean of the tangents of the samples
// equal to it (dual.cuh g_extremum's): the extreme value by a butterfly,
// then the ties' count and their tangents' sum by another.
template <bool MAX, class K, class T>
__host__ __device__ __forceinline__ K ft_extremum(const T* pl, int n,
                                                  int lane, int lanes) {
  constexpr int W = PlaneOf<K>::W;
  FABBER_MARK(12);
  T m = T(0);
  bool has = false;
  for (int i = lane; i < n; i += lanes) {
    m = has ? (MAX ? g_max(m, pl[i]) : g_min(m, pl[i])) : pl[i];
    has = true;
  }
  m = ft_close(m, n >= lanes, has, lane, lanes, FtExt<MAX>());
  // the ties' count in place of the value, their tangents' sum after it
  T comp[W];
  for (int k = 0; k < W; ++k) comp[k] = T(0);
  for (int i = lane; i < n; i += lanes) {
    if (pl[i] == m) {
      comp[0] = comp[0] + T(1);
      for (int k = 1; k < W; ++k) comp[k] = comp[k] + pl[k * n + i];
    }
  }
  K ties = ft_close(ft_load<K>(comp, 1, 0), true, true, lane, lanes,
                    FtAdd());
  PlaneOf<K>::store(comp, 1, 0, ties);
  for (int k = 1; k < W; ++k) comp[k] = comp[k] / comp[0];
  comp[0] = m;
  FABBER_MARK(13);
  return ft_load<K>(comp, 1, 0);
}
template <class K, class T>
__host__ __device__ __forceinline__ K ft_amax(const T* pl, int n, int lane,
                                              int lanes) {
  return ft_extremum<true, K>(pl, n, lane, lanes);
}
template <class K, class T>
__host__ __device__ __forceinline__ K ft_amin(const T* pl, int n, int lane,
                                              int lanes) {
  return ft_extremum<false, K>(pl, n, lane, lanes);
}

// A constant matrix C (by columns: C[i, s] at c[s cs + i]) times the
// plane's n samples into the plane dst of nout samples (C's rows): each
// lane takes its rows lane, lane + lanes, ... R at a time, so each plane
// sample is read once for R rows, and sums each row sample 0 first (the
// value and each tangent: sum_s C[i, s] x_s); the lanes of a warp read
// consecutive floats of one column at each step. The caller's barrier
// follows (dst is read at other rows).
template <class K, class T>
__host__ __device__ __forceinline__ void ft_dot_rows(
    const T* __restrict__ c, int cs, const T* pl, int n, int nout, T* dst,
    int lane, int lanes) {
  constexpr int W = PlaneOf<K>::W;
  constexpr int R = W <= 4 ? 4 : (W <= 8 ? 2 : 1);
  FABBER_MARK(12);
  for (int r0 = lane; r0 < nout; r0 += R * lanes) {
    T acc[R][W];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < W; ++k) acc[r][k] = T(0);
    }
    for (int s = 0; s < n; ++s) {
      T x[W];
#pragma unroll
      for (int k = 0; k < W; ++k) x[k] = pl[k * n + s];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r0 + r * lanes;
        if (i < nout) {
          const T a = ft_ldg(c + (long long)s * cs + i);
#pragma unroll
          for (int k = 0; k < W; ++k) acc[r][k] = acc[r][k] + a * x[k];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r0 + r * lanes;
      if (i < nout) {
#pragma unroll
        for (int k = 0; k < W; ++k) dst[k * nout + i] = acc[r][k];
      }
    }
  }
  FABBER_MARK(14);
}

// One row of C (c: its n entries) times the plane, a time-free value:
// each lane its slice, closed across the lanes.
template <class K, class T>
__host__ __device__ __forceinline__ K ft_dot1(const T* __restrict__ c,
                                              const T* pl, int n, int lane,
                                              int lanes) {
  constexpr int W = PlaneOf<K>::W;
  FABBER_MARK(12);
  T comp[W];
  for (int k = 0; k < W; ++k) comp[k] = T(0);
  for (int s = lane; s < n; s += lanes) {
    const T a = ft_ldg(c + s);
    for (int k = 0; k < W; ++k) comp[k] = comp[k] + a * pl[k * n + s];
  }
  const K acc = ft_close(ft_load<K>(comp, 1, 0), true, true, lane, lanes,
                         FtAdd());
  FABBER_MARK(14);
  return acc;
}

// Two planes of n samples contracted over their time axis: sum_s a_s b_s,
// each tangent by the product rule (an S plane's P + 1 components, an R
// plane's one: KA, KB). Both planes may depend on the parameters (dot(s,
// s), s @ s).
template <class K, class KA, class KB, class T>
__host__ __device__ __forceinline__ K ft_vdot(const T* a, const T* b, int n,
                                              int lane, int lanes) {
  FABBER_MARK(12);
  K acc = g_lift<K>(T(0));
  for (int s = lane; s < n; s += lanes)
    acc = acc + ft_load<KA>(a, n, s) * ft_load<KB>(b, n, s);
  acc = ft_close(acc, true, true, lane, lanes, FtAdd());
  FABBER_MARK(13);
  return acc;
}

// An extremum over a loop that runs in one lane (a value with two time
// axes reduced over one of them): the loop's first pass finds the extreme
// value m (g_max / g_min), its second folds each x equal to m into the sum
// of their tangents and their count (ft_tie), and ft_tie_result gives m
// with the mean of the tied tangents: ft_extremum's rule, jax's.
template <class K, class T>
__host__ __device__ __forceinline__ void ft_tie(K& acc, T& cnt, const K& x,
                                                T m) {
  if (g_val(x) == m) {
    acc = acc + x;
    cnt = cnt + T(1);
  }
}
// A lane's ties with an extreme value taken over every lane (an extremum
// over both time axes of a value with two): their count as the value,
// their tangents' sum as the tangents; the lanes' sum (ft_sum) then gives
// ft_tie_result both.
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> ft_tie_pack(
    const Dual<N, T>& acc, T cnt) {
  Dual<N, T> r = acc;
  r.v = cnt;
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> ft_tie_result(
    T m, const Dual<N, T>& acc, T cnt) {
  Dual<N, T> r;
  r.v = m;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = acc.d[k] / cnt;
  return r;
}

// A full-time functor's signal and model-space Jacobian over the voxel's
// samples into out: the parameters m (P model-space values, the same in
// every lane) seeded with unit tangents (device code, as M::run).
template <class M, class T>
__device__ __forceinline__ void run_dual(const T* m, const T* supp,
                                         const T* cst, T* sh, T* out,
                                         int lane, int lanes) {
  constexpr int P = M::P;
  Dual<P, T> x[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    x[i].v = m[i];
#pragma unroll
    for (int j = 0; j < P; ++j) x[i].d[j] = i == j ? T(1) : T(0);
  }
  M::template run<Dual<P, T>, T>(x, supp, cst, sh, out, lane, lanes);
}

}  // namespace gen
}  // namespace fabber
