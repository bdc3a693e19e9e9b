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
// of an R value's one), and the loop ends in a barrier, so every
// read of a plane follows its last write. Index maps (a reversal, a slice,
// a select, a concatenation, a pad) read the plane at another sample;
// reductions (ft_sum, ft_prod, ft_amax, ft_amin) run in every lane over
// the whole plane, in one fixed order (sample 0 first), so each lane holds
// the same result and no second barrier is needed (an extremum over time
// and other axes reads one plane that holds all their elements); a
// contraction with a constant matrix (ft_dot) takes one row of the matrix
// a sample, against the whole plane, the matrix stored by columns so a
// warp's loads of it are coalesced; one of two planes that both depend on
// the parameters (ft_vdot, dot(s, s)) runs in every lane, as a
// reduction. A value with two time axes (outer(s, s)) is never stored: a
// lane owns a sample of the axis its reduction keeps and runs the other
// in a loop of its own, reading the planes there (ft_tie keeps jax's rule
// for an extremum across that loop). No warp shuffles: the threads meet
// at __syncthreads only, so the host build (tests/torch_hostcc.py) runs a
// block's threads as host threads.
//
// What bounds the functor is its shared memory (the planes, bounded with the
// kernel's state by ops/_cuda.py fulltime_smem) and, for a contraction or
// a value with two time axes, the T^2 (P + 1) operations of each
// evaluation; the matrix rows come from the L1 cache (40 KB at T = 100,
// one block for every voxel).

#pragma once

#include "dual.cuh"

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

// The sum of a plane's n samples, sample 0 first (each component: the
// value and the tangents).
template <class K, class T>
__host__ __device__ __forceinline__ K ft_sum(const T* pl, int n) {
  K acc = ft_load<K>(pl, n, 0);
  for (int i = 1; i < n; ++i) acc = acc + ft_load<K>(pl, n, i);
  return acc;
}

// The product, sample 0 first (a dual number's product rule at each step).
template <class K, class T>
__host__ __device__ __forceinline__ K ft_prod(const T* pl, int n) {
  K acc = ft_load<K>(pl, n, 0);
  for (int i = 1; i < n; ++i) acc = acc * ft_load<K>(pl, n, i);
  return acc;
}

// amax / amin over the plane, jax's (and torch's) rule: the extreme value
// (NaN if any is NaN), its tangent the mean of the tangents of the samples
// equal to it (dual.cuh g_extremum's).
template <bool MAX, class K, class T>
__host__ __device__ __forceinline__ K ft_extremum(const T* pl, int n) {
  constexpr int W = PlaneOf<K>::W;
  T m = pl[0];
  for (int i = 1; i < n; ++i) m = MAX ? g_max(m, pl[i]) : g_min(m, pl[i]);
  T comp[W];
  comp[0] = m;
  T count = T(0);
  for (int k = 1; k < W; ++k) comp[k] = T(0);
  for (int i = 0; i < n; ++i) {
    if (pl[i] == m) {
      count = count + T(1);
      for (int k = 1; k < W; ++k) comp[k] = comp[k] + pl[k * n + i];
    }
  }
  for (int k = 1; k < W; ++k) comp[k] = comp[k] / count;
  return ft_load<K>(comp, 1, 0);
}
template <class K, class T>
__host__ __device__ __forceinline__ K ft_amax(const T* pl, int n) {
  return ft_extremum<true, K>(pl, n);
}
template <class K, class T>
__host__ __device__ __forceinline__ K ft_amin(const T* pl, int n) {
  return ft_extremum<false, K>(pl, n);
}

// Row i of a constant matrix C times the plane's n samples, sample 0
// first: sum_s C[i, s] x_s for the value and each tangent. c holds C by
// columns (C[i, s] at c[s cs + i]), so the lanes of a warp, each at its
// own row i, read consecutive floats of one column at each step.
template <class K, class T>
__host__ __device__ __forceinline__ K ft_dot(const T* __restrict__ c, int cs,
                                             const T* pl, int n, int i) {
  constexpr int W = PlaneOf<K>::W;
  T comp[W];
  for (int k = 0; k < W; ++k) comp[k] = T(0);
  for (int s = 0; s < n; ++s) {
    const T a = ft_ldg(c + (long long)s * cs + i);
    for (int k = 0; k < W; ++k) comp[k] = comp[k] + a * pl[k * n + s];
  }
  return ft_load<K>(comp, 1, 0);
}

// Two planes of n samples contracted over their time axis, sample 0 first:
// sum_s a_s b_s, each tangent by the product rule (an S plane's P + 1
// components, an R plane's one: KA, KB). Both planes may depend on the
// parameters (dot(s, s), s @ s); each lane computes the same sum.
template <class K, class KA, class KB, class T>
__host__ __device__ __forceinline__ K ft_vdot(const T* a, const T* b,
                                              int n) {
  K acc = g_lift<K>(T(0));
  for (int s = 0; s < n; ++s)
    acc = acc + ft_load<KA>(a, n, s) * ft_load<KB>(b, n, s);
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
