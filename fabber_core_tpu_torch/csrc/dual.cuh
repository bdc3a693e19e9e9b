// dual.cuh: forward-mode dual numbers for model functors generated from a
// model's evaluate() (models/kernelgen.py), for Hopper (sm_90a).
//
// The counterpart of the jax.linearize the TPU kernel runs on a traced
// evaluate (fabber_core_tpu/ops/fused_vb.py make_full_eval, :165-173): a
// generated functor's signal<S, R>() is instantiated with S = Dual<P,
// float> seeded with unit tangents on the P model-space parameters, which
// yields the signal and the model-space Jacobian in one evaluation. R is
// the real type of the values that do not depend on the parameters (the
// sample index, suppdata, constants): only these carry no tangent. A
// value of type S carries all P tangents, the seeds' zeros included, and
// its operations compute each of them. The tangent rules are torch's
// forward-mode formulas (tools/autograd/derivatives.yaml) away from
// kinks, and jax's at them, as the JAX package (and the port's plain
// versions, models/kinks.py) differentiate: abs has tangent +t at 0
// (jax selects on x >= 0), clamp is max then min against its bounds,
// each splitting a tie in half (t/2 at a bound, as jnp.clip), and
// amax/amin share the tangent evenly among the tied elements.
// Transcendentals are the full-accuracy expf/logf/... (no
// --use_fast_math), as vb_device.cuh requires.
//
// Every function is __host__ __device__, so a generated functor also
// compiles as host C++ (at double) for the CPU tests.

#pragma once

#include <math.h>

namespace fabber {
namespace gen {

template <int N, class T>
struct Dual {
  T v;
  T d[N];
};

// ---- real overloads (float: the kernel; double: the host tests) ---------

#define FABBER_GEN_REAL1(NAME, FEXPR, DEXPR)                          \
  __host__ __device__ __forceinline__ float NAME(float x) { return FEXPR; } \
  __host__ __device__ __forceinline__ double NAME(double x) { return DEXPR; }

FABBER_GEN_REAL1(g_exp, expf(x), exp(x))
FABBER_GEN_REAL1(g_log, logf(x), log(x))
FABBER_GEN_REAL1(g_log1p, log1pf(x), log1p(x))
FABBER_GEN_REAL1(g_expm1, expm1f(x), expm1(x))
FABBER_GEN_REAL1(g_sqrt, sqrtf(x), sqrt(x))
FABBER_GEN_REAL1(g_rsqrt, 1.f / sqrtf(x), 1.0 / sqrt(x))
FABBER_GEN_REAL1(g_sin, sinf(x), sin(x))
FABBER_GEN_REAL1(g_cos, cosf(x), cos(x))
FABBER_GEN_REAL1(g_tan, tanf(x), tan(x))
FABBER_GEN_REAL1(g_asin, asinf(x), asin(x))
FABBER_GEN_REAL1(g_acos, acosf(x), acos(x))
FABBER_GEN_REAL1(g_atan, atanf(x), atan(x))
FABBER_GEN_REAL1(g_sinh, sinhf(x), sinh(x))
FABBER_GEN_REAL1(g_cosh, coshf(x), cosh(x))
FABBER_GEN_REAL1(g_tanh, tanhf(x), tanh(x))
FABBER_GEN_REAL1(g_asinh, asinhf(x), asinh(x))
FABBER_GEN_REAL1(g_acosh, acoshf(x), acosh(x))
FABBER_GEN_REAL1(g_atanh, atanhf(x), atanh(x))
FABBER_GEN_REAL1(g_erf, erff(x), erf(x))
FABBER_GEN_REAL1(g_erfc, erfcf(x), erfc(x))
FABBER_GEN_REAL1(g_sigmoid, 1.f / (1.f + expf(-x)), 1.0 / (1.0 + exp(-x)))
FABBER_GEN_REAL1(g_abs, fabsf(x), fabs(x))
FABBER_GEN_REAL1(g_reciprocal, 1.f / x, 1.0 / x)
FABBER_GEN_REAL1(g_floor, floorf(x), floor(x))
FABBER_GEN_REAL1(g_ceil, ceilf(x), ceil(x))
FABBER_GEN_REAL1(g_round, rintf(x), rint(x))   // half to even, as torch
FABBER_GEN_REAL1(g_trunc, truncf(x), trunc(x))
FABBER_GEN_REAL1(g_sign, (float)((x > 0.f) - (x < 0.f)),
                 (double)((x > 0.0) - (x < 0.0)))
#undef FABBER_GEN_REAL1

__host__ __device__ __forceinline__ float g_powr(float x, float y) {
  return powf(x, y);
}
__host__ __device__ __forceinline__ double g_powr(double x, double y) {
  return pow(x, y);
}
// torch's rounding divisions of values (div with rounding_mode "floor", c10's
// div_floor_floating, and "trunc"): their derivative is zero, as torch's
// and jax's (the floor of a quotient), so they take and give reals
#define FABBER_GEN_FLOORDIV(T, FMOD, FLOOR, COPYSIGN)                        \
  __host__ __device__ __forceinline__ T g_floordiv(T a, T b) {               \
    if (b == T(0)) return a / b;                                              \
    const T mod = FMOD(a, b);                                                 \
    T div = (a - mod) / b;                                                    \
    if (mod != T(0) && (b < T(0)) != (mod < T(0))) div = div - T(1);          \
    if (div == T(0)) return COPYSIGN(T(0), a / b);                            \
    T fl = FLOOR(div);                                                        \
    if (div - fl > T(0.5)) fl = fl + T(1);                                    \
    return fl;                                                                \
  }                                                                           \
  __host__ __device__ __forceinline__ T g_truncdiv(T a, T b) {               \
    return g_trunc(a / b);                                                    \
  }
FABBER_GEN_FLOORDIV(float, fmodf, floorf, copysignf)
FABBER_GEN_FLOORDIV(double, fmod, floor, copysign)
#undef FABBER_GEN_FLOORDIV

__host__ __device__ __forceinline__ float g_atan2(float y, float x) {
  return atan2f(y, x);
}
__host__ __device__ __forceinline__ double g_atan2(double y, double x) {
  return atan2(y, x);
}

// x^c for a constant exponent, with torch's special cases (x*x for 2,
// sqrt for 0.5, ...), which its CPU kernel takes too
template <class T>
__host__ __device__ __forceinline__ T powc_real(T x, T c) {
  if (c == T(2)) return x * x;
  if (c == T(3)) return x * x * x;
  if (c == T(1)) return x;
  if (c == T(0)) return T(1);
  if (c == T(0.5)) return g_sqrt(x);
  if (c == T(-0.5)) return g_rsqrt(x);
  if (c == T(-1)) return T(1) / x;
  if (c == T(-2)) return T(1) / (x * x);
  return g_powr(x, c);
}

template <class T>
__host__ __device__ __forceinline__ T g_val(T x) { return x; }
template <int N, class T>
__host__ __device__ __forceinline__ T g_val(const Dual<N, T>& x) {
  return x.v;
}

template <class T>
__host__ __device__ __forceinline__ T g_powc(T x, T c) {
  return powc_real(x, c);
}
template <class T>
__host__ __device__ __forceinline__ T g_pow(T x, T y) { return g_powr(x, y); }
template <class T>
__host__ __device__ __forceinline__ T g_max(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));   // NaN propagates
}
template <class T>
__host__ __device__ __forceinline__ T g_min(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}
template <class T>
__host__ __device__ __forceinline__ T g_clamp(T x, T lo, T hi) {
  return g_min(g_max(x, lo), hi);
}
template <class T>
__host__ __device__ __forceinline__ T g_where(bool c, T a, T b) {
  return c ? a : b;
}

// a real as the parameters' scalar type (zero tangent)
template <class S, class T>
struct Lift {
  __host__ __device__ static S of(T x) { return S(x); }
};
template <int N, class T>
struct Lift<Dual<N, T>, T> {
  __host__ __device__ static Dual<N, T> of(T x) {
    Dual<N, T> r;
    r.v = x;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = T(0);
    return r;
  }
};
template <class S, class T>
__host__ __device__ __forceinline__ S g_lift(T x) {
  return Lift<S, T>::of(x);
}

// ---- dual arithmetic ------------------------------------------------------

// value y, tangent d * f
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> scaled(const Dual<N, T>& a,
                                                      T y, T f) {
  Dual<N, T> r;
  r.v = y;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * f;
  return r;
}

// value y, tangent d / g
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> divided(const Dual<N, T>& a,
                                                       T y, T g) {
  Dual<N, T> r;
  r.v = y;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / g;
  return r;
}

template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator-(const Dual<N, T>& a) {
  Dual<N, T> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}

template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator+(const Dual<N, T>& a,
                                                         const Dual<N, T>& b) {
  Dual<N, T> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator+(const Dual<N, T>& a,
                                                         T b) {
  Dual<N, T> r = a;
  r.v = a.v + b;
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator+(T a,
                                                         const Dual<N, T>& b) {
  Dual<N, T> r = b;
  r.v = a + b.v;
  return r;
}

template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator-(const Dual<N, T>& a,
                                                         const Dual<N, T>& b) {
  Dual<N, T> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator-(const Dual<N, T>& a,
                                                         T b) {
  Dual<N, T> r = a;
  r.v = a.v - b;
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator-(T a,
                                                         const Dual<N, T>& b) {
  Dual<N, T> r = -b;
  r.v = a - b.v;
  return r;
}

// torch: other_t * self_p + self_t * other_p
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator*(const Dual<N, T>& a,
                                                         const Dual<N, T>& b) {
  Dual<N, T> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = b.d[i] * a.v + a.d[i] * b.v;
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator*(const Dual<N, T>& a,
                                                         T b) {
  return scaled(a, a.v * b, b);
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator*(T a,
                                                         const Dual<N, T>& b) {
  return scaled(b, a * b.v, a);
}

// torch: self_t / other_p - other_t * (self_p / other_p) / other_p
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator/(const Dual<N, T>& a,
                                                         const Dual<N, T>& b) {
  Dual<N, T> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / b.v - b.d[i] * r.v / b.v;
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator/(const Dual<N, T>& a,
                                                         T b) {
  return divided(a, a.v / b, b);
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> operator/(T a,
                                                         const Dual<N, T>& b) {
  Dual<N, T> r;
  r.v = a / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i] * r.v / b.v;
  return r;
}

// ---- dual functions (torch's forward-mode rules) --------------------------

#define FABBER_GEN_DUAL(NAME, Y, TANGENT_OF_DI)                        \
  template <int N, class T>                                              \
  __host__ __device__ __forceinline__ Dual<N, T> NAME(const Dual<N, T>& a) { \
    const T x = a.v;                                                     \
    const T y = Y;                                                       \
    Dual<N, T> r;                                                        \
    r.v = y;                                                             \
    _Pragma("unroll") for (int i = 0; i < N; ++i) {                      \
      const T di = a.d[i];                                               \
      r.d[i] = TANGENT_OF_DI;                                            \
    }                                                                    \
    return r;                                                            \
  }

FABBER_GEN_DUAL(g_exp, g_exp(x), di * y)
FABBER_GEN_DUAL(g_log, g_log(x), di / x)
FABBER_GEN_DUAL(g_log1p, g_log1p(x), di / (x + T(1)))
FABBER_GEN_DUAL(g_expm1, g_expm1(x), di * (y + T(1)))
FABBER_GEN_DUAL(g_sqrt, g_sqrt(x), di / (T(2) * y))
FABBER_GEN_DUAL(g_rsqrt, g_rsqrt(x), T(-0.5) * di * (y * y * y))
FABBER_GEN_DUAL(g_sin, g_sin(x), di * g_cos(x))
FABBER_GEN_DUAL(g_cos, g_cos(x), di * -g_sin(x))
FABBER_GEN_DUAL(g_tan, g_tan(x), di * (T(1) + y * y))
FABBER_GEN_DUAL(g_asin, g_asin(x), di * g_rsqrt(-x * x + T(1)))
FABBER_GEN_DUAL(g_acos, g_acos(x), di * -g_rsqrt(-x * x + T(1)))
FABBER_GEN_DUAL(g_atan, g_atan(x), di / (x * x + T(1)))
FABBER_GEN_DUAL(g_sinh, g_sinh(x), di * g_cosh(x))
FABBER_GEN_DUAL(g_cosh, g_cosh(x), di * g_sinh(x))
FABBER_GEN_DUAL(g_tanh, g_tanh(x), di * (T(1) - y * y))
FABBER_GEN_DUAL(g_asinh, g_asinh(x), di * g_rsqrt(x * x + T(1)))
FABBER_GEN_DUAL(g_acosh, g_acosh(x), di * g_rsqrt((x - T(1)) * (x + T(1))))
FABBER_GEN_DUAL(g_atanh, g_atanh(x), di / (T(1) - x * x))
FABBER_GEN_DUAL(g_erf, g_erf(x),
                T(1.1283791670955126) * g_exp(-x * x) * di)
FABBER_GEN_DUAL(g_erfc, g_erfc(x),
                T(-1.1283791670955126) * g_exp(-x * x) * di)
FABBER_GEN_DUAL(g_sigmoid, g_sigmoid(x), di * (T(1) - y) * y)
// jax: select(x >= 0, t, -t), so +t at 0 (torch's sgn(x) t gives 0)
FABBER_GEN_DUAL(g_abs, g_abs(x), x >= T(0) ? di : -di)
FABBER_GEN_DUAL(g_reciprocal, g_reciprocal(x), -di * (y * y))
#undef FABBER_GEN_DUAL

// x^c, c constant: torch pow_backward, c * x^(c-1) (0 for c == 0)
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_powc(const Dual<N, T>& a,
                                                      T c) {
  const T f = c == T(0) ? T(0) : c * powc_real(a.v, c - T(1));
  return scaled(a, powc_real(a.v, c), f);
}

// x^y: y x^(y-1) dx + (x == 0 and y >= 0 ? 0 : x^y log x) dy
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_pow(const Dual<N, T>& a,
                                                     const Dual<N, T>& b) {
  const T y = g_powr(a.v, b.v);
  const T fx = b.v == T(0) ? T(0) : b.v * g_powr(a.v, b.v - T(1));
  const T fy = (a.v == T(0) && b.v >= T(0)) ? T(0) : y * g_log(a.v);
  Dual<N, T> r;
  r.v = y;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * fx + b.d[i] * fy;
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_pow(const Dual<N, T>& a,
                                                     T b) {
  return g_powc(a, b);
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_pow(T a,
                                                     const Dual<N, T>& b) {
  const T y = g_powr(a, b.v);
  const T fy = (a == T(0) && b.v >= T(0)) ? T(0) : y * g_log(a);
  return scaled(b, y, fy);
}

// torch: other_t + where(a == b, 0.5, a > b) * (self_t - other_t)
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> max_min(const Dual<N, T>& a,
                                                       const Dual<N, T>& b,
                                                       bool is_max) {
  const T w = a.v == b.v ? T(0.5)
                         : ((is_max ? a.v > b.v : a.v < b.v) ? T(1) : T(0));
  Dual<N, T> r;
  r.v = is_max ? g_max(a.v, b.v) : g_min(a.v, b.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = b.d[i] + w * (a.d[i] - b.d[i]);
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_max(const Dual<N, T>& a,
                                                     const Dual<N, T>& b) {
  return max_min(a, b, true);
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_max(const Dual<N, T>& a,
                                                     T b) {
  return max_min(a, g_lift<Dual<N, T>>(b), true);
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_max(T a,
                                                     const Dual<N, T>& b) {
  return max_min(g_lift<Dual<N, T>>(a), b, true);
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_min(const Dual<N, T>& a,
                                                     const Dual<N, T>& b) {
  return max_min(a, b, false);
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_min(const Dual<N, T>& a,
                                                     T b) {
  return max_min(a, g_lift<Dual<N, T>>(b), false);
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_min(T a,
                                                     const Dual<N, T>& b) {
  return max_min(g_lift<Dual<N, T>>(a), b, false);
}

// jax's clip: min(max(x, lo), hi), so t strictly inside, t/2 at a bound
// (each tie splits), 0 outside (torch's clamp gives t at a bound)
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_clamp(const Dual<N, T>& a,
                                                       T lo, T hi) {
  return g_min(g_max(a, lo), hi);
}

// amax/amin over n values, jax's (and torch's) rule: the value of the
// extremum (NaN if any is NaN), the tangent the mean of the tangents of
// the elements equal to it (0/0 where the value is NaN, as jax's).
// g_extremum<true>(a, b, ...) is amax; g_extremum<false> amin.
template <bool MAX, class T>
__host__ __device__ __forceinline__ T g_extremum(T a) {
  return a;
}
template <bool MAX, class T, class... R>
__host__ __device__ __forceinline__ T g_extremum(T a, T b, R... rest) {
  return g_extremum<MAX>(MAX ? g_max(a, b) : g_min(a, b), rest...);
}
template <bool MAX, int N, class T, class... R>
__host__ __device__ __forceinline__ Dual<N, T> g_extremum(
    const Dual<N, T>& a, const Dual<N, T>& b, const R&... rest) {
  const Dual<N, T>* xs[] = {&a, &b, &rest...};
  constexpr int n = 2 + sizeof...(R);
  T m = a.v;
#pragma unroll
  for (int i = 1; i < n; ++i)
    m = MAX ? g_max(m, xs[i]->v) : g_min(m, xs[i]->v);
  Dual<N, T> r;
  r.v = m;
  T count = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) r.d[j] = T(0);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    if (xs[i]->v == m) {
      count = count + T(1);
#pragma unroll
      for (int j = 0; j < N; ++j) r.d[j] = r.d[j] + xs[i]->d[j];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) r.d[j] = r.d[j] / count;
  return r;
}

// torch atan2_backward: recip = 1 / (x^2 + y^2); dy x recip - dx y recip
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_atan2(const Dual<N, T>& a,
                                                       const Dual<N, T>& b) {
  const T recip = T(1) / (b.v * b.v + a.v * a.v);
  Dual<N, T> r;
  r.v = g_atan2(a.v, b.v);
#pragma unroll
  for (int i = 0; i < N; ++i)
    r.d[i] = a.d[i] * (b.v * recip) + b.d[i] * (-a.v * recip);
  return r;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_atan2(const Dual<N, T>& a,
                                                       T b) {
  return g_atan2(a, g_lift<Dual<N, T>>(b));
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_atan2(T a,
                                                       const Dual<N, T>& b) {
  return g_atan2(g_lift<Dual<N, T>>(a), b);
}

template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_where(bool c,
                                                       const Dual<N, T>& a,
                                                       const Dual<N, T>& b) {
  return c ? a : b;
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_where(bool c,
                                                       const Dual<N, T>& a,
                                                       T b) {
  return c ? a : g_lift<Dual<N, T>>(b);
}
template <int N, class T>
__host__ __device__ __forceinline__ Dual<N, T> g_where(bool c, T a,
                                                       const Dual<N, T>& b) {
  return c ? g_lift<Dual<N, T>>(a) : b;
}

// A generated functor's signal and model-space Jacobian at one sample:
// the parameters seeded with unit tangents.
template <class M, int P, class T>
__host__ __device__ __forceinline__ T eval_dual(const T* m, const T* supp,
                                                T t, T* jac) {
  Dual<P, T> x[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    x[i].v = m[i];
#pragma unroll
    for (int j = 0; j < P; ++j) x[i].d[j] = i == j ? T(1) : T(0);
  }
  const Dual<P, T> r = M::template signal<Dual<P, T>, T>(x, supp, t);
#pragma unroll
  for (int i = 0; i < P; ++i) jac[i] = r.d[i];
  return r.v;
}

}  // namespace gen
}  // namespace fabber
