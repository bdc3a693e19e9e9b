// probes/csrc/core_compact.cu: kernel 2 (fabber_core_tpu_torch/csrc/
// spectral_core.cu, included whole) with two compactions of its
// trialmode instance, for probes/core_stragglers.py, built alone by
// probes/variants.py. Neither beat one launch on an H100 (PERF.md §6
// row 2d), so the package launches once; they stay here as the record.
//
// Under trialmode a lane either stops within 7-8 trips or enters its
// trials and runs about twice as long, and a warp runs until its slowest
// lane is done: on phase 5c's plane (16,777,216 voxels) sorting the lanes
// by their trips took one launch from 2.509 to 1.677 ms.
//
//   two-phase   (fabber_core_two_phase) two launches with no host
//               synchronisation between them: phase 1 runs every lane to
//               at most kPhase1Trips trips and writes the lanes done by
//               then; each unfinished lane appends its whole state (v,
//               the trips made, the rotated statistics, the loop's phis
//               and flags, the detector state) to a compact buffer, one
//               atomicAdd per warp (ballot, popc); phase 2, a grid-stride
//               kernel sized to the SMs, reads the count from device
//               memory and finishes each appended lane with the same
//               loop, writing its outputs at v. It measured 4.090 against
//               2.509 ms: phase 2 writes a third of every output sector
//               long after phase 1 wrote the rest, at scattered v, and
//               both kernels hold 64 registers against one launch's 40.
//   block-local (fabber_core_block) the block's unfinished lanes put
//               their state in shared memory, meet at the block's
//               barrier, and the block's first threads finish them, one
//               lane each, so their warps carry no lane that is already
//               done and the block's other warps exit; the two writes of
//               an output sector stay within one block's life. It moved
//               -0.5% to +4.4%, within the spread.
//
// Each lane runs the pieces of spectral_device.cuh that core_voxel runs
// (rotate, det_loop, det_finish, rebuild), in the same order, so both
// forms agree with one launch bit for bit (tests/test_torch_spectral_
// kernels.py checks the two-phase form on the host).
//
// kPhase1Trips: on that plane's trips (the plain version's, per lane)
// 52.0% of lanes are done at 7 trips, 67.5% at 8 and the rest at 16; a
// warp costs its slowest lane's trips, so phase 1 at K trips and phase 2
// over the rest cost about K + (16 - K) x (share left at K) warp trips:
// 11.3 at K = 7, 10.6 at 8, 13.3 at 12, against 16 in one launch (the
// sorted lanes' mean, 10.1, is the floor).

#include "spectral_core.cu"

namespace {

using fabber_spectral::DetLoop;
using fabber_spectral::Rotated;

constexpr int kPhase1Trips = 8;

// The rest of a detector lane's core from its loop state l (trips made
// so far in l.it): the loop to n_iters trips or until done, the
// finalize, rebuild.
template <int P, int KIND>
__device__ __forceinline__ void core_resume(
    const Rotated<P>& r, DetLoop& l, const CoreConsts& k,
    const DetParams& det, int n_iters, long long V, long long v,
    float* __restrict__ means_out, float* __restrict__ prec_out,
    float* __restrict__ cov_out, float* __restrict__ b_out,
    float* __restrict__ c_out, float* __restrict__ f_out,
    float* __restrict__ tr_out) {
  fabber_spectral::det_loop<P, KIND>(r, k, det, n_iters, l);
  bool sel_init;
  int its;
  const float s = fabber_spectral::det_finish(l, sel_init, its);
  fabber_spectral::rebuild<P, KIND>(r, s, sel_init, its, k, V, v, means_out,
                                    prec_out, cov_out, b_out, c_out, f_out,
                                    tr_out);
}

// The first phase of a detector lane's core: rotate and at most `trips`
// trips of the loop from s0 = b_init c_init. A lane done by then (or at
// n_iters) is finished and written, and true returned; else false, with
// the lane's state in r and l for core_resume.
template <int P, int KIND>
__device__ __forceinline__ bool core_phase1(
    const float* m0, const float rtqr, const float* dtqr, const float* pm,
    const CoreConsts& k, const DetParams& det, int n_iters, int trips,
    long long V, long long v, float* __restrict__ means_out,
    float* __restrict__ prec_out, float* __restrict__ cov_out,
    float* __restrict__ b_out, float* __restrict__ c_out,
    float* __restrict__ f_out, float* __restrict__ tr_out, Rotated<P>& r,
    DetLoop& l) {
  constexpr int oS = 4 * P * P + 2 * P;   // pack_spectral_consts' scalars
  r = fabber_spectral::rotate<P>(m0, rtqr, dtqr, pm, k);
  l = fabber_spectral::det_loop_start(k.v[oS + 2] * k.v[oS + 3], det);
  fabber_spectral::det_loop<P, KIND>(r, k, det,
                                     trips < n_iters ? trips : n_iters, l);
  if (!l.cv.done && l.it < n_iters) return false;
  core_resume<P, KIND>(r, l, k, det, n_iters, V, v, means_out, prec_out,
                       cov_out, b_out, c_out, f_out, tr_out);
  return true;
}

// A lane's state between the phases, field f of slot i at [f * V + i]:
// 4P + 5 floats ut, u0t, vt, m0t (P each), rtqr, cur_s, gen_s, best_s,
// prev_f; 5 ints v, it, its, trials and the flags below.
enum : int {
  kFlagInit = 1, kFlagBestInit = 2, kFlagSave = 4, kFlagRevert = 8,
  kFlagTrial = 16
};
template <int P>
__device__ __forceinline__ void save_lane(const Rotated<P>& r,
                                          const DetLoop& l, long long v,
                                          long long i, long long V,
                                          float* __restrict__ fs,
                                          int* __restrict__ is) {
#pragma unroll
  for (int a = 0; a < P; ++a) {
    fs[(size_t)a * V + i] = r.ut[a];
    fs[(size_t)(P + a) * V + i] = r.u0t[a];
    fs[(size_t)(2 * P + a) * V + i] = r.vt[a];
    fs[(size_t)(3 * P + a) * V + i] = r.m0t[a];
  }
  fs[(size_t)(4 * P) * V + i] = r.rtqr;
  fs[(size_t)(4 * P + 1) * V + i] = l.cur_s;
  fs[(size_t)(4 * P + 2) * V + i] = l.gen_s;
  fs[(size_t)(4 * P + 3) * V + i] = l.best_s;
  fs[(size_t)(4 * P + 4) * V + i] = l.cv.prev_f;
  is[i] = (int)v;
  is[V + i] = l.it;
  is[2 * V + i] = l.cv.its;
  is[3 * V + i] = l.cv.trials;
  is[4 * V + i] = (l.is_init ? kFlagInit : 0) |
                  (l.best_init ? kFlagBestInit : 0) |
                  (l.cv.save ? kFlagSave : 0) |
                  (l.cv.revert ? kFlagRevert : 0) |
                  (l.cv.trialmode ? kFlagTrial : 0);
}

template <int P>
__device__ __forceinline__ long long load_lane(const float* __restrict__ fs,
                                               const int* __restrict__ is,
                                               long long i, long long V,
                                               Rotated<P>& r, DetLoop& l) {
#pragma unroll
  for (int a = 0; a < P; ++a) {
    r.ut[a] = fs[(size_t)a * V + i];
    r.u0t[a] = fs[(size_t)(P + a) * V + i];
    r.vt[a] = fs[(size_t)(2 * P + a) * V + i];
    r.m0t[a] = fs[(size_t)(3 * P + a) * V + i];
  }
  r.rtqr = fs[(size_t)(4 * P) * V + i];
  l.cur_s = fs[(size_t)(4 * P + 1) * V + i];
  l.gen_s = fs[(size_t)(4 * P + 2) * V + i];
  l.best_s = fs[(size_t)(4 * P + 3) * V + i];
  l.cv.prev_f = fs[(size_t)(4 * P + 4) * V + i];
  l.it = is[V + i];
  l.cv.its = is[2 * V + i];
  l.cv.trials = is[3 * V + i];
  const int flags = is[4 * V + i];
  l.is_init = (flags & kFlagInit) != 0;
  l.best_init = (flags & kFlagBestInit) != 0;
  l.cv.save = (flags & kFlagSave) != 0;
  l.cv.revert = (flags & kFlagRevert) != 0;
  l.cv.trialmode = (flags & kFlagTrial) != 0;
  l.cv.done = false;
  l.cv.lm_on = false;
  l.cv.alpha = 0.f;
  return is[i];
}

template <int P, int KIND>
__global__ void __launch_bounds__(kThreads)
core_phase1_kernel(const float* __restrict__ m0_in,
                   const float* __restrict__ rtqr_in,
                   const float* __restrict__ dtqr_in,
                   const float* __restrict__ pm_in, const CoreConsts k,
                   const DetParams det, int n_iters, long long V,
                   float* __restrict__ means_out,
                   float* __restrict__ prec_out, float* __restrict__ cov_out,
                   float* __restrict__ b_out, float* __restrict__ c_out,
                   float* __restrict__ f_out, float* __restrict__ tr_out,
                   float* __restrict__ fstate, int* __restrict__ istate,
                   int* __restrict__ count) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float m0[P], dtqr[P], pm[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    m0[a] = m0_in[(size_t)a * V + v];
    dtqr[a] = dtqr_in[(size_t)a * V + v];
    pm[a] = pm_in[(size_t)a * V + v];
  }
  Rotated<P> r;
  DetLoop l;
  const bool done = core_phase1<P, KIND>(
      m0, rtqr_in[v], dtqr, pm, k, det, n_iters, kPhase1Trips, V, v,
      means_out, prec_out, cov_out, b_out, c_out, f_out, tr_out, r, l);
  // the warp's unfinished lanes take consecutive slots: one atomicAdd by
  // the lowest of them for all
  const unsigned more = __ballot_sync(__activemask(), !done);
  if (!done) {
    const int lane = (int)(threadIdx.x & 31);
    const int leader = __ffs(more) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(count, __popc(more));
    base = __shfl_sync(more, base, leader);
    save_lane<P>(r, l, v, base + __popc(more & ((1u << lane) - 1u)), V,
                 fstate, istate);
  }
}

template <int P, int KIND>
__global__ void __launch_bounds__(kThreads)
core_phase2_kernel(const CoreConsts k, const DetParams det, int n_iters,
                   long long V, const float* __restrict__ fstate,
                   const int* __restrict__ istate,
                   const int* __restrict__ count,
                   float* __restrict__ means_out,
                   float* __restrict__ prec_out, float* __restrict__ cov_out,
                   float* __restrict__ b_out, float* __restrict__ c_out,
                   float* __restrict__ f_out, float* __restrict__ tr_out) {
  const long long n = *count;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    Rotated<P> r;
    DetLoop l;
    const long long v = load_lane<P>(fstate, istate, i, V, r, l);
    core_resume<P, KIND>(r, l, k, det, n_iters, V, v, means_out, prec_out,
                         cov_out, b_out, c_out, f_out, tr_out);
  }
}

// ---- the block-local form ------------------------------------------------

template <int P, int KIND>
__global__ void __launch_bounds__(kThreads)
core_block_kernel(const float* __restrict__ m0_in,
                  const float* __restrict__ rtqr_in,
                  const float* __restrict__ dtqr_in,
                  const float* __restrict__ pm_in, const CoreConsts k,
                  const DetParams det, int n_iters, long long V,
                  float* __restrict__ means_out,
                  float* __restrict__ prec_out, float* __restrict__ cov_out,
                  float* __restrict__ b_out, float* __restrict__ c_out,
                  float* __restrict__ f_out, float* __restrict__ tr_out) {
  __shared__ float fs[(4 * P + 5) * kThreads];
  __shared__ int is[5 * kThreads];
  __shared__ int n;
  if (threadIdx.x == 0) n = 0;
  __syncthreads();
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v < V) {
    float m0[P], dtqr[P], pm[P];
#pragma unroll
    for (int a = 0; a < P; ++a) {
      m0[a] = m0_in[(size_t)a * V + v];
      dtqr[a] = dtqr_in[(size_t)a * V + v];
      pm[a] = pm_in[(size_t)a * V + v];
    }
    Rotated<P> r;
    DetLoop l;
    if (!core_phase1<P, KIND>(m0, rtqr_in[v], dtqr, pm, k, det, n_iters,
                              kPhase1Trips, V, v, means_out, prec_out,
                              cov_out, b_out, c_out, f_out, tr_out, r, l))
      save_lane<P>(r, l, v, atomicAdd(&n, 1), kThreads, fs, is);
  }
  __syncthreads();
  if ((int)threadIdx.x < n) {
    Rotated<P> r;
    DetLoop l;
    const long long u = load_lane<P>(fs, is, threadIdx.x, kThreads, r, l);
    core_resume<P, KIND>(r, l, k, det, n_iters, V, u, means_out, prec_out,
                         cov_out, b_out, c_out, f_out, tr_out);
  }
}

// ---- launch and C entry points of the compactions ------------------------

// The two-phase form: the count zeroed, phase 1 over every lane, phase 2
// in as many blocks as the SMs hold at once, all on the stream.
template <int P>
int launch_two_phase(const CoreArgs& a, float* fstate, int* istate,
                     int* count, cudaStream_t stream) {
  constexpr int KIND = fabber::kTrialMode;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, core_phase2_kernel<P, KIND>, kThreads, 0);
  if (e == cudaSuccess) e = cudaMemsetAsync(count, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((a.V + kThreads - 1) / kThreads);
  core_phase1_kernel<P, KIND><<<grid, kThreads, 0, stream>>>(
      a.m0, a.rtqr, a.dtqr, a.pm, a.k, a.det, a.n_iters, a.V, a.outs[0],
      a.outs[1], a.outs[2], a.outs[3], a.outs[4], a.outs[5], a.outs[6],
      fstate, istate, count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  core_phase2_kernel<P, KIND><<<(unsigned)(sms * per_sm), kThreads, 0,
                                stream>>>(
      a.k, a.det, a.n_iters, a.V, fstate, istate, count, a.outs[0],
      a.outs[1], a.outs[2], a.outs[3], a.outs[4], a.outs[5], a.outs[6]);
  return (int)cudaGetLastError();
}

template <int P>
int launch_block(const CoreArgs& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.V + kThreads - 1) / kThreads);
  core_block_kernel<P, fabber::kTrialMode><<<grid, kThreads, 0, stream>>>(
      a.m0, a.rtqr, a.dtqr, a.pm, a.k, a.det, a.n_iters, a.V, a.outs[0],
      a.outs[1], a.outs[2], a.outs[3], a.outs[4], a.outs[5], a.outs[6]);
  return (int)cudaGetLastError();
}

// fabber_spectral_core's arguments as one launch's (CoreArgs), trialmode
// only; else false.
bool core_args(CoreArgs& a, int p, int n_iters, const float* m0,
               const float* rtqr, const float* dtqr, const float* pm,
               const float* consts_host, int det_kind, float det_tol,
               int det_max_its, int det_max_trials, int det_init_save,
               long long V, float* const* outs) {
  if (p < 1 || p > kMaxP || n_iters < 1 || V < 1 ||
      det_kind != fabber::kTrialMode)
    return false;
  a = {m0, rtqr, dtqr, pm, {},
       {det_kind, det_tol, det_max_its, det_max_trials, det_init_save},
       n_iters, V, {outs[0], outs[1], outs[2], outs[3], outs[4], outs[5],
                    outs[6]}};
  for (int i = 0; i < 4 * p * p + 2 * p + 6; ++i) a.k.v[i] = consts_host[i];
  return true;
}

}  // namespace

// fabber_spectral_core's arguments (trialmode only, V below 2^31), then
// device scratch: fstate [4P+5, V] floats, istate [5, V] ints and count
// [1] int.
extern "C" int fabber_core_two_phase(int p, int n_iters, const float* m0,
                                     const float* rtqr, const float* dtqr,
                                     const float* pm,
                                     const float* consts_host, int det_kind,
                                     float det_tol, int det_max_its,
                                     int det_max_trials, int det_init_save,
                                     long long V, float* means, float* prec,
                                     float* cov, float* b, float* c,
                                     float* f, float* tr, float* fstate,
                                     int* istate, int* count, void* stream) {
  float* const outs[7] = {means, prec, cov, b, c, f, tr};
  CoreArgs a;
  if (!core_args(a, p, n_iters, m0, rtqr, dtqr, pm, consts_host, det_kind,
                 det_tol, det_max_its, det_max_trials, det_init_save, V,
                 outs) ||
      V >= (1LL << 31) || !fstate || !istate || !count)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_two_phase<1>(a, fstate, istate, count, s);
    case 2: return launch_two_phase<2>(a, fstate, istate, count, s);
    case 3: return launch_two_phase<3>(a, fstate, istate, count, s);
    case 4: return launch_two_phase<4>(a, fstate, istate, count, s);
    case 5: return launch_two_phase<5>(a, fstate, istate, count, s);
    case 6: return launch_two_phase<6>(a, fstate, istate, count, s);
    case 7: return launch_two_phase<7>(a, fstate, istate, count, s);
    default: return launch_two_phase<8>(a, fstate, istate, count, s);
  }
}

// fabber_spectral_core's arguments, trialmode only: the block-local form.
extern "C" int fabber_core_block(int p, int n_iters, const float* m0,
                                 const float* rtqr, const float* dtqr,
                                 const float* pm, const float* consts_host,
                                 int det_kind, float det_tol,
                                 int det_max_its, int det_max_trials,
                                 int det_init_save, long long V,
                                 float* means, float* prec, float* cov,
                                 float* b, float* c, float* f, float* tr,
                                 void* stream) {
  float* const outs[7] = {means, prec, cov, b, c, f, tr};
  CoreArgs a;
  if (!core_args(a, p, n_iters, m0, rtqr, dtqr, pm, consts_host, det_kind,
                 det_tol, det_max_its, det_max_trials, det_init_save, V,
                 outs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_block<1>(a, s);
    case 2: return launch_block<2>(a, s);
    case 3: return launch_block<3>(a, s);
    case 4: return launch_block<4>(a, s);
    case 5: return launch_block<5>(a, s);
    case 6: return launch_block<6>(a, s);
    case 7: return launch_block<7>(a, s);
    default: return launch_block<8>(a, s);
  }
}
