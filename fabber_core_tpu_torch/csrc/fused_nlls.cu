// fused_nlls: the C entry points of the NLLS kernel (kernel 8,
// fused_nlls.cuh) for the hand-written model functors of
// FABBER_NL_INSTANCES (vb_device.cuh), for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_nlls.py
// make_fused_nlls_loop (its pallas_call at line 426); the design, the
// modes and what bounds it are in fused_nlls.cuh. Built with -fmad=false
// (ops/_cuda.py SOURCE_FLAGS), as is every library built from the header
// with a functor generated from a model's time_signal (ops/_cuda.py
// build_generated). Plain version: fabber_core_tpu_torch/ops/fused_nlls.py
// fused_nlls_loop_plain.

#include "fused_nlls.cuh"

#if !defined(FABBER_INST_P)
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
// [4,V] (cost, its, prec, cov may be null). vb: 0 streams the plane;
// > 0 stages it in blocks of vb lanes (a multiple of 32, at most 128,
// with 4 (nt vb + nt) bytes of shared memory at most 232,448;
// ops/_cuda.py tile_plan); other values return cudaErrorInvalidValue.
extern "C" int fabber_fused_nlls(
    int kind, int p, const int* tcodes_host, float dt,
    const float* consts_host, int mode, int marquardt, int max_its,
    float dof, const float* params0, const float* data, const float* w,
    const float* state_in, int nt, long long V, float* params_out,
    float* cost_out, float* its_out, float* prec_out, float* cov_out,
    float* state_out, int vb, void* stream) {
  const long long smem = nlls_smem(vb, nt);
  float* const outs[6] = {params_out, cost_out, its_out, prec_out, cov_out,
                          state_out};
  NLLSParams k;
  if (!nlls_setup(p, tcodes_host, dt, consts_host, mode, max_its, dof,
                  state_in, nt, V, smem, outs, &k))
    return (int)cudaErrorInvalidValue;
  const float* const ins[4] = {params0, data, w, state_in};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABBER_LAUNCH(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP)          \
    return launch<MODEL>(k, mode, marquardt, vb, smem, ins, outs, s, nullptr);
  FABBER_NL_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM of the (kind, p, mode, marquardt) instance in the form
// vb selects (fabber_fused_nlls's vb) at nt samples; -1 where the
// arguments are refused or the CUDA call fails.
extern "C" int fabber_nlls_occupancy(int kind, int p, int mode, int marquardt,
                                     int vb, int nt) {
  const long long smem = nlls_smem(vb, nt);
  if (smem < 0 || mode < kFresh || mode > kResume) return -1;
#define FABBER_OCC(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP)          \
    return occupancy<MODEL>(mode, marquardt, vb, smem);
  FABBER_NL_INSTANCES(FABBER_OCC)
#undef FABBER_OCC
  return -1;
}
#else
// A per-shape instance's entry points (ops/_cuda.py build_instance "nl":
// InstModel at P = FABBER_INST_P, built with each (P, Q) of the family;
// the NLLS kernel has no Q): fabber_fused_nlls's and
// fabber_nlls_occupancy's arguments; another (kind, p) returns
// cudaErrorInvalidValue (-1).
extern "C" int fabber_inst_fused_nlls(
    int kind, int p, const int* tcodes_host, float dt,
    const float* consts_host, int mode, int marquardt, int max_its,
    float dof, const float* params0, const float* data, const float* w,
    const float* state_in, int nt, long long V, float* params_out,
    float* cost_out, float* its_out, float* prec_out, float* cov_out,
    float* state_out, int vb, void* stream) {
  constexpr int P = FABBER_INST_P;
  static_assert(P == InstModel::P && P <= nl::kWideMaxP,
                "a kernel 8 instance within its limits");
  const long long smem = nlls_smem(vb, nt);
  float* const outs[6] = {params_out, cost_out, its_out, prec_out, cov_out,
                          state_out};
  NLLSParamsFor<P> k;
  if (kind != FABBER_INST_KIND || p != P ||
      !nlls_setup(p, tcodes_host, dt, consts_host, mode, max_its, dof,
                  state_in, nt, V, smem, outs, &k))
    return (int)cudaErrorInvalidValue;
  const float* const ins[4] = {params0, data, w, state_in};
  return launch<InstModel>(k, mode, marquardt, vb, smem, ins, outs,
                           static_cast<cudaStream_t>(stream), nullptr);
}

extern "C" int fabber_inst_nlls_occupancy(int kind, int p, int mode,
                                          int marquardt, int vb, int nt) {
  const long long smem = nlls_smem(vb, nt);
  if (kind != FABBER_INST_KIND || p != FABBER_INST_P || smem < 0 ||
      mode < kFresh || mode > kResume)
    return -1;
  return occupancy<InstModel>(mode, marquardt, vb, smem);
}
#endif
