// fused_nl_loop: the C entry points of the whole-loop nonlinear kernel
// (kernel 6, fused_nl_loop.cuh) for the hand-written model functors of
// FABBER_NL_INSTANCES (vb_device.cuh), for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_loop_nl.py
// make_fused_nl_loop (its pallas_call at line 890) in time_signal mode;
// the design, the modes and what bounds it are in fused_nl_loop.cuh.
// Functors generated from a model (its generic full-time mode) are built
// into libraries of their own (ops/_cuda.py build_generated) from the
// same header. Plain version: fabber_core_tpu_torch/ops/fused_loop_nl.py
// fused_nl_loop_plain.

#include "fused_nl_loop.cuh"

#if !defined(FABBER_INST_P)
// 1 when both nonlinear kernels are compiled for (kind, p, q), else 0.
extern "C" int fabber_nl_has_instance(int kind, int p, int q) {
#define FABBER_HAS(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP && q == NQ) return 1;
  FABBER_NL_INSTANCES(FABBER_HAS)
#undef FABBER_HAS
  return 0;
}

// (kind, p, q): one of FABBER_NL_INSTANCES (vb_device.cuh).
// tcodes_host [p], consts_host [4q] (1/b0, c_post, b_init, c_init per
// group) are host arrays copied into the by-value parameter block.
// det_kind: 0 maxits, 1..4 pointzeroone, freduce, trialmode, lm
// (detectors.cuh), with the detector's tolerance, max_its, max_trials,
// initial save flag and det_consts_host [q+2] (lb_coeff per group,
// f_const, f_const_init; unread under maxits). centre0, pm, pp [p,V];
// pd0 [p,V] the initial posterior variances (read under freduce only,
// may be null otherwise); data [nt,V]; qw [nt,q] (device). Outputs
// (device, preallocated): means [p,V], prec [p,p,V], cov [p,p,V], b, c
// [q,V]; fkqk, ftr [q,V] under maxits (the F quadratics, zero without
// need_f), else [1,V] (F, iteration count) or [2,V] under freduce (and
// the revert flag, zeros). vb: 0 streams the plane; > 0 stages it in
// blocks of vb lanes (a multiple of 32, at most 128, with 4 (nt vb + nt q)
// bytes of shared memory at most 232,448; ops/_cuda.py tile_plan); other
// values return cudaErrorInvalidValue.
extern "C" int fabber_fused_nl_loop(
    int kind, int p, int q, const int* tcodes_host, float dt, int n_iters,
    int need_f, float locked_sd, const float* consts_host, int det_kind,
    float det_tol, int det_max_its, int det_max_trials, int det_init_save,
    const float* det_consts_host, const float* centre0, const float* pm,
    const float* pp, const float* pd0, const float* data, const float* qw,
    int nt, long long V, float* means, float* prec, float* cov, float* b,
    float* c, float* fkqk, float* ftr, int vb, void* stream) {
  VBParams k;
  NLDetConsts dc;
  const long long smem = nl_smem(vb, nt, q);
  if (smem < 0 ||
      !nl_setup(p, q, tcodes_host, dt, n_iters, need_f, locked_sd,
                consts_host, det_kind, det_tol, det_max_its, det_max_trials,
                det_init_save, det_consts_host, pd0, nt, V, &k, &dc))
    return (int)cudaErrorInvalidValue;
  // the built-in functors read no suppdata
  const float* const ins[7] = {centre0, pm, pp, pd0, data, nullptr, qw};
  float* const outs[7] = {means, prec, cov, b, c, fkqk, ftr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABBER_LAUNCH(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP && q == NQ)  \
    return launch<MODEL, NQ>(k, dc, vb, smem, ins, outs, s);
  FABBER_NL_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM of the (kind, p, q) instance in MODE mode (0 maxits, 1
// pointzeroone/freduce, 2 trialmode/lm) and the form vb selects
// (fabber_fused_nl_loop's vb) at nt samples; -1 where the arguments are
// refused or the CUDA call fails.
extern "C" int fabber_nl_occupancy(int kind, int p, int q, int mode, int vb,
                                   int nt) {
  const long long smem = nl_smem(vb, nt, q);
  if (smem < 0 || mode < 0 || mode > 2) return -1;
#define FABBER_OCC(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP && q == NQ)  \
    return occupancy<MODEL, NQ>(mode, vb, smem);
  FABBER_NL_INSTANCES(FABBER_OCC)
#undef FABBER_OCC
  return -1;
}
#else
// A per-shape instance's entry points (ops/_cuda.py build_instance "nl":
// the functor InstModel at (P, Q) = (FABBER_INST_P, FABBER_INST_Q), any
// shape up to (kWideMaxP, kWideMaxQ)): fabber_fused_nl_loop's and
// fabber_nl_occupancy's arguments; another (kind, p, q) returns
// cudaErrorInvalidValue (-1 for the occupancy).
extern "C" int fabber_inst_fused_nl_loop(
    int kind, int p, int q, const int* tcodes_host, float dt, int n_iters,
    int need_f, float locked_sd, const float* consts_host, int det_kind,
    float det_tol, int det_max_its, int det_max_trials, int det_init_save,
    const float* det_consts_host, const float* centre0, const float* pm,
    const float* pp, const float* pd0, const float* data, const float* qw,
    int nt, long long V, float* means, float* prec, float* cov, float* b,
    float* c, float* fkqk, float* ftr, int vb, void* stream) {
  constexpr int P = FABBER_INST_P, Q = FABBER_INST_Q;
  static_assert(P == InstModel::P && P <= nl::kWideMaxP &&
                    Q <= nl::kWideMaxQ,
                "a kernel 6 instance within its limits");
  VBParamsFor<P, Q> k;
  NLDetConstsFor<Q> dc;
  const long long smem = nl_smem(vb, nt, q);
  if (kind != FABBER_INST_KIND || p != P || q != Q || smem < 0 ||
      !nl_setup(p, q, tcodes_host, dt, n_iters, need_f, locked_sd,
                consts_host, det_kind, det_tol, det_max_its, det_max_trials,
                det_init_save, det_consts_host, pd0, nt, V, &k, &dc))
    return (int)cudaErrorInvalidValue;
  const float* const ins[7] = {centre0, pm, pp, pd0, data, nullptr, qw};
  float* const outs[7] = {means, prec, cov, b, c, fkqk, ftr};
  return launch<InstModel, Q>(k, dc, vb, smem, ins, outs,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int fabber_inst_nl_occupancy(int kind, int p, int q, int mode,
                                        int vb, int nt) {
  const long long smem = nl_smem(vb, nt, q);
  if (kind != FABBER_INST_KIND || p != FABBER_INST_P || q != FABBER_INST_Q ||
      smem < 0 || mode < 0 || mode > 2)
    return -1;
  return occupancy<InstModel, FABBER_INST_Q>(mode, vb, smem);
}
#endif
