// fused_vb_iter: the C entry points of the per-iteration VB kernel
// (kernel 7, fused_vb_iter.cuh) for the hand-written model functors of
// FABBER_NL_INSTANCES (vb_device.cuh), for Hopper (sm_90a).
//
// Replaces the TPU kernel fabber_core_tpu/ops/fused_vb.py
// make_fused_iteration (its pallas_call at line 481); the design and what
// bounds it are in fused_vb_iter.cuh. Functors generated from a model's
// time_signal are built into libraries of their own (ops/_cuda.py
// build_generated) from the same header. Plain version:
// fabber_core_tpu_torch/ops/fused_vb.py fused_iteration_plain.

#include "fused_vb_iter.cuh"

#if !defined(FABBER_INST_P)
// (kind, p, q): one of FABBER_NL_INSTANCES (vb_device.cuh).
// tcodes_host [p] (host). centre, pm, pp [p,V]; phi [q,V]; data [nt,V];
// qw [nt,q]; alpha [V], the lm detector's damping, or null for the
// plain iteration (device). Outputs (device, preallocated): means [p,V],
// prec [p,p,V], cov [p,p,V], nkqk, ntr, fkqk, ftr [q,V] (the last two
// zero when need_f is 0). vb: 0 streams the plane; > 0 stages it in
// blocks of vb lanes (a multiple of 32, at most 128, with 4 (nt vb + nt q)
// bytes of shared memory at most 232,448; ops/_cuda.py tile_plan); other
// values return cudaErrorInvalidValue.
extern "C" int fabber_fused_vb_iter(
    int kind, int p, int q, const int* tcodes_host, float dt, int need_f,
    const float* centre, const float* pm, const float* pp, const float* phi,
    const float* data, const float* qw, const float* alpha, int nt,
    long long V, float* means,
    float* prec, float* cov, float* nkqk, float* ntr, float* fkqk,
    float* ftr, int vb, void* stream) {
  const long long smem = iter_smem(vb, nt, q);
  VBParams k;
  if (!iter_setup(p, q, tcodes_host, dt, need_f, nt, V, smem, &k))
    return (int)cudaErrorInvalidValue;
  const float* const ins[7] = {centre, pm, pp, phi, data, qw, alpha};
  float* const outs[7] = {means, prec, cov, nkqk, ntr, fkqk, ftr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FABBER_LAUNCH(KIND, NP, MODEL, NQ) \
  if (kind == KIND && p == NP && q == NQ)  \
    return launch<MODEL, NQ>(k, alpha != nullptr, vb, smem, ins, outs, s);
  FABBER_NL_INSTANCES(FABBER_LAUNCH)
#undef FABBER_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Blocks per SM of the (kind, p, q) instance, with (lm 1) or without its
// LM branch, in the form vb selects (fabber_fused_vb_iter's vb) at nt
// samples; -1 where the arguments are refused or the CUDA call fails.
extern "C" int fabber_vb_iter_occupancy(int kind, int p, int q, int lm,
                                        int vb, int nt) {
  const long long smem = iter_smem(vb, nt, q);
  if (smem < 0) return -1;
#define FABBER_OCC(KIND, NP, MODEL, NQ)  \
  if (kind == KIND && p == NP && q == NQ) \
    return occupancy<MODEL, NQ>(lm != 0, vb, smem);
  FABBER_NL_INSTANCES(FABBER_OCC)
#undef FABBER_OCC
  return -1;
}
#else
// A per-shape instance's entry points (ops/_cuda.py build_instance "nl":
// InstModel at (P, Q) = (FABBER_INST_P, FABBER_INST_Q) up to (kCoopMaxP,
// kWideMaxQ); the cooperative form in a unit past rolled_loops' sizes,
// which fabber_inst_vb_iter_coop reports and which must be given vb = 0):
// fabber_fused_vb_iter's and fabber_vb_iter_occupancy's arguments; another
// (kind, p, q) returns cudaErrorInvalidValue (-1).
extern "C" int fabber_inst_fused_vb_iter(
    int kind, int p, int q, const int* tcodes_host, float dt, int need_f,
    const float* centre, const float* pm, const float* pp, const float* phi,
    const float* data, const float* qw, const float* alpha, int nt,
    long long V, float* means, float* prec, float* cov, float* nkqk,
    float* ntr, float* fkqk, float* ftr, int vb, void* stream) {
  constexpr int P = FABBER_INST_P, Q = FABBER_INST_Q;
  static_assert(P == InstModel::P && P <= nl::kCoopMaxP &&
                    Q <= nl::kWideMaxQ,
                "a kernel 7 instance within its limits");
  const long long smem = iter_smem(vb, nt, q);
  VBParamsFor<P, Q> k;
  if (kind != FABBER_INST_KIND || p != P || q != Q ||
      !iter_setup(p, q, tcodes_host, dt, need_f, nt, V, smem, &k))
    return (int)cudaErrorInvalidValue;
  const float* const ins[7] = {centre, pm, pp, phi, data, qw, alpha};
  float* const outs[7] = {means, prec, cov, nkqk, ntr, fkqk, ftr};
  return launch<InstModel, Q>(k, alpha != nullptr, vb, smem, ins, outs,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int fabber_inst_vb_iter_occupancy(int kind, int p, int q, int lm,
                                             int vb, int nt) {
  const long long smem = iter_smem(vb, nt, q);
  if (kind != FABBER_INST_KIND || p != FABBER_INST_P || q != FABBER_INST_Q ||
      smem < 0)
    return -1;
  return occupancy<InstModel, FABBER_INST_Q>(lm != 0, vb, smem);
}

// 1 where this unit compiled the cooperative form (kIterCoop), else 0
extern "C" int fabber_inst_vb_iter_coop() { return kIterCoop ? 1 : 0; }
#endif
