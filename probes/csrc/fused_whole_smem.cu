// fused_whole_smem.cu: kernel 4's per-shape instance (csrc/fused_whole.cu
// with FABBER_INST_P, FABBER_INST_Q) beside a form of it that keeps each
// lane's fixed-point states (st, the next state nx and MODE 2's best
// copy: 3 (P + P(P+1) + 2Q + 1) floats) in the block's shared memory
// instead of registers and local memory, for probes/wide_state.py. A
// lane's states lie [lane][element] at an odd stride, so the lanes of a
// warp reading one element hit 32 banks. Staged only (the tile, the rows,
// then the slots; a block of 32 lanes at P = 16, Q = 1 takes 139 KB, one
// block per SM), as its C entry point fabber_probe_whole_smem
// (fabber_inst_fused_whole's arguments; a vb other than 32 or 64 is
// refused).
#include "fused_whole.cu"

namespace {

template <int P, int Q>
constexpr int kStateFloats = (int)(sizeof(WholeState<P, Q>) / sizeof(float));

// a lane's slot: three states at an odd stride
template <int P, int Q>
constexpr int kSlotFloats = (3 * kStateFloats<P, Q>) | 1;

template <int P, int Q, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_whole_smem_kernel(const WideConsts k, const float* __restrict__ data,
                        const float* __restrict__ tconsts,
                        const float* __restrict__ pm_in,
                        const float* __restrict__ pp_in,
                        float* __restrict__ means_out,
                        float* __restrict__ prec_out,
                        float* __restrict__ cov_out,
                        float* __restrict__ b_out, float* __restrict__ c_out,
                        float* __restrict__ fkqk_out,
                        float* __restrict__ ftr_out) {
  constexpr bool STAGED = true;
  float* const slot = dynamic_smem() + k.nt * blockDim.x +
                      (P + Q * P + Q) * k.nt +
                      threadIdx.x * kSlotFloats<P, Q>;
#include "fused_whole_smem_body.inc"
}

template <int P, int Q, int MODE>
int launch_smem(const WideConsts& k, int vb, const float* const* ins,
                float* const* outs, cudaStream_t stream) {
  const auto kernel = fused_whole_smem_kernel<P, Q, MODE>;
  const long long smem = whole_smem(vb, k.nt, (P + Q * P + Q) * k.nt) +
                         4LL * vb * kSlotFloats<P, Q>;
  if (vb != 32 && vb != 64) return (int)cudaErrorInvalidValue;
  if (smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((k.V + vb - 1) / vb);
  kernel<<<grid, vb, smem, stream>>>(k, ins[0], ins[1], ins[2], ins[3],
                                     outs[0], outs[1], outs[2], outs[3],
                                     outs[4], outs[5], outs[6]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fabber_probe_whole_smem(
    int p, int q, int n_iters, float locked_sd, const float* consts_host,
    int det_kind, float det_tol, int det_max_its, int det_max_trials,
    int det_init_save, const float* det_consts_host, const float* data,
    const float* tconsts, int nt, const float* pm, const float* pp,
    long long V, float* means, float* prec, float* cov, float* b, float* c,
    float* fkqk, float* ftr, int vb, const float* dtqd, void* stream) {
  constexpr int P = FABBER_INST_P, Q = FABBER_INST_Q;
  if (p != P || q != Q || n_iters < 1 || nt < 1 || V < 1 ||
      det_kind < kMaxits || det_kind > kLM || det_kind == kFreduce)
    return (int)cudaErrorInvalidValue;
  WideConsts k = make_wide_consts(Q, n_iters, locked_sd, consts_host, dtqd,
                                  Q * P * P, nt, V);
  k.d = {det_kind, det_tol, det_max_its, det_max_trials, det_init_save};
  if (det_kind != kMaxits) {
    for (int i = 0; i < Q; ++i) k.lb_coeff[i] = det_consts_host[i];
    k.f_const = det_consts_host[Q];
  }
  const float* const ins[4] = {data, tconsts, pm, pp};
  float* const outs[7] = {means, prec, cov, b, c, fkqk, ftr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (det_kind) {
    case kMaxits: return launch_smem<P, Q, 0>(k, vb, ins, outs, s);
    case kPointZeroOne: return launch_smem<P, Q, 1>(k, vb, ins, outs, s);
    default: return launch_smem<P, Q, 2>(k, vb, ins, outs, s);
  }
}
