// inverse_local.cuh: the reproducer of a miscompile by the CUDA 12.9
// toolkit (nvcc V12.9.86, sm_90a, NVIDIA H100 80GB HBM3): the form of
// csrc/vb_device.cuh inverse_from_chol before its repair, L^-1 in a local
// array of its own. probes/wide_nl.py --repair puts this text in place of
// the repaired function in a copy of csrc/ and builds kernel 6 at exp
// num-exps 5 (P = 10) with FABBER_ROLL_LOOPS: optimized (-O3), that unit
// gives non-finite means, precisions, covariances, noise and F in every
// lane under trialmode (maxits and pointzeroone stay right), where the
// unrolled unit, the same unit with -Xcicc -O1 or -G, or the repaired form
// are right. Its PTX (--bisect writes it to chiprun_out/bisect_k6.ptx)
// stores the diagonal of L^-1 (1 / L_ii) at the local-memory offsets of
// the caller's factor ch and then reads the factor back from them: the two
// arrays share one slot while both are live. The bisection needed four
// sites rolled at once (eval_latent's chain product, the row loop of
// L^-1, chol_solve's back substitution in the LM branch, which trialmode
// never runs, and add_sums), so the frame layout, not any one loop, is at
// fault; on the host at double the same C++ is right under ASan and UBSan.

// A^-1 = L^-T L^-1 from the packed factor, into packed cov. BY_RECIP:
// each division by L_jj a product with the 1 / L_jj already taken
// (fewer instructions, another rounding; kernel 5's step).
template <int P, bool BY_RECIP = false>
__device__ __forceinline__ void inverse_from_chol(const float* ch,
                                                  float* cov) {
  float invl[P * (P + 1) / 2];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) invl[tri(i, i)] = 1.f / ch[tri(i, i)];
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
FABBER_UNROLL
    for (int j = i - 1; j >= 0; --j) {
      float s = 0.f;
FABBER_UNROLL
      for (int k = j + 1; k <= i; ++k) s = s + ch[tri(k, j)] * invl[tri(i, k)];
      invl[tri(i, j)] = BY_RECIP ? -s * invl[tri(j, j)] : -s / ch[tri(j, j)];
    }
  }
FABBER_UNROLL
  for (int i = 0; i < P; ++i) {
FABBER_UNROLL
    for (int j = 0; j <= i; ++j) {
      float s = 0.f;
FABBER_UNROLL
      for (int k = i; k < P; ++k) s = s + invl[tri(k, i)] * invl[tri(k, j)];
      cov[tri(i, j)] = s;
    }
  }
}

