// detectors.cuh: the convergence detectors as per-thread lane state
// machines, for the CUDA kernels that run them in-kernel
// (spectral_core.cu, fused_nl_loop.cu), for Hopper (sm_90a).
//
// A transcription of fabber_core_tpu_torch/inference/convergence.py (the
// port of fabber_core_tpu/inference/convergence.py), which is its plain
// version: one thread owns one voxel, so the [V] lanes of the batched
// state machines are scalars here, with real bools and ints. The TPU
// kernels' float32 0/1-mask form (fused_whole.py _mask_detector_step)
// existed because Mosaic cannot carry i1 vectors; it is not ported. Every
// select is a select: no arithmetic blend touches prev_f, whose sentinel
// (-FLT_MAX, the float32 clamp of the reference's -99e99) would cancel
// catastrophically in one.

#pragma once

#include <float.h>
#include <math.h>

namespace fabber {

// detector codes (ops/_cuda.py DETECTOR_CODES)
enum DetectorKind : int {
  kMaxits = 0, kPointZeroOne = 1, kFreduce = 2, kTrialMode = 3, kLM = 4
};

constexpr float kAlphaStart = 1e-6f;   // LMDetector.ALPHA_START
constexpr float kAlphaMax = 1e6f;      // LMDetector.ALPHA_MAX

// The detector's options, by value.
struct DetParams {
  int kind;
  float tol;        // min-fchange, or max-fchange for lm
  int max_its;      // the detector's max_its (trialmode: max-iterations+1)
  int max_trials;   // trialmode
  int init_save;    // ConvergenceDetector.init_state's save flag
};

// ConvState of one lane.
struct DetState {
  int its;
  float prev_f;
  bool save, revert, done;
  int trials;
  bool trialmode, lm_on;
  float alpha;
};

__device__ __forceinline__ DetState det_init(const DetParams& d) {
  DetState s;
  s.its = 0;
  s.prev_f = -FLT_MAX;
  s.save = d.init_save != 0;
  s.revert = false;
  s.done = false;
  s.trials = 0;
  s.trialmode = false;
  s.lm_on = false;
  s.alpha = 0.f;
  return s;
}

// ConvergenceDetector.test for one lane at free energy f.
__device__ __forceinline__ void det_test(const DetParams& d, DetState& s,
                                         float f) {
  const float diff = f - s.prev_f;
  switch (d.kind) {
    case kPointZeroOne: {
      const bool fsmall = fabsf(diff) < d.tol;
      if (!fsmall) s.its += 1;
      s.prev_f = f;
      s.done = fsmall || s.its >= d.max_its;
      break;
    }
    case kFreduce: {
      const bool reduced = diff < 0.f;
      const bool fsmall = fabsf(diff) < d.tol;
      if (!(reduced || fsmall)) s.its += 1;
      if (!reduced) s.prev_f = f;
      s.revert = reduced || s.revert;
      s.done = reduced || fsmall || s.its >= d.max_its;
      break;
    }
    case kTrialMode: {
      const bool reduced = diff < 0.f;
      const bool fsmall = fabsf(diff) < d.tol;
      const bool improved = diff > 0.f;
      if (!s.trialmode) {
        // reduced -> enter trial mode, revert later, keep best F;
        // fsmall -> converged; otherwise save as best, continue
        const int its = reduced ? 1 : (fsmall ? s.its : s.its + 1);
        if (reduced) s.trials = 1;
        s.save = !reduced && !fsmall;
        s.revert = reduced;
        if (!(reduced || fsmall)) s.prev_f = f;
        s.done = !reduced && (fsmall || its >= d.max_its);
        s.its = its;
        s.trialmode = reduced;
      } else {
        // improved & fsmall -> converged; improved & !fsmall -> leave
        // trial mode, save best; !improved & trials >= max -> stop and
        // revert to best; otherwise stay in trial mode
        const int trials = s.trials + 1;
        const bool leave = improved && !fsmall;
        const bool exhausted = !improved && trials >= d.max_trials;
        s.trials = leave ? 0 : trials;
        s.save = leave;
        s.revert = exhausted;
        if (leave) s.prev_f = f;
        s.done = (improved && fsmall) || exhausted;
        s.trialmode = !leave;
      }
      break;
    }
    case kLM: {
      if (!s.lm_on) {
        const bool dropped = diff < 0.f;
        const bool converged = !dropped && fabsf(diff) < d.tol;
        const bool maxed = !dropped && !converged && s.its >= d.max_its;
        const bool cont = !dropped && !converged && !maxed;
        s.lm_on = dropped;
        if (dropped) s.alpha = kAlphaStart;
        s.revert = dropped;
        if (cont) {
          s.prev_f = f;
          s.its += 1;
        }
        s.done = converged || maxed;
      } else {
        const bool improved = diff > 0.f;
        const bool at_start = s.alpha == kAlphaStart;
        const bool alpha_maxed = !improved && s.alpha >= kAlphaMax;
        const bool its_maxed = !improved && !alpha_maxed && s.its >= d.max_its;
        const bool grow = !improved && !alpha_maxed && !its_maxed;
        if (improved) {
          s.lm_on = !at_start;
          if (!at_start) s.alpha = s.alpha / 10.f;
          s.prev_f = f;
          s.its += 1;
        } else if (grow) {
          s.alpha = s.alpha * 10.f;
        }
        s.revert = !improved && (alpha_maxed || !its_maxed);
        s.done = alpha_maxed || its_maxed;
      }
      break;
    }
    default: {   // maxits
      s.its += 1;
      s.done = s.its >= d.max_its;
    }
  }
}

// det_test for a detector fixed at compile time (kernels 2 and 3: one
// instance per detector): the switch folds to KIND's case, so the lane
// keeps only that detector's state and branch; det_test itself, which
// kernels 4, 6 and 9 call with a runtime kind, is unchanged.
template <int KIND>
__device__ __forceinline__ void det_test_kind(const DetParams& d,
                                              DetState& s, float f) {
  DetParams dk = d;
  dk.kind = KIND;
  det_test(dk, s, f);
}

}  // namespace fabber
