#!/usr/bin/env python3
"""Kernel 6 (csrc/fused_nl_loop.cu) under --convergence=lm with and
without nvcc's multiply-add contraction, on one NVIDIA GPU.

Run from the repository root:

    python3 probes/fmad_kernel6.py

It builds the kernel library twice from csrc/ (the default flags, and
with -fmad=false for fused_nl_loop.cu alone), then on chip_smoke.py phase
5c's biexp plane (4,000,000 voxels, T=100, the same seed) runs the
whole-loop kernel under lm in turns (default, no-FMA, no-FMA, default;
CUDA events, best of 3 after a warm-up) and reports, for each build,
the time and the share of lanes whose means are not finite, beside the
plain version's share at float32 (all lanes) and float64 (the first
1,048,576 lanes). The last line is one JSON object of those figures.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

NV = 4_000_000


def use_build(nofma, source="fused_nl_loop.cu"):
    """Load the kernel library built with (nofma) or without
    -fmad=false for one source."""
    from fabber_core_tpu_torch.ops import _cuda
    flags = {k: v for k, v in _cuda.SOURCE_FLAGS.items() if k != source}
    if nofma:
        flags[source] = ["-fmad=false"]
    _cuda.SOURCE_FLAGS = flags
    _cuda._lib = None
    _cuda.load()
    return str(_cuda.library_path().name)


def main():
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    libs = {False: use_build(False), True: use_build(True)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 7)
    plane, _, _ = cs.biexp_plane(NV, gen, "cuda")
    eng = cs.nl_engine("biexp", "1", plane, "cuda", {"convergence": "lm"})
    tr = eng._transforms()
    args = eng.nl_loop_args(eng.initial_state())
    det = eng._nl_fdet_consts()
    n_it = int(eng.detector.max_iterations)

    def nonfinite(o):
        return float((~torch.isfinite(o[0]).all(dim=0)).double().mean())

    ts = eng.model.time_signal_jac
    out = {"card": card, "voxels": NV, "libraries": libs,
           "plain_f32_nonfinite": nonfinite(fl.fused_nl_loop_plain(
               ts, tr, *args, n_it, True, detector=det))}
    sl = slice(0, cs.F64_LANES)
    out["plain_f64_nonfinite_first_1048576"] = nonfinite(
        fl.fused_nl_loop_plain(ts, tr, *(a[..., sl].double()
                                         for a in args[:4]), *args[4:],
                               n_it, True, detector=det))
    torch.cuda.empty_cache()
    runs = []
    for nofma in (False, True, True, False):
        use_build(nofma)
        ms, k = cs.best_ms(lambda: fl.fused_nl_loop(
            eng.model, tr, *args, n_it, True, detector=det), keep=True)
        runs.append({"fmad": not nofma, "ms": ms,
                     "nonfinite": nonfinite(k)})
        print(runs[-1], flush=True)
        del k
        torch.cuda.empty_cache()
    out["runs"] = runs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
