#!/usr/bin/env python3
"""Kernel 8 (csrc/fused_nlls.cu) with and without its explicit fused
multiply-adds, on one NVIDIA GPU.

Run from the repository root:

    python3 probes/fmad_kernel8.py

fused_nlls.cu builds with -fmad=false, so nvcc contracts no multiply-add
of its own; its J'J, J'r and r'r accumulations are explicit __fmaf_rn
(madd). The probe builds the kernel library twice from csrc/: as it
is, and with -DFABBER_NLLS_NO_FMA for fused_nlls.cu (madd as a multiply
and an add). On chip_smoke.py phase 5e's biexp plane (4,000,000 voxels,
T=100, the same seed, the engine's start, budget 100) it runs the fresh
launch in the plan's (staged) form under Levenberg and Marquardt damping
in turns (FMA, no FMA, no FMA, FMA; CUDA events, best of 3 after a
warm-up) and reports each build's time, the mean step count and the
share of lanes whose step count differs between the builds. The last
line is one JSON object of those figures.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

NV = 4_000_000
SOURCE = "fused_nlls.cu"


def use_build(fma):
    """Load the kernel library built with (fma) or without the explicit
    multiply-adds of fused_nlls.cu."""
    from fabber_core_tpu_torch.ops import _cuda
    flags = dict(_cuda.SOURCE_FLAGS)
    flags[SOURCE] = ["-fmad=false"] + ([] if fma
                                       else ["-DFABBER_NLLS_NO_FMA"])
    _cuda.SOURCE_FLAGS = flags
    _cuda._lib = None
    _cuda.load()
    return str(_cuda.library_path().name)


def main():
    import torch
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    libs = {True: use_build(True), False: use_build(False)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 16)
    plane, _, _ = cs.biexp_plane(NV, gen, "cuda")
    out = {"card": card, "voxels": NV, "libraries": libs, "runs": []}
    for lm in (False, True):
        eng = cs.nlls_engine(plane, "cuda", {"lm": True} if lm else None)
        tr = [pm.transform for pm in eng.params]
        p0 = eng.initial_means()
        its = {}
        for fma in (True, False, False, True):
            use_build(fma)
            ms, k = cs.best_ms(lambda: fn.fused_nlls_loop(
                eng.model, tr, p0, plane, eng.tmask_host, eng.max_its, lm),
                keep=True)
            its[fma] = k[2]
            run = {"marquardt": lm, "fma": fma, "ms": ms,
                   "mean_its": float(k[2].double().mean())}
            out["runs"].append(run)
            print(run, flush=True)
            del k
            torch.cuda.empty_cache()
        out[f"its_differ_share_{'lm' if lm else 'l'}"] = float(
            (its[True] != its[False]).double().mean())
        del eng, p0, its
        torch.cuda.empty_cache()
    use_build(True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
