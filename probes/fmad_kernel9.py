#!/usr/bin/env python3
"""Kernel 9 (csrc/fused_ar_loop.cu) with and without nvcc's multiply-add
contraction, on one NVIDIA GPU.

Run from the repository root:

    python3 probes/fmad_kernel9.py

It builds the kernel library twice from csrc/ (fused_ar_loop.cu with
the default flags and with -fmad=false), then for each build, in turns
(default, no-FMA, no-FMA, default): chip_smoke.py phase 3f's checks on
its first seed's data (1,048,576 and 1,000,003 voxels, nq 1 and 2,
maxits, pointzeroone, freduce), each check's worst ratio to its bound
(near_f64), and kernel 9's time in maxits at 16,777,216 voxels, nq 1 and
2 (CUDA events, best of 3 after a warm-up). The last line is one JSON
object of those figures.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from fmad_kernel6 import use_build  # noqa: E402

SOURCE = "fused_ar_loop.cu"


def main():
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    libs = {nofma: use_build(nofma, SOURCE) for nofma in (False, True)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 21)
    timing = {}
    for nq in (1, 2):
        plane, _ = cs.ar_plane(nq, 16_777_216, gen, "cuda",
                               sd_range=(1e-2, 1.0))
        timing[nq], _ = cs.ar_kernel_inputs(plane, nq, "cuda")
        del plane
        torch.cuda.empty_cache()
    runs = []
    for nofma in (False, True, True, False):
        use_build(nofma, SOURCE)
        ok, worst = cs.check_ar_kernels("cuda")
        run = {"fmad": not nofma, "ok": ok, "worst": worst}
        for nq, args in timing.items():
            run[f"ms_q{nq}"] = cs.best_ms(
                lambda: fa.fused_ar_loop(*args, cs.ITERS))
        runs.append(run)
        print(run, flush=True)
    print(json.dumps({"card": card, "libraries": {str(k): v for k, v in
                                                  libs.items()},
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
