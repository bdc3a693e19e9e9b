#!/usr/bin/env python3
"""Kernels 6 and 8 (csrc/tile.cuh) at each staged block width and
streamed, on one NVIDIA GPU.

Run from the repository root:

    python3 probes/tile_vb.py

On chip_smoke.py's biexp planes (4,000,000 voxels, T=100; phase 5b's
seed for kernel 6, phase 5e's for kernel 8, the engines' own starts) it
times kernel 6 under maxits, trialmode and lm and kernel 8 fresh
(Levenberg and Marquardt) and resumed (Levenberg, on the engine's
compacted plane) with the tile at VB = 128, 64 and 32 lanes per block
and in the streamed form, in two rounds of turns (128, 64, 32,
streamed, then the reverse order; CUDA events, best of 3 after a
warm-up each), and reports each form's best and its blocks per SM. The
shared memory per warp is the same at every VB (32 lanes x T floats),
so every VB fits the same 16 warps per SM at T=100, and what VB changes
is how soon a finished warp's share is freed (ops/_cuda.py tile_plan
takes 32 from these figures). Then a sweep over T (100 to 870
samples, the plane kept at ~1.6 GB: V = 400,000,000 / T voxels, the
same biexp curves over 2 s, dt = 2 / T): kernel 6 under maxits and
kernel 8 fresh (Levenberg) at each VB the C side accepts at that T and
streamed, with the blocks per SM of each (where tile_plan stops
staging). The last line is one JSON
object of those figures.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

NV = 4_000_000
FORMS = (128, 64, 32, 0)
SWEEP_T = (100, 200, 300, 440, 600, 870)


def turns(run, forms=FORMS):
    """{vb: best ms} over two rounds of turns of run(vb)."""
    best = {vb: float("inf") for vb in forms}
    for order in (forms, forms[::-1]):
        for vb in order:
            best[vb] = min(best[vb], cs.best_ms(lambda: run(vb)))
    return best


def sweep_plane(nt, nv, gen):
    """biexp_plane's curves over 2 s at nt samples (dt = 2 / nt)."""
    import torch
    t = torch.arange(nt, dtype=torch.float32,
                     device="cuda")[:, None] * (2.0 / nt)
    amp = torch.rand((1, nv), generator=gen, device="cuda") + 0.5
    data = torch.randn((nt, nv), generator=gen, device="cuda")
    data.mul_(cs.BI_SD).add_(amp * torch.exp(-t)
                              + 0.5 * amp * torch.exp(-5.0 * t))
    return data


def main():
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    _cuda.load()
    out = {"card": card, "voxels": NV, "nt": cs.BI_NT, "cases": {}}

    def record(name, best, occ):
        out["cases"][name] = {"ms": {str(vb): ms for vb, ms in best.items()},
                              "blocks_per_sm": {str(vb): occ(vb)
                                                for vb in FORMS}}
        print(name, out["cases"][name], flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 7)
    plane, _, _ = cs.biexp_plane(NV, gen, "cuda")
    for kind, mode in (("maxits", 0), ("trialmode", 2), ("lm", 2)):
        extra = None if kind == "maxits" else {"convergence": kind}
        eng = cs.nl_engine("biexp", "1", plane, "cuda", extra)
        tr = eng._transforms()
        args = eng.nl_loop_args(eng.initial_state())
        det = None if kind == "maxits" else eng._nl_fdet_consts()
        n_it = int(eng.detector.max_iterations) if det else cs.ITERS
        best = turns(lambda vb: fl.fused_nl_loop(
            eng.model, tr, *args, n_it, True, detector=det, _vb=vb))
        record(f"fused_nl_loop {kind}", best,
               lambda vb, m=mode: _cuda.nl_occupancy(1, 4, 1, m, vb,
                                                     cs.BI_NT))
        del eng, args
        torch.cuda.empty_cache()
    del plane
    torch.cuda.empty_cache()

    gen.manual_seed(cs.SEED + 16)
    plane, _, _ = cs.biexp_plane(NV, gen, "cuda")
    for lm in (False, True):
        eng = cs.nlls_engine(plane, "cuda", {"lm": True} if lm else None)
        tr = [pm.transform for pm in eng.params]
        p0 = eng.initial_means()
        best = turns(lambda vb: fn.fused_nlls_loop(
            eng.model, tr, p0, plane, eng.tmask_host, eng.max_its, lm,
            _vb=vb))
        record(f"fused_nlls fresh {'Marquardt' if lm else 'Levenberg'}",
               best, lambda vb, m=lm: _cuda.nlls_occupancy(
                   1, 4, 0, m, vb, cs.BI_NT))
        if not lm:
            rin, _ = eng._phase1(p0)
            best = turns(lambda vb: fn.fused_nlls_loop(
                eng.model, tr, rin[0], rin[1], eng.tmask_host,
                eng.max_its - cs.NLLS_PHASE1, lm, state=rin[2], _vb=vb))
            record("fused_nlls resume Levenberg", best,
                   lambda vb: _cuda.nlls_occupancy(1, 4, 2, False, vb,
                                                   cs.BI_NT))
            out["resume_lanes"] = int(rin[0].shape[1])
            del rin
        del eng, p0
        torch.cuda.empty_cache()
    del plane
    torch.cuda.empty_cache()

    out["sweep"] = {}
    for nt in SWEEP_T:
        nv = 400_000_000 // nt
        gen.manual_seed(cs.SEED + 30 + nt)
        plane = sweep_plane(nt, nv, gen)
        forms = tuple(vb for vb in FORMS
                      if vb == 0 or 4 * (nt * vb + nt) <= 232_448)
        extra = {"dt": str(2.0 / nt)}
        eng = cs.nl_engine("biexp", "1", plane, "cuda", extra)
        tr = eng._transforms()
        args = eng.nl_loop_args(eng.initial_state())
        k6 = turns(lambda vb: fl.fused_nl_loop(eng.model, tr, *args,
                                               cs.ITERS, True, _vb=vb),
                   forms)
        del eng, args
        torch.cuda.empty_cache()
        eng = cs.nlls_engine(plane, "cuda", extra)
        tr = [pm.transform for pm in eng.params]
        p0 = eng.initial_means()
        k8 = turns(lambda vb: fn.fused_nlls_loop(
            eng.model, tr, p0, plane, eng.tmask_host, eng.max_its, False,
            _vb=vb), forms)
        row = {"voxels": nv, "plan": list(_cuda.tile_plan(nt, 1)),
               "fused_nl_loop_ms": {str(vb): ms for vb, ms in k6.items()},
               "fused_nlls_ms": {str(vb): ms for vb, ms in k8.items()},
               "nl_blocks_per_sm": {str(vb): _cuda.nl_occupancy(
                   1, 4, 1, 0, vb, nt) for vb in forms},
               "nlls_blocks_per_sm": {str(vb): _cuda.nlls_occupancy(
                   1, 4, 0, False, vb, nt) for vb in forms}}
        out["sweep"][str(nt)] = row
        print(f"T={nt}", row, flush=True)
        del eng, p0, plane
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
