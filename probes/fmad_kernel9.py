#!/usr/bin/env python3
"""Kernel 9 (csrc/fused_ar_loop.cu) with each grouping of its fused
multiply-adds, on one NVIDIA GPU.

Run from the repository root:

    python3 probes/fmad_kernel9.py [--parent DIR]

It builds kernel 9 alone (probes/variants.py), every build at once:
csrc/fused_ar_loop.cu as the port runs it, and probes/csrc/
fused_ar_loop.cu, the same kernel with every sum written as
madd<group> (fused where -DFABBER_AR_FMA sets the group's bit), each sum
started from its first product, MODE 1 at one echo under
__launch_bounds__(128, 6):

  shipped     csrc/, -fmad=false: the plain version's float32 arithmetic
  rewrite     probes/csrc/, -fmad=false, no group fused
  rewrite_lb1 the same without that register cap
  g2 g8       one group of explicit __fmaf_rn each: the right-hand side
              and means (2), MODE 1's dmsum (8)
  fma10       both
  fma15       and the precision and D'M_sy (the sums the design first
              took for ones that do not cancel)
  fma31       and the noise quadratics
  contracted  probes/csrc/ without -fmad=false: nvcc contracts what it
              can
  parent      with --parent DIR: DIR/fused_ar_loop.cu (an earlier
              commit's, its headers from csrc/) with -fmad=false

and reports for each build: ptxas's registers and spills of P=3, nq 1
and 2, MODE 0 and 1, and the blocks of 128 per SM they allow (65,536
registers an SM, allocated per warp in units of 256, at most 16 blocks);
the SASS instruction counts of those four entries (cuobjdump), whole and
in the iteration loop; chip_smoke.py phase 3f's checks (1,048,576 and
1,000,003 voxels, nq 1 and 2, maxits, pointzeroone, freduce) with each
check's worst ratio to its near_f64 bound; and kernel 9's time at
16,777,216 voxels (phase 5f's data) in maxits and pointzeroone at nq 1
and 2, the builds timed in two rounds of turns (in order, then reversed;
CUDA events, best of 3 after a warm-up each). The last line is one JSON
object of those figures.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
import variants  # noqa: E402

SOURCE = "fused_ar_loop.cu"
NAMES = ("fabber_fused_ar_loop", "fabber_ar_has_instance")
NOFMAD = ["-fmad=false"]
PATCHED = variants.PATCHED
# name -> (flags, source directory: None for csrc/)
BUILDS = {"shipped": (NOFMAD, None),
          "rewrite": (NOFMAD, PATCHED),
          "rewrite_lb1": (NOFMAD + ["-DFABBER_AR_MIN_BLOCKS=1"], PATCHED),
          "g2": (NOFMAD + ["-DFABBER_AR_FMA=2"], PATCHED),
          "g8": (NOFMAD + ["-DFABBER_AR_FMA=8"], PATCHED),
          "fma10": (NOFMAD + ["-DFABBER_AR_FMA=10"], PATCHED),
          "fma15": (NOFMAD + ["-DFABBER_AR_FMA=15"], PATCHED),
          "fma31": (NOFMAD + ["-DFABBER_AR_FMA=31"], PATCHED),
          "contracted": ([], PATCHED)}


def blocks_per_sm(regs, threads=128):
    """Blocks of `threads` an SM holds at regs registers a thread (the
    register file alone; 64 warps at most)."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = min(65536 // per_warp, 64)
    return warps // (threads // 32)


def entry(nq, mode):
    return f"ILi3ELi{nq}ELi{mode}E"


def main():
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    _cuda.load()
    jobs = {k: (SOURCE, f, d) for k, (f, d) in BUILDS.items()}
    if "--parent" in sys.argv:
        jobs["parent"] = (SOURCE, NOFMAD,
                          sys.argv[sys.argv.index("--parent") + 1])
    built = variants.build_all(jobs)
    out = {"card": card, "builds": {}}
    for name, (path, secs, log) in built.items():
        info = {"flags": jobs[name][1], "nvcc_s": secs, "entries": {}}
        for nq in (1, 2):
            for mode in (0, 1):
                regs = cs.ptxas_entry(log, "fused_ar_loop_kernel",
                                      entry(nq, mode))
                n = regs.split()[0]
                info["entries"][f"nq{nq}_mode{mode}"] = {
                    "ptxas": regs,
                    "blocks_per_sm": blocks_per_sm(int(n)) if n.isdigit()
                    else None,
                    "sass": variants.sass_counts(
                        path, "fused_ar_loop_kernel", [entry(nq, mode)])}
        out["builds"][name] = info
        print(name, json.dumps(info), flush=True)

    # phase 3f's checks, each check's worst ratio, per build
    ratios = []
    orig = cs.near_f64

    def recorded(name, *a, **kw):
        res = orig(name, *a, **kw)
        ratios.append((name.strip(), res[2]))
        return res
    cs.near_f64 = recorded
    for name, (path, _, _) in built.items():
        variants.swap(path, NAMES)
        ratios.clear()
        ok, worst = cs.check_ar_kernels("cuda")
        out["builds"][name]["phase3f_ok"] = ok
        out["builds"][name]["phase3f"] = dict(ratios)
        print(name, "phase 3f", ok, dict(ratios), flush=True)
        torch.cuda.empty_cache()
    cs.near_f64 = orig

    # timing at 16,777,216 voxels, maxits and pointzeroone
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 21)
    cases = {}
    for nq in (1, 2):
        plane, _ = cs.ar_plane(nq, 16_777_216, gen, "cuda",
                               sd_range=(1e-2, 1.0))
        args, nm = cs.ar_kernel_inputs(plane, nq, "cuda")
        del plane
        torch.cuda.empty_cache()
        det, cap = cs.ar_detector("pointzeroone", nq, nm)
        cases[f"maxits_q{nq}"] = (args, cs.ITERS, None)
        cases[f"pointzeroone_q{nq}"] = (args, cap, det)
    times = {name: {c: float("inf") for c in cases} for name in built}
    order = list(built)
    for rnd in (order, order[::-1]):
        for name in rnd:
            variants.swap(built[name][0], NAMES)
            for c, (args, n_it, det) in cases.items():
                times[name][c] = min(times[name][c], cs.best_ms(
                    lambda: fa.fused_ar_loop(*args, n_it, det)))
    variants.restore()
    for name in built:
        out["builds"][name]["ms"] = times[name]
        print(name, "ms", times[name], flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
