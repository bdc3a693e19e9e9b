#!/usr/bin/env python3
"""Kernel 6's full-time form on one NVIDIA GPU, alone: chip_smoke.py's
phases 3l, 4ab and 5l without the rest of the script, and what factoring
the cooperative pieces out of kernel 7 (csrc/coop_device.cuh) and
including the new headers into kernel 6's did to the hand-written
kernels' SASS.

Run from the repository root:

    python3 probes/fulltime.py [--phases 3l,3m,4ab,4ac,5l,5m] [--nv N]
                               [--parent DIR] [--coop DIR]

It builds the full-time functors chip_smoke.py builds (the three models
of tests/torch_fulltime_models.py at T=100, Q 1 and 2; ops/_cuda.py
build_generated "nl_loop_full") and those of
tests/torch_generic_ops_models.py (pairs-test and mixed-test for kernel
6, stacked-test's time_signal for kernels 7 and 8), all their nvcc
processes started together, prints each build's seconds, ptxas lines and
block bytes, and runs the phases asked for (3l, 4ab, 5l: chip_smoke's
phases of the three models; 3m, 4ac, 5m: its checks, paths and timings of
the generic-ops models, check_generic_ops_kernels, run_generic_ops_paths,
time_generic_ops; phases 3l and 3m at --nv voxels, default chip_smoke's
65,536). With --parent DIR (a directory holding an earlier csrc/'s files,
`git show <rev>:fabber_core_tpu_torch/csrc/<file>`, or a checkout's
csrc/), it first compiles, with the current sources and with DIR's, the
hand-written per-lane units: kernel 6's and kernel 7's prebuilt sources
(fused_nl_loop.cu, fused_vb_iter.cu), their per-shape per-lane units
(ExpSum<5>, P = 10, at Q = 1, unrolled; kernel 6 rolled at ExpSum<9>, P
= 18) and kernel 6 with myexp's generated per-sample functor, and
compares the SASS of every entry both builds hold (probes/variants.py
sass_text), each side's files built from one directory in turn
(build_side): none may move. The cooperative units (kernel 7's
cooperative form, kernel 6's full-time form) are left out: their code is
the warp-level redesign's, not DIR's (probes/coop_sections.py times them
against DIR's). With --coop DIR (a checkout of an earlier tree,
build/parent), kernel 6's full-time form (row 6t) on the convolution,
the centred biexponential, the shift and pairs-test is timed against
DIR's in turns and profiled by section (probes/coop_sections.py
compare). Every figure is printed with the
card's name and power limit; the last line is one JSON object of them
(also written to chiprun_out/fulltime.json).
"""

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import variants  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GENERATED = ROOT / "build" / "fulltime_probe"
SAME_PATH = ROOT / "build" / "sass_unit"


def unit_jobs(parent):
    """{name: (source, flags)} of variants.build jobs: the prebuilt
    sources, per-shape units by -D flags, and generated units, whose text
    goes beside the current sources (build/fulltime_probe) and into DIR
    alike."""
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.models.kernelgen import \
        derive_time_signal_functor
    from fabber_core_tpu_torch.options import RunOptions
    jobs = {src: (src, []) for src in ("fused_nl_loop.cu", "fused_vb_iter.cu")}

    def inst(p, q):
        return [f"-DFABBER_INST_P={p}", f"-DFABBER_INST_Q={q}",
                "-DFABBER_INST_KIND=1"] + (
            ["-DFABBER_ROLL_LOOPS"] if _cuda.rolled_loops(p, q) else [])
    for name, src, p, q in (("vb_iter per-lane P10 Q1", "fused_vb_iter.cu",
                             10, 1),
                            ("nl_loop per-lane P10 Q1", "fused_nl_loop.cu",
                             10, 1),
                            ("nl_loop rolled P18 Q1", "fused_nl_loop.cu", 18,
                             1)):
        jobs[name] = (src, inst(p, q))
    here = GENERATED
    here.mkdir(parents=True, exist_ok=True)

    def unit(name, fname, cu):
        (here / fname).write_text(cu)
        (Path(parent) / fname).write_text(cu)
        jobs[name] = (fname, [])
    # kernel 6 with a generated per-sample functor
    from fabber_core_tpu_torch.models import load_models_from_file
    load_models_from_file(cs.PLUGIN)
    model = get_model_class("myexp")(RunOptions({"model": "myexp",
                                                 "dt": "0.05",
                                                 "num-exps": "2"}))
    tle = derive_time_signal_functor(model, 4)
    unit("nl_loop generated myexp", "gen_myexp.cu",
         _cuda.generated_source(tle.source, 4, 1, "nl_loop"))
    return jobs


def build_side(jobs, dirs):
    """{name: SASS} of jobs built from one directory, build/sass_unit,
    emptied and filled with the files of dirs first: each side's units
    are built at the same paths, since nvcc's anonymous-namespace tags
    hash a source's path and the compiler may order a unit's code by
    them."""
    import shutil
    shutil.rmtree(SAME_PATH, ignore_errors=True)
    SAME_PATH.mkdir(parents=True)
    for d in dirs:
        for f in Path(d).iterdir():
            if f.is_file():
                shutil.copy(f, SAME_PATH / f.name)
    built = variants.build_all({name: (src, flags, SAME_PATH)
                                for name, (src, flags) in jobs.items()})
    return {name: variants.sass_text(built[name][0]) for name in jobs}


def sass_compare(parent):
    """{unit: (entries compared, [entries whose SASS differs])}: DIR's
    side built, then the current one, at the same paths (build_side).
    Where a unit differs, the current side is built once more, and the
    entries in which it differs from its own first build are logged (the
    build varies there); they count as moved all the same. The first
    differing entry's instructions, parent against current, go to
    chiprun_out/sass_<unit>.txt."""
    import difflib
    from fabber_core_tpu_torch.ops import _cuda
    jobs = unit_jobs(parent)
    t0 = time.perf_counter()
    par = build_side(jobs, [parent])
    cur = build_side(jobs, [_cuda.CSRC, GENERATED])
    cs.log(f" SASS builds: {len(jobs)} units a side in "
           f"{time.perf_counter() - t0:.1f} s")
    out, again = {}, {}
    for name in jobs:
        a, b = cur[name], par[name]
        if a is None or b is None:
            out[name] = None
            continue
        both = sorted(set(a) & set(b))
        out[name] = (len(both), [n for n in both if a[n] != b[n]])
    moved = [name for name, r in out.items() if r and r[1]]
    if moved:
        again = build_side({name: jobs[name] for name in moved},
                           [_cuda.CSRC, GENERATED])
    for name, r in out.items():
        if r is None:
            cs.log(f" SASS {name}: no cuobjdump")
            continue
        diff = r[1]
        note = ""
        if diff:
            a, b = cur[name], par[name]
            varies = [n for n in diff if again[name].get(n) != a[n]]
            note = (f"; the current side built again differs from its "
                    f"first build in {len(varies)} of them")
            dump = ROOT / "chiprun_out" / f"sass_{name.replace(' ', '_')}.txt"
            dump.parent.mkdir(exist_ok=True)
            dump.write_text("\n".join(
                [f"== {diff[0]}: parent -> current"] + list(
                    difflib.unified_diff(b[diff[0]], a[diff[0]], "parent",
                                         "current", lineterm=""))))
        cs.log(f" SASS {name}: {r[0]} entries compared, {len(diff)} "
               f"differ {diff[:4]}{note}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="3l,4ab,5l")
    ap.add_argument("--nv", type=int, default=65_536)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--coop", default=None)
    a = ap.parse_args()
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(card)
    fig = {"card": card}
    ok = True
    if a.parent:
        res = sass_compare(a.parent)
        fig["sass"] = res
        ok &= all(r is not None and not r[1] for r in res.values())
    t0 = time.perf_counter()
    functors = cs.fulltime_functors() + cs.generic_ops_functors()
    with ThreadPoolExecutor(len(functors)) as pool:
        futs = [pool.submit(_cuda.build_generated, tle.source, p, q, kernel)
                for _, tle, p, q, kernel in functors]
        for f in futs:
            f.result()
    fig["build_s"] = time.perf_counter() - t0
    cs.log(f" {len(functors)} full-time functors built in "
           f"{fig['build_s']:.1f} s")
    for name, tle, p, q, kernel in functors:
        secs, text = _cuda.gen_build_log[_cuda.generated_key(
            tle.source, p, q, kernel)]
        lib = _cuda.build_generated(tle.source, p, q, kernel)
        block = ""
        if kernel == "nl_loop_full":
            occ = [_cuda.gen_full_occupancy(lib, m) for m in (0, 1, 2)]
            vox = [_cuda.gen_full_voxels(lib, m) for m in (0, 1, 2)]
            nt = cs.go_nt(name.split()[0])
            block = (f", {lib.fabber_gen_full_smem()} B a voxel "
                     f"(fulltime_smem "
                     f"{_cuda.fulltime_smem(p, q, nt, tle.smem_floats)}), "
                     f"voxels a block {vox}, blocks/SM {occ}")
        cs.log(f"  {name} ({kernel}): nvcc {secs:.1f} s{block}, value + "
               f"tangent ops {tle.value_ops} + {tle.tangent_ops} "
               f"({tle.needed_ops} needed)")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"   ptxas: {line.strip()}")
    phases = a.phases.split(",")
    if "3l" in phases:
        t = time.perf_counter()
        ok3l, worst = cs.check_fulltime_kernels("cuda", nv=a.nv)
        fig["3l"] = (ok3l, worst, time.perf_counter() - t)
        ok &= ok3l
    if "3m" in phases:
        t = time.perf_counter()
        ok3m, worst = cs.check_generic_ops_kernels("cuda", nv=a.nv)
        fig["3m"] = (ok3m, worst, time.perf_counter() - t)
        ok &= ok3m
    if "4ab" in phases:
        t = time.perf_counter()
        ok4, launches = cs.run_fulltime_path("cuda")
        fig["4ab"] = (ok4, launches, time.perf_counter() - t)
        ok &= ok4
    if "4ac" in phases:
        t = time.perf_counter()
        ok4, launches = cs.run_generic_ops_paths("cuda")
        fig["4ac"] = (ok4, launches, time.perf_counter() - t)
        ok &= ok4
    if "5l" in phases:
        t = time.perf_counter()
        fig["5l"] = cs.time_fulltime("cuda", card)
        fig["5l_s"] = time.perf_counter() - t
    if "5m" in phases:
        t = time.perf_counter()
        fig["5m"] = cs.time_generic_ops("cuda", card)
        fig["5m_s"] = time.perf_counter() - t
    if a.coop:
        import coop_sections
        fig["coop"] = coop_sections.compare(card, a.coop, ("6t",), True)
        ok &= fig["coop"]["ok"]
    fig["ok"] = ok
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fulltime.json").write_text(json.dumps(fig, default=str))
    cs.log(f"phases {fig.get('3l', [None])[0]} {fig.get('4ab', [None])[0]}"
           f"  [{card}]")
    print(json.dumps(fig, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
