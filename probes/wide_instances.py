#!/usr/bin/env python3
"""What a change to the kernel sources did to the prebuilt instances, on
one NVIDIA GPU (written for the P = 5..8 instances against the P <= 4
ones, kept for the per-shape instances against every prebuilt one).

Run from the repository root:

    python3 probes/wide_instances.py --parent DIR

DIR holds an earlier csrc/ (every .cu and .cuh of it). The probe builds
the kernel library (ops/_cuda.py build) and, in parallel, the earlier
spectral_stats.cu, spectral_core.cu, spectral_fused.cu, fused_whole.cu,
fused_loop.cu, fused_ar_loop.cu, fused_nl_loop.cu, fused_vb_iter.cu and
fused_nlls.cu each alone from DIR (probes/variants.py, with their
SOURCE_FLAGS), then prints:

  - each source's nvcc seconds in both builds (the library's sources
    compile in parallel, so its seconds are each compiler's wall time
    beside the others; the earlier sources alone, also in parallel);
  - for every kernel entry both builds hold (kernels 1-9), whether its
    SASS is the earlier build's (cuobjdump;
    addresses, labels and the anonymous namespace's path hash dropped),
    and else whether it is once the constant-bank offsets of its
    parameters (c[0x0][...]) are dropped too, or once every constant
    bank's offsets are (the module's literals move with the other
    kernels of its translation unit), the rest with their instruction
    counts, and ptxas's registers and spill bytes in both;
  - the times of kernels 1, 2 and 3 on phase 5's shape (16,777,216
    voxels, T=106, poly P=3, maxits, the plan's staged forms), and of
    kernels 4, 5 and 9 on chip_smoke.py phases 5d and 5f's
    shapes (16,777,216 voxels, T=106, P=3; kernel 4 maxits at Q = 1, 2,
    trialmode at Q=2, lm at Q=1; kernel 5 at Q=2; kernel 9 maxits and
    pointzeroone at nq = 1, 2), and of kernels 6, 7 and 8 on phases 5b
    and 5e's (ExpSum<2>, 4,000,000 voxels, T=100) where their SASS
    moved, each build in turns: earlier, this, this, earlier (CUDA
    events, best of 3 after a warm-up; the earlier build's entry points
    swapped into the library, probes/variants.py swap), with both
    builds' outputs compared bit for bit.

Every figure is printed with the card's name and power limit; the last
line is one JSON object of them (also written to
chiprun_out/wide_instances.json).
"""

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import variants  # noqa: E402

# source -> its C entry point (the one the wrappers launch)
SOURCES = {"spectral_stats.cu": "fabber_spectral_stats",
           "spectral_core.cu": "fabber_spectral_core",
           "spectral_fused.cu": "fabber_spectral_fused",
           "fused_whole.cu": "fabber_fused_whole",
           "fused_loop.cu": "fabber_fused_vb_loop",
           "fused_ar_loop.cu": "fabber_fused_ar_loop",
           "fused_nl_loop.cu": "fabber_fused_nl_loop",
           "fused_vb_iter.cu": "fabber_fused_vb_iter",
           "fused_nlls.cu": "fabber_fused_nlls"}
KERNEL_OF = {"spectral_stats.cu": "spectral_stats_kernel",
             "spectral_core.cu": "spectral_core_kernel",
             "spectral_fused.cu": "spectral_fused_kernel",
             "fused_whole.cu": "fused_whole_kernel",
             "fused_loop.cu": "fused_loop_kernel",
             "fused_ar_loop.cu": "fused_ar_loop_kernel",
             "fused_nl_loop.cu": "fused_nl_loop_kernel",
             "fused_vb_iter.cu": "fused_vb_iter_kernel",
             "fused_nlls.cu": "fused_nlls_kernel"}
NV, NV_NL = 16_777_216, 4_000_000


def ptxas_table(text):
    """{entry: (registers, spill store bytes)} from nvcc -Xptxas -v
    output (the anonymous namespace's path hash dropped)."""
    out, lines = {}, variants._unhashed(text).splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m:
            continue
        regs = spill = None
        for nxt in lines[i + 1:i + 6]:
            s = re.search(r"(\d+) bytes spill stores", nxt)
            if s:
                spill = int(s.group(1))
            r = re.search(r"Used (\d+) registers", nxt)
            if r:
                regs = int(r.group(1))
                break
        out[variants.entry_key(m.group(1))] = (regs, spill)
    return out


def sass_moves(main, parent, kernel):
    """For the entries of kernel both SASS dumps hold: (compared,
    identical, identical once the parameters' constant-bank offsets
    (c[0x0][...]) are dropped, identical once every constant-bank offset
    is (the module's own banks hold literals whose offsets move with the
    other kernels of its translation unit), the names of the rest and
    how many instructions of each differ)."""
    def consts(body, bank=r"0x0"):
        return [re.sub(rf"c\[{bank}\]\[0x[0-9a-f]+\]", "c[B][K]", x)
                for x in body]
    both = sorted(n for n in set(main) & set(parent) if kernel in n)
    same = [n for n in both if main[n] == parent[n]]
    mod = [n for n in both if n not in same
           and consts(main[n]) == consts(parent[n])]
    banks = [n for n in both if n not in same and n not in mod
             and consts(main[n], r"0x[0-9a-f]+")
             == consts(parent[n], r"0x[0-9a-f]+")]
    rest = {n: (len(main[n]), len(parent[n]),
                sum(a != b for a, b in zip(main[n], parent[n])))
            for n in both if n not in same + mod + banks}
    return len(both), len(same), len(mod), len(banks), rest


def turns(card, name, run, entry, path, out):
    """run() timed with the earlier build's entry point and this one's,
    in turns (earlier, this, this, earlier); both results bit for bit."""
    t = {"earlier": [], "this": []}
    res = {}
    for who in ("earlier", "this", "this", "earlier"):
        if who == "earlier":
            variants.swap(path, [entry])
        try:
            ms, res[who] = cs.best_ms(run, keep=True)
        finally:
            variants.restore()
        t[who].append(ms)
    same = cs.bits_equal(res["earlier"], res["this"])
    out[name] = {"earlier_ms": t["earlier"], "this_ms": t["this"],
                 "bits_equal": same}
    cs.log(f" {name}: earlier {t['earlier']!r} ms, this {t['this']!r} ms; "
           f"outputs {'equal' if same else 'DIFFER'} bit for bit  [{card}]")


def main():
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import fused_whole as fw
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="an earlier csrc/'s sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(card)
    out = {"card": card}
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        lib = pool.submit(_cuda.build)
        jobs = {src: (src, _cuda.SOURCE_FLAGS.get(src, []), args.parent)
                for src in SOURCES}
        built = variants.build_all(jobs)
        path = lib.result()
    _cuda.load()
    secs = dict(re.findall(r"== (\S+) \(nvcc ([\d.]+) s\)", _cuda.build_log))
    main_sass = variants.sass_text(path)
    main_regs = ptxas_table(_cuda.build_log)
    out["sources"] = {}
    for src, (ppath, psecs, plog) in built.items():
        psass = variants.sass_text(ppath)
        n, same, mod, banks, rest = sass_moves(main_sass, psass,
                                               KERNEL_OF[src])
        pregs = ptxas_table(plog)
        regs_moved = sorted(e for e in pregs if e in main_regs
                            and pregs[e] != main_regs[e])
        out["sources"][src] = {
            "nvcc_s": float(secs.get(src, "nan")),
            "earlier_nvcc_s": psecs, "entries": n, "sass_identical": same,
            "sass_identical_but_constant_offsets": mod,
            "sass_identical_but_module_constant_offsets": banks,
            "sass_other": rest,
            "registers_or_spills_moved": {
                e: [pregs[e], main_regs[e]] for e in regs_moved}}
        cs.log(f" {src}: nvcc {secs.get(src)} s (earlier alone "
               f"{psecs:.1f} s); {n} entries of both builds: {same} SASS "
               f"identical, {mod} identical but parameter offsets, {banks} "
               f"but module constant offsets, {len(rest)} other; "
               f"registers/spills moved in {len(regs_moved)}  [{card}]")
        for e, (a, b, d) in rest.items():
            cs.log(f"   {e}: {a} / {b} instructions (this / earlier), "
                   f"{d} differ in place")
        for e in regs_moved[:10]:
            cs.log(f"   {e}: {pregs[e]} -> {main_regs[e]}")

    device = "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(cs.SEED + 13)
    design = cs.poly_design(3)
    plane = cs.pattern_plane(design, 2, NV, gen, device)
    ppath = {src: built[src][0] for src in SOURCES}
    times = {}
    # kernels 1, 2 and 3 at phase 5's shape (poly P=3, maxits)
    q1 = np.ones(cs.NT)
    tc = fs.pack_mxu_consts(design, q1, cs.NT, torch.float32, device)
    ac = fs.pack_solve_consts(design, q1, cs.NT, torch.float32)
    c_post = (cs.NT - 1) * 0.5 + 1e-6
    sc = fs.pack_spectral_consts(design, q1, cs.NT, np.full(3, 1e-12), 1e-6,
                                 c_post, 1e-8, 50.0, torch.float32,
                                 (-100.0, c_post + 0.5))
    pm = torch.zeros((3, NV), device=device)
    stats = fs.spectral_stats(plane, tc, ac)
    for name, run, src in (
            ("kernel 1 P=3 staged", lambda: fs.spectral_stats(plane, tc, ac),
             "spectral_stats.cu"),
            ("kernel 2 P=3 maxits",
             lambda: fs.spectral_core(*stats, pm, sc, cs.ITERS),
             "spectral_core.cu"),
            ("kernel 3 P=3 maxits staged",
             lambda: fs.spectral_fused(plane, tc, ac, pm, sc, cs.ITERS),
             "spectral_fused.cu")):
        turns(card, name, run, SOURCES[src], ppath[src], times)
    del stats, pm
    torch.cuda.empty_cache()
    for nq in (1, 2):
        a = cs.whole_inputs(design, cs.group_masks(nq), plane, device)
        turns(card, f"kernel 4 P=3 Q={nq} maxits",
              lambda: fw.fused_whole(*a, cs.ITERS), SOURCES["fused_whole.cu"],
              ppath["fused_whole.cu"], times)
    for kind, nq in (("trialmode", 2), ("lm", 1)):
        a = cs.whole_inputs(design, cs.group_masks(nq), plane, device)
        det, cap = cs.whole_detector(kind, 3, nq)
        turns(card, f"kernel 4 P=3 Q={nq} {kind}",
              lambda: fw.fused_whole(*a, cap, -1.0, det),
              SOURCES["fused_whole.cu"], ppath["fused_whole.cu"], times)
    a = cs.whole_inputs(design, cs.group_masks(2), plane, device)
    stats = tuple(x.contiguous() for x in fw.whole_stats_plain(
        a[0], a[1], a[2], 3, 2))
    turns(card, "kernel 5 P=3 Q=2",
          lambda: fl.fused_vb_loop(*stats, a[2], a[3], a[4], cs.ITERS, -1.0),
          SOURCES["fused_loop.cu"], ppath["fused_loop.cu"], times)
    del plane, a, stats
    torch.cuda.empty_cache()
    gen.manual_seed(cs.SEED + 21)
    for nq in (1, 2):
        plane, _ = cs.ar_plane(nq, NV, gen, device, sd_range=(1e-2, 1.0))
        a, nm = cs.ar_kernel_inputs(plane, nq, device)
        del plane
        turns(card, f"kernel 9 P=3 nq={nq} maxits",
              lambda: fa.fused_ar_loop(*a, cs.ITERS),
              SOURCES["fused_ar_loop.cu"], ppath["fused_ar_loop.cu"], times)
        det, cap = cs.ar_detector("pointzeroone", nq, nm)
        turns(card, f"kernel 9 P=3 nq={nq} pointzeroone",
              lambda: fa.fused_ar_loop(*a, cap, det),
              SOURCES["fused_ar_loop.cu"], ppath["fused_ar_loop.cu"], times)
        del a
        torch.cuda.empty_cache()
    moved = [s for s in ("fused_nl_loop.cu", "fused_vb_iter.cu",
                         "fused_nlls.cu") if out["sources"][s]["sass_other"]
             or out["sources"][s]["sass_identical"]
             != out["sources"][s]["entries"]]
    if moved:
        gen.manual_seed(cs.SEED + 7)
        data, _, truth = cs.biexp_plane(NV_NL, gen, device)
        eng = cs.nl_engine("biexp", "1", data, device)
        tr = eng._transforms()
        nargs = eng.nl_loop_args(eng.initial_state())
        phi = torch.full((1, NV_NL), 1.0 / cs.BI_SD ** 2, device=device)
        it = (torch.log(truth).contiguous(), nargs[1], nargs[2], phi,
              nargs[3], nargs[4], True)
        neng = cs.nlls_engine(data, device)
        p0 = neng.initial_means()
        # the pattern 1234 (Q=4) and phase 1, the instances whose SASS
        # moves most with the translation unit's other kernels
        eng4 = cs.nl_engine("biexp", "1234", data, device)
        nargs4 = eng4.nl_loop_args(eng4.initial_state())
        phi4 = torch.full((4, NV_NL), 1.0 / cs.BI_SD ** 2, device=device)
        it4 = (it[0], nargs4[1], nargs4[2], phi4, nargs4[3], nargs4[4], True)
        runs = {"fused_nl_loop.cu": {
                    "Q=1": lambda: fnl.fused_nl_loop(
                        eng.model, tr, *nargs, cs.ITERS, True),
                    "Q=4": lambda: fnl.fused_nl_loop(
                        eng4.model, tr, *nargs4, cs.ITERS, True)},
                "fused_vb_iter.cu": {
                    "Q=1": lambda: fv.fused_iteration(eng.model, tr, *it),
                    "Q=4": lambda: fv.fused_iteration(eng4.model, tr,
                                                      *it4)},
                "fused_nlls.cu": {
                    f"{name}{' Marquardt' if marq else ''}":
                        (lambda its, marq, post: lambda: fn.fused_nlls_loop(
                            neng.model, tr, p0, data, neng.tmask_host, its,
                            marq, posterior=post))(its, marq, post)
                    for name, its, post in (
                        ("fresh", neng.max_its, True),
                        ("phase 1", cs.NLLS_PHASE1, False))
                    for marq in (False, True)}}
        for src in moved:
            for tag, run in runs[src].items():
                turns(card, f"{KERNEL_OF[src]} ExpSum<2> {tag}", run,
                      SOURCES[src], ppath[src], times)
    out["times"] = times
    ok = all(r["bits_equal"] for r in times.values())
    line = json.dumps(out)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/wide_instances.json").write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
