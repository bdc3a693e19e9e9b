#!/usr/bin/env python3
"""Kernel 6's full-time form on one NVIDIA GPU, alone: chip_smoke.py's
phases 3l, 4ab and 5l without the rest of the script, and what factoring
the cooperative pieces out of kernel 7 (csrc/coop_device.cuh) and
including the new headers into kernel 6's did to the hand-written
kernels' SASS.

Run from the repository root:

    python3 probes/fulltime.py [--phases 3l,4ab,5l] [--nv N]
                               [--parent DIR]

It builds the full-time functors chip_smoke.py builds (the three models
of tests/torch_fulltime_models.py at T=100, Q 1 and 2; ops/_cuda.py
build_generated "nl_loop_full"), all their nvcc processes started
together, prints each build's seconds, ptxas lines and block bytes, and
runs the phases asked for (phase 3l at --nv voxels, default chip_smoke's
65,536). With --parent DIR (a directory holding an earlier csrc/'s files,
`git show <rev>:fabber_core_tpu_torch/csrc/<file>`), it first compiles,
with the current sources and with DIR's, kernel 6's and kernel 7's
prebuilt sources (fused_nl_loop.cu, fused_vb_iter.cu), kernel 7's
cooperative form as a per-shape unit (ExpSum<9>, P = 18, at Q = 1 per
group and ExpSum<22>, P = 44, at Q = 2 folded), kernel 6 rolled (ExpSum<9>
at Q = 1) and kernel 6 with myexp's generated per-sample functor, and
compares the SASS of every entry both builds hold (probes/variants.py
sass_text): none may move. Every figure is printed with the card's name
and power limit; the last line is one JSON object of them (also written
to chiprun_out/fulltime.json).
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


def unit_jobs(parent):
    """{name: (current job, parent job)} of variants.build jobs: the
    prebuilt sources, and per-shape units by -D flags."""
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.models.kernelgen import \
        derive_time_signal_functor
    from fabber_core_tpu_torch.options import RunOptions
    jobs = {}
    for src in ("fused_nl_loop.cu", "fused_vb_iter.cu"):
        jobs[src] = ((src, []), (src, [], parent))

    def inst(p, q):
        return [f"-DFABBER_INST_P={p}", f"-DFABBER_INST_Q={q}",
                "-DFABBER_INST_KIND=1"] + (
            ["-DFABBER_ROLL_LOOPS"] if _cuda.rolled_loops(p, q) else [])
    for name, src, p, q in (("vb_iter coop P18 Q1", "fused_vb_iter.cu", 18, 1),
                            ("vb_iter coop P44 Q2", "fused_vb_iter.cu", 44, 2),
                            ("nl_loop rolled P18 Q1", "fused_nl_loop.cu", 18,
                             1)):
        jobs[name] = ((src, inst(p, q)), (src, inst(p, q), parent))
    # kernel 6 with a generated per-sample functor: the same unit text,
    # beside each csrc
    from fabber_core_tpu_torch.models import load_models_from_file
    load_models_from_file(cs.PLUGIN)
    model = get_model_class("myexp")(RunOptions({"model": "myexp",
                                                 "dt": "0.05",
                                                 "num-exps": "2"}))
    tle = derive_time_signal_functor(model, 4)
    cu = _cuda.generated_source(tle.source, 4, 1, "nl_loop")
    here = ROOT / "build" / "fulltime_probe"
    here.mkdir(parents=True, exist_ok=True)
    (here / "gen_myexp.cu").write_text(cu)
    (Path(parent) / "gen_myexp.cu").write_text(cu)
    jobs["nl_loop generated myexp"] = (("gen_myexp.cu", [], here),
                                       ("gen_myexp.cu", [], parent))
    return jobs


def sass_compare(parent):
    """{unit: (entries compared, [entries whose SASS differs])}."""
    jobs = unit_jobs(parent)
    flat = {}
    for name, (cur, par) in jobs.items():
        flat[(name, "cur")] = cur
        flat[(name, "parent")] = par
    t0 = time.perf_counter()
    built = variants.build_all(flat)
    cs.log(f" SASS builds: {len(flat)} units in "
           f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for name in jobs:
        a = variants.sass_text(built[(name, "cur")][0])
        b = variants.sass_text(built[(name, "parent")][0])
        if a is None or b is None:
            out[name] = None
            continue
        both = sorted(set(a) & set(b))
        out[name] = (len(both), [n for n in both if a[n] != b[n]])
        cs.log(f" SASS {name}: {len(both)} entries compared, "
               f"{len(out[name][1])} differ {out[name][1][:4]}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="3l,4ab,5l")
    ap.add_argument("--nv", type=int, default=65_536)
    ap.add_argument("--parent", default=None)
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
    functors = cs.fulltime_functors()
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
        cs.log(f"  {name}: nvcc {secs:.1f} s, block "
               f"{lib.fabber_gen_full_smem()} B (fulltime_smem "
               f"{_cuda.fulltime_smem(p, q, cs.FT_NT, tle.smem_floats)}), "
               f"blocks/SM {[lib.fabber_gen_full_occupancy(m) for m in (0, 1, 2)]}"
               f", value + tangent ops {tle.value_ops} + {tle.tangent_ops}"
               f" ({tle.needed_ops} needed)")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"   ptxas: {line.strip()}")
    phases = a.phases.split(",")
    if "3l" in phases:
        t = time.perf_counter()
        ok3l, worst = cs.check_fulltime_kernels("cuda", nv=a.nv)
        fig["3l"] = (ok3l, worst, time.perf_counter() - t)
        ok &= ok3l
    if "4ab" in phases:
        t = time.perf_counter()
        ok4, launches = cs.run_fulltime_path("cuda")
        fig["4ab"] = (ok4, launches, time.perf_counter() - t)
        ok &= ok4
    if "5l" in phases:
        t = time.perf_counter()
        fig["5l"] = cs.time_fulltime("cuda", card)
        fig["5l_s"] = time.perf_counter() - t
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
