#!/usr/bin/env python3
"""The cooperative kernels on one NVIDIA GPU: kernel 7's cooperative form
(row 7c, csrc/fused_vb_iter.cuh fused_vb_iter_coop_kernel) and kernel 6's
full-time form (row 6t, csrc/fused_nl_loop.cuh fused_nl_loop_full_kernel),
timed and profiled by section, the current tree beside an earlier one.

Run from the repository root:

    python3 probes/coop_sections.py [--parent DIR] [--kernels 7c,6t]
                                    [--sections] [--nv7 N] [--nv6 N]
                                    [--geometry]

DIR is a checkout of the earlier tree (`git archive <rev> | tar -x -C
DIR`, in a directory .gitignore lists, such as build/parent). Each side
runs in a process of its own, importing its own tree's package and
chip_smoke.py (this file's --side mode), in turns: parent, current,
current, parent. A side builds its units (7c: exp num-exps 22 and 20 at
Q = 1, P = 44 and 40, and num-exps 12 at noise-pattern 1234, P = 24, Q = 4,
folded; 6t: the convolution, the centred biexponential and the shift of
tests/torch_fulltime_models.py at T = 100 and pairs-test of
tests/torch_generic_ops_models.py at T = 64, Q = 1), all nvcc processes
started together, then times each on the same planes (chip_smoke.py's
makers, the same seeds; 7c one iteration from the latent truth on --nv7
voxels, default 262,144; 6t maxits 10 on --nv6, default 1,000,000; CUDA
events, best of 3 after a warm-up) and logs each unit's registers, stack
frame, spill stores, block bytes, voxels a block and blocks per SM. The
sides' outputs are compared (the largest difference relative to the
plane's scale, each output).

With --sections, the current side also builds its units with
-DFABBER_SECTION_CLOCKS and reports where a warp's cycles go
(probes/csrc/sections.cuh: lane 0 of each warp stamps clock64() at each
FABBER_MARK of the package's kernels; one launch after a warm-up, the
cycles summed over the warps, SECTIONS names them). The marks cost a
shared read-modify-write by one lane each; the unmarked times are the
ones to compare.

With --geometry, the current side also times each 6t model's unit at
each W (voxels a block) of GEOMETRY_W: its fused_nl_loop.cuh patched
(_geometry_header) so that a C entry of the probe's build,
fabber_probe_geometry(w), makes full_geometry return W and its blocks
per SM: what full_geometry's choice of W does to each model's time.

Every figure is printed with the card's name and power limit; the last
line is one JSON object of them (also written to
chiprun_out/coop_sections.json).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROBES_CSRC = ROOT / "probes" / "csrc"
SECTIONS = {0: "setup", 1: "chunk evaluation", 2: "pass-A sums",
            3: "prec/rhs", 4: "Cholesky", 5: "inverse", 6: "means",
            7: "LM", 8: "pass B", 9: "traces", 10: "stores", 11: "pass C",
            12: "functor lines", 13: "functor reductions",
            14: "functor contractions", 15: "pass sums", 16: "test",
            18: "noise update and rows", 19: "F pass"}
# (tag, exp num-exps, noise pattern) of 7c's shapes
K7_SHAPES = (("p44", 22, "1"), ("p40", 20, "1"), ("p24_q4", 12, "1234"))
# 6t's models: (tag, name, chip_smoke.py's plane and engine makers)
KEEP = 16_384        # voxels of each output kept to compare the sides
K6_MODELS = (("conv", "conv-test", "fulltime"),
             ("centred", "biexp-centred-test", "fulltime"),
             ("shift", "shift-test", "fulltime"),
             ("pairs", "pairs-test", "generic_ops"))


GEOMETRY_W = (1, 2, 4)   # the voxels a block of --geometry


def log(msg):
    print(msg, flush=True)


def _geometry_header(cuda, root):
    """cuda.CSRC overlaid with a fused_nl_loop.cuh whose full_geometry
    returns the W that fabber_probe_geometry set (0: its own choice)."""
    d = Path(root) / "build" / "geometry_csrc"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda.CSRC, d)
    f = d / "fused_nl_loop.cuh"
    text = f.read_text()
    head = ("template <class M, int Q, int MODE>\n"
            "int full_geometry(int* blocks) {\n")
    assert text.count(head) == 1, head
    text = text.replace(head, (
        "int fabber_probe_w = 0;\n"
        "}  // namespace\n"
        'extern "C" void fabber_probe_geometry(int w) { fabber_probe_w = w; }\n'
        "namespace {\n" + head +
        "  if (fabber_probe_w > 0) {\n"
        "    const auto k = fused_nl_loop_full_kernel<M, Q, MODE>;\n"
        "    const long long b = fabber_probe_w * FullLayout<M, Q>::bytes;\n"
        "    cudaFuncSetAttribute(k,\n"
        "        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b);\n"
        "    *blocks = tile_occupancy(k, fabber_probe_w * kCoopThreads, b);\n"
        "    return fabber_probe_w;\n"
        "  }\n"))
    f.write_text(text)
    return d


# ---- one side, in a process of its own ------------------------------------

def _marked(cuda, root):
    """Build the side's units with the section marks: the flag and an
    include directory holding sections.cuh."""
    inc = Path(root) / "build" / "sections_inc"
    inc.mkdir(parents=True, exist_ok=True)
    shutil.copy(PROBES_CSRC / "sections.cuh", inc / "sections.cuh")
    cuda.NVCC_FLAGS += ["-DFABBER_SECTION_CLOCKS", "-I", str(inc)]


def _sections(lib):
    import ctypes
    buf = (ctypes.c_ulonglong * 24)()
    assert lib.fabber_sections_read(buf) == 0
    return {SECTIONS.get(k, str(k)): int(buf[k]) for k in range(24)
            if buf[k]}


def _frame(text, *parts):
    import chip_smoke as cs
    fn = getattr(cs, "ptxas_frame", cs.ptxas_entry)
    return fn(text, *parts)


def geometry(cs, cuda, fl, root, nv6):
    """--geometry: each 6t model's unit at each W of GEOMETRY_W."""
    import ctypes
    import torch
    from concurrent.futures import ThreadPoolExecutor
    csrc = cuda.CSRC
    cuda.CSRC = _geometry_header(cuda, root)
    out = {}
    try:
        engines = {}
        for ktag, name, maker in K6_MODELS:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(cs.SEED + 52)
            plane, _, _ = getattr(cs, f"{maker}_plane")(name, nv6, gen,
                                                        "cuda")
            engines[ktag] = getattr(cs, f"{maker}_engine")(name, plane,
                                                           "cuda")
        with ThreadPoolExecutor(len(engines)) as pool:
            libs = dict(zip(engines, pool.map(
                lambda e: cuda.build_generated(e.functor.source,
                                               e.functor.nparams, 1,
                                               "nl_loop_full"),
                engines.values())))
        for ktag, eng in engines.items():
            lib = libs[ktag]
            lib.fabber_probe_geometry.argtypes = [ctypes.c_int]
            tle = eng.functor
            tle.libs[("nl_loop_full", 1)] = lib
            tr = eng._transforms()
            args = eng.nl_loop_args(eng.initial_state())
            figs = []
            for w in (0,) + GEOMETRY_W:
                lib.fabber_probe_geometry(w)
                ms = cs.best_ms(lambda: fl.fused_nl_loop(
                    eng.model, tr, *args, cs.ITERS, True, functor=tle))
                fig = {"w": w or cuda.gen_full_voxels(lib, 0), "forced":
                       w > 0, "ms": ms,
                       "blocks_per_sm": cuda.gen_full_occupancy(lib, 0)}
                figs.append(fig)
                log(f" 6t {ktag} geometry: {fig}")
            out[ktag] = figs
            del args
        return out
    finally:
        cuda.CSRC = csrc


def side(root, kernels, marked, nv7, nv6, tag, geom=False):
    """Time (and with marked, profile) root's 7c and 6t; returns the
    figures and saves each output to build/coop_sections/<tag>_*.pt."""
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from concurrent.futures import ThreadPoolExecutor
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    _cuda.load()
    if marked:
        _marked(_cuda, root)
    save = ROOT / "build" / "coop_sections"
    save.mkdir(parents=True, exist_ok=True)
    out = {}
    t0 = time.perf_counter()
    shapes = [("nl", 2 * num, int(pat[-1]), 1, "vb_iter")
              for _, num, pat in K7_SHAPES] if "7c" in kernels else []
    functors = []
    if "6t" in kernels:
        functors = [f for f in cs.fulltime_functors() if f[3] == 1] + [
            f for f in cs.generic_ops_functors()
            if f[0] == "pairs-test Q=1"]
    with ThreadPoolExecutor(len(shapes) + len(functors) or 1) as pool:
        futs = [pool.submit(_cuda.build_instance, *s) for s in shapes] + [
            pool.submit(_cuda.build_generated, tle.source, p, q, k)
            for _, tle, p, q, k in functors]
        for f in futs:
            f.result()
    out["build_s"] = time.perf_counter() - t0

    def run(name, fn, lib):
        ms, r = cs.best_ms(fn, keep=True)
        fig = {"ms": ms}
        if marked:
            lib.fabber_sections_reset()
            fn()
            torch.cuda.synchronize()
            fig["cycles"] = _sections(lib)
        torch.save([x[..., :KEEP].cpu() if torch.is_tensor(x) else x
                    for x in r], save / f"{tag}_{name}.pt")
        return fig

    if "7c" in kernels:
        for stag, num, pattern in K7_SHAPES:
            p, nq = 2 * num, int(pattern[-1])
            gen = torch.Generator(device="cuda")
            gen.manual_seed(cs.SEED + 57)
            data, _, truth = cs.multiexp_plane(num, nv7, gen, "cuda")
            eng = cs.nl_case_engine("exp", num, pattern, data, "cuda")
            tr = eng._transforms()
            a = eng.nl_loop_args(eng.initial_state())
            ia = (torch.log(truth).contiguous(), a[1], a[2],
                  torch.full((nq, nv7), 1.0 / cs.BI_SD ** 2, device="cuda"),
                  a[3], a[4], True)
            lib = _cuda.build_instance("nl", p, nq, 1, "vb_iter")
            fig = run(f"7c_{stag}",
                      lambda: fv.fused_iteration(eng.model, tr, *ia), lib)
            key = _cuda.instance_key("nl", p, nq, 1, "vb_iter")
            text = _cuda.inst_build_log.get(key, (0, ""))[1]
            fig["ptxas"] = _frame(text, "fused_vb_iter_coop_kernel",
                                  f"ELi{nq}ELb0E")
            fig["blocks_per_sm"] = _cuda.vb_iter_occupancy(1, p, nq, False,
                                                           0, cs.BI_NT)
            if hasattr(_cuda, "coop_smem"):   # the parent's: not reported
                fig["block_bytes"] = _cuda.coop_smem(p, nq)
            fig["voxels"] = nv7
            out[f"7c_{stag}"] = fig
            log(f" 7c {stag}: {fig}")
            del eng, a, ia, data, truth
            torch.cuda.empty_cache()
    if "6t" in kernels:
        for ktag, name, maker in K6_MODELS:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(cs.SEED + 52)
            plane, _, _ = getattr(cs, f"{maker}_plane")(name, nv6, gen,
                                                        "cuda")
            eng = getattr(cs, f"{maker}_engine")(name, plane, "cuda")
            tr = eng._transforms()
            args = eng.nl_loop_args(eng.initial_state())
            tle = eng.functor
            lib = tle.libs[("nl_loop_full", 1)]
            fig = run(f"6t_{ktag}", lambda: fl.fused_nl_loop(
                eng.model, tr, *args, cs.ITERS, True, functor=tle), lib)
            text = _cuda.gen_build_log.get(_cuda.generated_key(
                tle.source, tle.nparams, 1, "nl_loop_full"), (0, ""))[1]
            fig["ptxas"] = _frame(text, "fused_nl_loop_full_kernel",
                                  "Li1ELi0E")
            fig["blocks_per_sm"] = [_cuda.gen_full_occupancy(lib, m)
                                    for m in (0, 1, 2)]
            fig["block_bytes"] = int(lib.fabber_gen_full_smem())
            if hasattr(_cuda, "gen_full_voxels"):   # the parent's: 1
                fig["voxels_a_block"] = [_cuda.gen_full_voxels(lib, m)
                                         for m in (0, 1, 2)]
            fig["voxels"] = nv6
            out[f"6t_{ktag}"] = fig
            log(f" 6t {ktag}: {fig}")
            del eng, args, plane
            torch.cuda.empty_cache()
        if geom:
            out["6t_geometry"] = geometry(cs, _cuda, fl, root, nv6)
    return out


# ---- the turns, in the calling process ------------------------------------

def run_side(root, kernels, marked, nv7, nv6, tag, geom=False):
    cmd = [sys.executable, str(Path(__file__).resolve()), "--side",
           str(root), "--kernels", ",".join(kernels), "--nv7", str(nv7),
           "--nv6", str(nv6), "--tag", tag] + (
        ["--sections"] if marked else []) + (
        ["--geometry"] if geom else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for line in proc.stdout.splitlines()[:-1]:
        log(f"  [{tag}] {line}")
    if proc.returncode != 0:
        log(f"  [{tag}] FAILED ({proc.returncode}):\n{proc.stderr[-6000:]}")
        return None
    res = json.loads(proc.stdout.splitlines()[-1])
    res["process_s"] = time.perf_counter() - t0
    return res


def compare_outputs(a, b, names):
    """{name: [largest |a - b| over the largest |b|, per output]} of the
    saved outputs of sides a and b."""
    import torch
    save = ROOT / "build" / "coop_sections"
    out = {}
    for name in names:
        ra = torch.load(save / f"{a}_{name}.pt")
        rb = torch.load(save / f"{b}_{name}.pt")
        out[name] = [None if not torch.is_tensor(x) else float(
            (x.double() - y.double()).abs().max()
            / max(float(y.double().abs().max()), 1e-30))
            for x, y in zip(ra, rb)]
    return out


def compare(card, parent=None, kernels=("7c", "6t"), sections=False,
            nv7=262_144, nv6=1_000_000, geom=False):
    """The turns (parent, current, current, parent; the current side
    alone without a parent) and, with sections, the current side's marked
    run: {figures, "ok"}. Also probes/wide_nl.py's and probes/fulltime.py's
    --coop DIR."""
    fig = {"card": card}
    ok = True
    turns = [("current", ROOT)]
    if parent:
        par = Path(parent).resolve()
        turns = [("parent", par), ("current", ROOT), ("current", ROOT),
                 ("parent", par)]
    times = {}
    for i, (tag, root) in enumerate(turns):
        res = run_side(root, kernels, False, nv7, nv6, f"{tag}{i}",
                       geom and tag == "current" and i <= 1
                       and "6t" in kernels)
        ok &= res is not None
        fig[f"{tag}{i}"] = res
        for k, v in (res or {}).items():
            if isinstance(v, dict) and "ms" in v:
                times.setdefault(k, {}).setdefault(tag, []).append(v["ms"])
    fig["times"] = times
    for k, t in times.items():
        log(f" {k}: " + ", ".join(f"{s} {min(v):.3f} ms (of {v})"
                                  for s, v in t.items()) + f"  [{card}]")
    if parent and ok:
        fig["parent_vs_current"] = compare_outputs("parent0", "current1",
                                                   list(times))
        for k, v in fig["parent_vs_current"].items():
            log(f" {k} outputs, current against parent (rel. to its "
                f"scale): {v}")
    if sections:
        res = run_side(ROOT, kernels, True, nv7, nv6, "current_marked")
        ok &= res is not None
        fig["current_marked"] = res
        for k, v in (res or {}).items():
            if isinstance(v, dict) and "cycles" in v:
                tot = sum(v["cycles"].values())
                shares = {s: round(c / tot, 4)
                          for s, c in v["cycles"].items()}
                log(f" sections current {k} ({v['ms']:.3f} ms marked, "
                    f"{tot} warp-cycles): {shares}  [{card}]")
    fig["ok"] = ok
    return fig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--kernels", default="7c,6t")
    ap.add_argument("--sections", action="store_true",
                    help="profile the current side by section")
    ap.add_argument("--nv7", type=int, default=262_144)
    ap.add_argument("--nv6", type=int, default=1_000_000)
    ap.add_argument("--side", default=None)
    ap.add_argument("--tag", default="current")
    ap.add_argument("--geometry", action="store_true")
    a = ap.parse_args()
    kernels = a.kernels.split(",")
    if a.side:
        res = side(Path(a.side).resolve(), kernels, a.sections, a.nv7,
                   a.nv6, a.tag, a.geometry)
        print(json.dumps(res, default=str))
        return 0
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    log(card)
    fig = compare(card, a.parent, kernels, a.sections, a.nv7, a.nv6,
                  a.geometry)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    text = json.dumps(fig, default=str)
    (out / "coop_sections.json").write_text(text)
    print(text)
    return 0 if fig["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
