#!/usr/bin/env python3
"""What bounds kernel 5 (csrc/fused_loop.cu, the stats-input whole loop),
and what its candidate steps gain, on one NVIDIA GPU.

Run from the repository root:

    python3 probes/loop_kernel5.py [--parent DIR]

DIR holds an earlier commit's csrc/ sources (the form whose kernel 5 was
fused_whole.cu's STATS_IN instance). At P=3, Q=2, maxits 10, on chip_smoke.py
phase 5d's plane (16,777,216 voxels, T=106, noise pattern 12, statistics
from make_design_stats) and on its first 16,777,213 voxels (a ragged
count), it builds with probes/variants.py, all at once, csrc/ as the
port runs it and the patched copy probes/csrc/fused_loop.cu:

  probe     the copy's default (the parent's arithmetic), the occupancy
            sweep's kernel
  io_only   the same 17 reads and 25 writes a voxel, the loop cut
  wrap      every voxel's steps on the first 131,072 voxels' statistics
            (22 MB, in the 50 MB L2): the compute alone, one launch
  wrap_cut7 the same with csrc/'s step (cut 7)
  cut1 cut3 cut5 cut7 cut15
            the step with fewer instructions (the copy's
            -DFABBER_LOOP_CUT mask: 1 the diagonal reciprocals shared by
            the Cholesky and the inverse, 2 the inverse's divisions as
            products with them, 4 the noise quadratics over the distinct
            terms, 8 rsqrtf for the diagonal; 7 is csrc/'s kernel)
  parent    with --parent: DIR/fused_whole.cu (its kernel 5)

and reports, per build: ptxas's registers and spills of the P=3, Q=2
entry; the SASS instructions of its entry and of one step (the loop's
body; probes/variants.py sass_counts) by opcode, MUFU.LG2 for the logf
of a logdet nothing reads, MUFU.RCP, CALL and BRA for the IEEE division
and square-root sequences; its time on both planes, the builds in turns
(in order, then reversed; CUDA events around five launches straight
from the C entry point, best of 3 after a warm-up, per launch), bit
identity with the parent's build (csrc/'s also with cut7's), near_f64
against the plain version on the aligned plane, and chip_smoke.py
check_loop_kernel (phase 3d's kernel 5 cases). Beside them: a
device-to-device copy of 168 bytes a voxel (the rate the I/O could
reach), the compute alone as 128 launches back to back of the probe
build on the first 131,072 voxels, and the occupancy sweep (the probe
build capped at 2,
4, 6, 8 and 9 blocks per SM by unused dynamic shared memory). With
--parent, the SASS of every kernel csrc/ shares with DIR: kernel 4's
entries mapped from their earlier names (fused_whole_kernel<P, Q, MODE,
STATS_IN, STAGED>) and held equal but for the kernel-parameter
addresses after the three statistics pointers kernel 4 no longer takes
(0x18 lower). The last line is one JSON object of those figures, which
is also written to chiprun_out/loop_kernel5.json.
"""

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
import variants  # noqa: E402

NV = 16_777_216
WRAP = 131_072
SOURCE = "fused_loop.cu"
NAMES = ("fabber_fused_vb_loop",)
PATCHED = variants.PATCHED
BUILDS = {"probe": [], "io_only": ["-DFABBER_LOOP_IO_ONLY"],
          "wrap": [f"-DFABBER_LOOP_WRAP={WRAP - 1}"],
          "wrap_cut7": [f"-DFABBER_LOOP_WRAP={WRAP - 1}",
                        "-DFABBER_LOOP_CUT=7"],
          **{f"cut{m}": [f"-DFABBER_LOOP_CUT={m}"] for m in (1, 3, 5, 7, 15)}}
CANDIDATES = ("cut1", "cut3", "cut5", "cut7", "cut15")
OPCODES = ("FFMA", "FMUL", "FADD", "MUFU", "MUFU.RSQ", "MUFU.RCP",
           "MUFU.LG2", "FCHK", "CALL", "BRA", "FSETP")
SWEEP = (2, 4, 6, 8, 9)
PARAM = re.compile(r"c\[0x0\]\[(0x[0-9a-f]+)\]")
K4_PARENT = re.compile(r"fused_whole_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])"
                       r"ELb([01])E")
K4_NEW = re.compile(r"fused_whole_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E")


def entries(p=3, q=2):
    """(kernel name, mangled parts) of each build's P, Q entry."""
    tail = f"ILi{p}ELi{q}E"
    return {"shipped": ("fused_loop_kernel", tail),
            "parent": ("fused_whole_kernel", f"{tail}Li0ELb1ELb0E"),
            **{b: ("loop_probe_kernel", tail) for b in BUILDS}}


def shift_only(a, b, shift):
    """True when instruction a (this build) is b (the parent's) with
    every kernel-parameter address that differs lower by shift."""
    pa, pb = PARAM.split(a), PARAM.split(b)
    if len(pa) != len(pb):
        return False
    for i, (x, y) in enumerate(zip(pa, pb)):
        if i % 2 == 0 and x != y:
            return False
        if i % 2 == 1 and x != y and int(y, 16) - int(x, 16) != shift:
            return False
    return True


def sass_vs_parent(a, parent, shift=0x18):
    """{compared, identical, params_shifted, differ} of the kernel entries
    of the library parent that a (sass_text of this build's library)
    holds too; kernel 4's by (P, Q, MODE, STAGED), its parent's STATS_IN
    instances (kernel 5) left out."""
    b = variants.sass_text(parent)
    if a is None or b is None:
        return None
    k4a = {m.groups(): n for n in a for m in [K4_NEW.search(n)] if m}
    pairs = [(n, n) for n in sorted(set(a) & set(b))]
    for n in b:
        m = K4_PARENT.search(n)
        if m and m.group(4) == "0":
            key = m.group(1, 2, 3, 5)
            pairs.append((k4a.get(key), n))
    out = {"compared": 0, "identical": 0, "params_shifted": 0, "differ": []}
    for na, nb in pairs:
        if na is None:
            out["differ"].append(f"{nb}: no counterpart")
            continue
        out["compared"] += 1
        la, lb = a[na], b[nb]
        if la == lb:
            out["identical"] += 1
        elif len(la) == len(lb) and all(
                x == y or shift_only(x, y, shift) for x, y in zip(la, lb)):
            out["params_shifted"] += 1
        else:
            out["differ"].append(na)
    return out


def launcher(lib, args, outs, n_iters):
    """fn() launching the library's fabber_fused_vb_loop on args
    (fused_vb_loop's) into outs straight from ctypes (no Python checks:
    the compute-only run launches 14 us kernels back to back)."""
    import torch
    m0, rtqr, dtqr, consts, pm, pp = args
    p, nv = m0.shape
    nq = rtqr.shape[0]
    c32 = consts.to(torch.float32).contiguous()
    ptrs = [x.data_ptr() for x in (m0, rtqr, dtqr)]
    optr = [o.data_ptr() for o in outs]
    stream = torch.cuda.current_stream().cuda_stream
    f = lib.fabber_fused_vb_loop

    def fn():
        err = f(p, nq, n_iters, -1.0, c32.data_ptr(), *ptrs, pm.data_ptr(),
                pp.data_ptr(), nv, *optr, stream)
        if err:
            raise RuntimeError(f"fabber_fused_vb_loop: CUDA error {err}")
    fn.keep = c32
    return fn


def per_launch_ms(fn, n=5, reps=3):
    """Best of reps CUDA-event timings of n back-to-back fn() launches,
    per launch, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / n)
    return best


def outputs(p, nq, nv):
    import torch

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device="cuda")
    return (out(p, nv), out(p, p, nv), out(p, p, nv), out(nq, nv),
            out(nq, nv))


def main():
    import torch
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.options import RunOptions
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier csrc/'s sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    main_lib = _cuda.build()
    jobs = {b: (SOURCE, f, PATCHED) for b, f in BUILDS.items()}
    if args.parent:
        for src in _cuda.SOURCES:
            if (Path(args.parent) / src).exists():
                jobs[f"parent:{src}"] = (src, _cuda.SOURCE_FLAGS.get(src, []),
                                         args.parent)
    built = variants.build_all(jobs)
    if args.parent:
        built["parent"] = built["parent:fused_whole.cu"]
    main = _cuda.load()
    out = {"card": card, "voxels": NV, "builds": {}}
    ents = entries()
    paths = {"shipped": (main_lib, _cuda.build_log)}
    paths.update({b: (built[b][0], built[b][2]) for b in ents if b in built})
    for b, (path, log) in paths.items():
        kname, parts = ents[b]
        n = cs.ptxas_entry(log, kname, parts)
        regs = n.split()[0]
        out["builds"][b] = {
            "ptxas": n,
            "blocks_per_sm_by_registers": (
                min(65536 // (-(-int(regs) * 32 // 256) * 256), 64) // 4
                if regs.isdigit() else None),
            "sass": variants.sass_counts(path, kname, [parts], OPCODES)}
        print(b, json.dumps(out["builds"][b]), flush=True)
    if args.parent:
        main_sass = variants.sass_text(main_lib)
        out["sass_vs_parent"] = {
            src: sass_vs_parent(main_sass, built[f"parent:{src}"][0])
            for src in _cuda.SOURCES if f"parent:{src}" in built}
        print("sass_vs_parent", json.dumps(out["sass_vs_parent"]), flush=True)

    # phase 5d's plane and statistics; the ragged plane's are their first
    # NV - 3 voxels (each voxel's statistics are its own)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 13)
    p, design = 3, cs.poly_design(3)
    plane = cs.pattern_plane(design, 2, NV, gen, "cuda")
    opts = RunOptions({**{k: v for k, v in cs.PATTERN_OPTIONS.items()
                          if not k.startswith("save")},
                       "engine-kernel": "pallas-loop"})
    eng = VBInference(get_model_class("poly")(opts), opts, None,
                      data_plane=plane, device="cuda")
    largs, _ = eng.loop_kernel_args()
    del eng, plane
    torch.cuda.empty_cache()
    planes = {"aligned": largs, "ragged": tuple(
        x[..., :NV - 3].contiguous() if x.is_cuda else x for x in largs)}
    nq = largs[1].shape[0]
    libs = {"shipped": main}
    for b in list(BUILDS) + (["parent"] if args.parent else []):
        lib = ctypes.CDLL(str(built[b][0]))
        lib.fabber_fused_vb_loop.argtypes = \
            main.fabber_fused_vb_loop.argtypes
        lib.fabber_fused_vb_loop.restype = ctypes.c_int
        libs[b] = lib

    # the I/O's reach: a copy of 84 + 84 bytes a voxel
    nbytes = 4 * (p + nq + nq * p + 2 * p + p + 2 * p * p + 2 * nq) * NV
    src = torch.empty(nbytes // 8, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    out["copy_of_its_bytes_ms"] = per_launch_ms(lambda: dst.copy_(src))
    out["copy_TBps"] = nbytes / out["copy_of_its_bytes_ms"] / 1e9
    out["bytes_bound"] = cs.bound(nbytes, 0)
    del src, dst
    torch.cuda.empty_cache()

    # every build in turns on both planes
    order = ["parent"] * bool(args.parent) + ["shipped", "probe",
                                              "io_only"] + list(CANDIDATES)
    times = {b: {pl: float("inf") for pl in planes} for b in order}
    results = {}
    for pl, a in planes.items():
        o = outputs(p, nq, a[0].shape[1])
        for rnd in (order, order[::-1]):
            for b in rnd:
                fn = launcher(libs[b], a, o, cs.ITERS)
                times[b][pl] = min(times[b][pl], per_launch_ms(fn))
        for b in order:
            if b != "io_only":
                launcher(libs[b], a, o, cs.ITERS)()
                results[b, pl] = tuple(x.clone() for x in o)
        del o
        torch.cuda.empty_cache()
    for b in order:
        out["builds"][b]["ms"] = times[b]
    ref = "parent" if args.parent else "probe"
    for b in order:
        if b != "io_only":
            out["builds"][b]["bits_equal_" + ref] = {
                pl: cs.bits_equal(results[b, pl], results[ref, pl])
                for pl in planes}
    out["builds"]["shipped"]["bits_equal_cut7"] = {
        pl: cs.bits_equal(results["shipped", pl], results["cut7", pl])
        for pl in planes}
    print("ms", json.dumps(times), flush=True)

    # near_f64 of each build on the aligned plane
    r32 = fl.fused_vb_loop_plain(*largs, cs.ITERS)
    r64 = fl.fused_vb_loop_plain(*(x.double() if x.is_cuda else x
                                   for x in largs), cs.ITERS)
    for b in order:
        if b != "io_only":
            ok, err, ratio = cs.near_f64(f"{b} V={NV}",
                                         results[b, "aligned"], r32, r64)
            out["builds"][b]["near_f64_16M"] = {"ok": ok, "max_abs_err": err,
                                                "worst_ratio": ratio}
    del r32, r64, results
    torch.cuda.empty_cache()

    # phase 3d's kernel 5 cases per build
    for b in ["shipped"] + list(CANDIDATES) + ["parent"] * bool(args.parent):
        if b == "shipped":
            variants.restore()
        else:
            variants.swap(built[b][0], NAMES)
        ok, err, ratio = cs.check_loop_kernel("cuda")
        out["builds"][b]["phase3d"] = {"ok": ok, "max_abs_err": err,
                                       "worst_ratio": ratio}
        torch.cuda.empty_cache()
    variants.restore()

    # the compute alone: the probe build on the first WRAP voxels, 128
    # launches back to back, and the wrap builds at NV in one launch
    small = tuple(x[..., :WRAP].contiguous() if x.is_cuda else x
                  for x in largs)
    o = outputs(p, nq, WRAP)
    fn = launcher(libs["probe"], small, o, cs.ITERS)
    out["compute_only_back_to_back_ms"] = per_launch_ms(
        fn, n=NV // WRAP) * (NV // WRAP)
    del o, small
    o = outputs(p, nq, NV)
    for b in ("wrap", "wrap_cut7"):
        out[f"compute_only_{b}_ms"] = per_launch_ms(
            launcher(libs[b], largs, o, cs.ITERS))

    # occupancy sweep: the probe build capped by unused shared memory
    lib = libs["probe"]
    lib.fabber_loop_set_smem.argtypes = [ctypes.c_int]
    lib.fabber_loop_occupancy.argtypes = [ctypes.c_int] * 2
    lib.fabber_loop_occupancy.restype = ctypes.c_int
    sweep = {}
    for blocks in (0,) + SWEEP:
        smem = 0 if blocks == 0 else \
            _cuda.SMEM_PER_SM // blocks - _cuda.SMEM_RESERVED
        lib.fabber_loop_set_smem(smem)
        occ = lib.fabber_loop_occupancy(p, nq)
        ms = per_launch_ms(launcher(lib, largs, o, cs.ITERS))
        sweep[str(blocks or "uncapped")] = {"smem": smem,
                                            "blocks_per_sm": occ, "ms": ms}
        print("sweep", blocks, sweep[str(blocks or "uncapped")], flush=True)
    lib.fabber_loop_set_smem(0)
    out["occupancy_sweep"] = sweep
    del o
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "loop_kernel5.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
