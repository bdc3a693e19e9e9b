#!/usr/bin/env python3
"""How much kernel 2's detector modes (csrc/spectral_core.cu, 2d) lose to
stragglers, what its two-phase trialmode form recovers, and what one
instance per detector kind saves, on one NVIDIA GPU.

Run from the repository root:

    python3 probes/core_stragglers.py [--parent DIR]

On chip_smoke.py phase 5c's plane (16,777,216 poly voxels, T=106, P=3,
the same seed; the statistics from kernel 1) it launches 2d under
trialmode, pointzeroone and freduce (max-iterations 10, the engine's
loop bound) and counts each lane's loop trips with the plain version at
float32 on the same inputs (a per-lane trip counter; the detector's own
count, the kernel's last output, is not the trip count: trialmode
resets it when F drops). It prints, per detector, the trip histogram,
the mean over 32-lane warps of the slowest lane's trips with the lanes
as they are and sorted by their trips, and the times, in turns
(probes' order, then reversed; CUDA events, best of 3 after a warm-up),
of the one-launch form on the sorted statistics and on the original
ones and, under trialmode, of the two compactions kept in the patched
copy probes/csrc/core_compact.cu (which includes csrc/spectral_core.cu):
the two-phase form on the original ones (with each of its kernels'
device time from torch.profiler) and the block-local one (each block's
unfinished lanes finished by its first threads).
A warp of sorted lanes runs as many trips as its slowest lane, and
nearly every warp's lanes then agree: the sorted time is what a perfect
compaction could reach with its packing free. The sorted outputs,
permuted back, and the two-phase outputs must equal the unsorted ones
bit for bit (each lane's loop is its own).

The SASS instructions of one trip (probes/variants.py sass_counts: the
body of the kernel's loop) and ptxas's registers of each instance are
printed beside. With --parent DIR (a directory holding an earlier
csrc/'s spectral_core.cu, spectral_device.cuh, detectors.cuh,
fused_whole.cu, fused_nl_loop.cu, fused_nl_loop.cuh, vb_device.cuh,
dual.cuh, tile.cuh and fused_ar_loop.cu) it also builds the earlier
kernel 2 alone, times it beside this one through its own C entry point,
holds their outputs equal bit for bit, and compares the SASS of kernels
4, 6 and 9 (which keep the runtime detector switch, detectors.cuh
det_test) with the earlier build's. Every figure is printed with the
card's name and power limit; the last line is one JSON object of them.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import variants  # noqa: E402
from whole_stragglers import lane_trips, warp_max_mean  # noqa: E402

NV = 16_777_216
KINDS = ("trialmode", "pointzeroone", "freduce")
# sources whose SASS must not move with detectors.cuh's split (kernels 4,
# 6 and 9 call det_test)
DET_TEST_SOURCES = ("fused_whole.cu", "fused_nl_loop.cu", "fused_ar_loop.cu")


def launch_entry(path, name, p, cap, det, stats, pm, sc, scratch=()):
    """Kernel 2 through the C entry point name of the library at path,
    with fabber_spectral_core's arguments (the earlier build's
    fabber_spectral_core, probes/csrc/core_compact.cu's fabber_core_block)
    and then the device tensors of scratch (fabber_core_two_phase's), on
    the current stream: its seven outputs."""
    import ctypes
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    f = getattr(ctypes.CDLL(str(path)), name)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    f.argtypes = [i32, i32, vp, vp, vp, vp, vp, i32, ctypes.c_float, i32,
                  i32, i32, ctypes.c_longlong] + [vp] * (8 + len(scratch))
    f.restype = i32
    nv = pm.shape[-1]
    outs = [torch.empty(s, device=pm.device) for s in (
        (p, nv), (p, p, nv), (p, p, nv), (1, nv), (1, nv), (1, nv), (1, nv))]
    err = f(p, cap, *(x.data_ptr() for x in (*stats[:3], pm)),
            sc.data_ptr(), *_cuda.detector_args(det), nv,
            *(o.data_ptr() for o in outs),
            *(x.data_ptr() for x in scratch),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    return outs


def kernel_times(fn):
    """{kernel name: device ms} of one call of fn (after a warm-up) from
    torch.profiler, or the error where the profiler shows no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times = {e.key[:60]: e.device_time_total / 1e3
                 for e in prof.key_averages() if e.device_time_total > 0}
        return times or "no device time"
    except Exception as e:    # the profiler may not trace this card
        return f"profiler failed: {e}"


def sass_compare(main, parent):
    """(entries compared, entries whose SASS differs) of the kernels in
    the library parent that main holds too."""
    a, b = variants.sass_text(main), variants.sass_text(parent)
    if a is None or b is None:
        return None
    both = sorted(set(a) & set(b))
    return len(both), [n for n in both if a[n] != b[n]]


def main():
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.ops.spectral import eigen_elbo_const
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier csrc/'s sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    lib = _cuda.build()
    jobs = {"compact": ("core_compact.cu", [], variants.PATCHED)}
    if args.parent:
        for src in ("spectral_core.cu",) + DET_TEST_SOURCES:
            jobs[src] = (src, _cuda.SOURCE_FLAGS.get(src, []), args.parent)
    built = variants.build_all(jobs)
    _cuda.load()
    out = {"card": card, "voxels": NV, "runs": {}, "instances": {}}
    p = 3
    for kind in ("maxits",) + KINDS:
        code = _cuda.DETECTOR_CODES[kind]
        inst = {"registers": cs.ptxas_entry(
            _cuda.build_log, "spectral_core_kernel", f"ILi{p}ELi{code}E")}
        sass = variants.sass_counts(lib, "spectral_core_kernel",
                                    [f"ILi{p}ELi{code}E"])
        if sass is not None:
            inst["sass"] = sass
        out["instances"][kind] = inst
    compact, _, compact_log = built["compact"]
    for name in ("core_block_kernel", "core_phase1_kernel",
                 "core_phase2_kernel"):
        out["instances"][f"trialmode {name}"] = {
            "registers": cs.ptxas_entry(compact_log, name, f"ILi{p}ELi3E"),
            "sass": variants.sass_counts(compact, name, [f"ILi{p}ELi3E"])}
    if "spectral_core.cu" in built:
        path, secs, log = built["spectral_core.cu"]
        for det in (0, 1):
            out["instances"][f"parent_DET{det}"] = {
                "registers": cs.ptxas_entry(log, "spectral_core_kernel",
                                            f"ILi{p}ELb{det}E"),
                "sass": variants.sass_counts(path, "spectral_core_kernel",
                                             [f"ILi{p}ELb{det}E"])}
        for src in DET_TEST_SOURCES:
            out[f"sass_vs_parent_{src}"] = sass_compare(lib, built[src][0])
    for k, v in out["instances"].items():
        print(k, v, flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 2)
    design = cs.poly_design(p)
    q = np.ones(cs.NT)
    c_post = (cs.NT - 1) * 0.5 + 1e-6
    plane, _ = cs.gen_plane(design, NV, gen, [100.0, 0.5, 0.005], 1.0,
                            "cuda")
    tc = fs.pack_mxu_consts(design, q, cs.NT, torch.float32, "cuda")
    ac = fs.pack_solve_consts(design, q, cs.NT, torch.float32)
    sc = fs.pack_spectral_consts(
        design, q, cs.NT, np.full(p, 1e-12), 1e-6, c_post, 1e-8, 50.0,
        torch.float32, (eigen_elbo_const(q, c_post, 1e-6, 1e6, p),
                        c_post + 0.5))
    stats = fs.spectral_stats(plane, tc, ac)
    del plane
    pm = torch.zeros((p, NV), dtype=torch.float32, device="cuda")
    for kind in KINDS:
        det = cs.make_detector(kind)
        cap = int(det.max_iterations) + 2
        counter = lane_trips(det)
        fs.spectral_core_plain(*stats, pm, sc, cap, counter)
        trips = counter.trips
        torch.cuda.empty_cache()
        perm = torch.argsort(trips, stable=True)
        sstats = tuple(x.index_select(1, perm) for x in stats)
        spm = pm.index_select(1, perm)
        run = {"trips": cs.its_histogram(trips.cpu().numpy()),
               "trips_mean": float(trips.double().mean()),
               "trips_warp_slowest_mean": warp_max_mean(trips),
               "trips_warp_slowest_mean_sorted": warp_max_mean(trips[perm])}
        runs = {"unsorted": lambda: fs.spectral_core(
                    *stats, pm, sc, cap, det),
                "sorted": lambda: fs.spectral_core(
                    *sstats, spm, sc, cap, det)}
        if kind == "trialmode":
            # core_compact.cu's state layout: [4P+5, V] floats, [5, V]
            # ints, the count
            scratch = (torch.empty((4 * p + 5, NV), device="cuda"),
                       torch.empty((5, NV), dtype=torch.int32,
                                   device="cuda"),
                       torch.empty(1, dtype=torch.int32, device="cuda"))
            runs["two_phase"] = lambda: launch_entry(
                compact, "fabber_core_two_phase", p, cap, det, stats, pm,
                sc, scratch)
            runs["block"] = lambda: launch_entry(
                compact, "fabber_core_block", p, cap, det, stats, pm, sc)
            run["two_phase_kernels_ms"] = kernel_times(runs["two_phase"])
        if "spectral_core.cu" in built:
            runs["parent"] = lambda: launch_entry(
                built["spectral_core.cu"][0], "fabber_spectral_core", p, cap,
                det, stats, pm, sc)
        t = cs.time_turns(runs)
        back = [torch.empty_like(x) for x in t["sorted"][1]]
        for b, x in zip(back, t["sorted"][1]):
            b[..., perm] = x
        run["its"] = cs.its_histogram(t["unsorted"][1][6][0].cpu().numpy())
        for n in runs:
            run[f"{n}_ms"] = t[n][0]
        run["gain"] = 1 - run["sorted_ms"] / run["unsorted_ms"]
        run["sorted_back_bits_equal"] = cs.bits_equal(back,
                                                      t["unsorted"][1])
        for n in ("two_phase", "block", "parent"):
            if n in runs:
                run[f"{n}_bits_equal"] = cs.bits_equal(t[n][1],
                                                       t["unsorted"][1])
        del back, t
        out["runs"][kind] = run
        print(kind, run, f"[{card}]", flush=True)
        del sstats, spm, trips, perm
        torch.cuda.empty_cache()
    ok = all(r["sorted_back_bits_equal"] and r.get("parent_bits_equal", True)
             and r.get("two_phase_bits_equal", True)
             and r.get("block_bits_equal", True)
             for r in out["runs"].values())
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
