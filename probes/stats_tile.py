#!/usr/bin/env python3
"""Kernel 1 (csrc/spectral_stats.cu) staged at each block width, on
aligned, misaligned and ragged planes, beside its earlier staged builds
and its streamed form, on one NVIDIA GPU.

Run from the repository root:

    python3 probes/stats_tile.py [--parent DIR]

On chip_smoke.py phase 5's poly plane (16,777,216 voxels, T=106, P=3,
its seed) it times kernel 1 staged (16-byte tile copies, each row
rotated by its offset from 16-byte alignment) at VB = 128 (the plan),
64, 32 and 256; at VB 128 also on the same plane 4 bytes off 16-byte
alignment and on a ragged plane of 16,777,213 voxels; streamed; and
three builds of probes/csrc/spectral_stats.cu, the staged form as it
was measured before the rotation (probes/variants.py): its default
(16-byte copies only on an aligned plane with V a multiple of 4, else
one float a lane: "early16" on the plane, "early4" off alignment),
-DFABBER_STATS_BULK (the tile's rows by the copy engine,
cp.async.bulk) at VB 128, 64 and 32, and -DFABBER_STATS_ROWS4 (the
design rows interleaved per sample, read as 16-byte loads) at VB 128
and 32; all in two rounds of turns (in order, then reversed; CUDA
events, best of 3 after a warm-up each), beside a device-to-device copy
of the plane (the copy rate). For each form: its blocks per SM
(fabber_stats_occupancy of its build), ptxas's registers and spills,
and whether its outputs equal the streamed form's on the same plane bit
for bit. With --parent DIR (an earlier commit's spectral_fused.cu and
spectral_device.cuh), kernel 3 built from DIR and from csrc/ with the
same flags, compared instruction by instruction in its SASS
(cuobjdump): the one-kernel form runs stats_voxel streamed and should
compile to the code it compiled to before. The last line is one JSON
object of those figures.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
import variants  # noqa: E402

NV = 16_777_216
SOURCE = "spectral_stats.cu"
NAMES = ("fabber_spectral_stats", "fabber_stats_occupancy")
BUILDS = {"early": [], "bulk": ["-DFABBER_STATS_BULK"],
          "rows4": ["-DFABBER_STATS_ROWS4"]}


def main():
    import numpy as np
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    _cuda.load()
    jobs = {k: (SOURCE, f, variants.PATCHED) for k, f in BUILDS.items()}
    if "--parent" in sys.argv:
        parent = sys.argv[sys.argv.index("--parent") + 1]
        jobs["kernel3_parent"] = ("spectral_fused.cu", [], parent)
        jobs["kernel3"] = ("spectral_fused.cu", [])
    built = variants.build_all(jobs)
    out = {"card": card, "voxels": NV, "nt": cs.NT, "forms": {}}
    if "kernel3" in built:
        a = variants.sass_text(built.pop("kernel3_parent")[0])
        b = variants.sass_text(built.pop("kernel3")[0])
        out["kernel3_sass"] = None if a is None else {
            "entries": len(b), "identical": a == b,
            "differ": sorted(k for k in set(a) | set(b)
                             if a.get(k) != b.get(k))}
        print("kernel 3 SASS against the parent's:", out["kernel3_sass"],
              flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 2)
    design = cs.poly_design(3)
    plane, _ = cs.gen_plane(design, NV, gen, [100.0, 0.5, 0.005], 1.0,
                            "cuda")
    # the same plane 4 bytes off 16-byte alignment, and a ragged one
    buf = torch.empty(plane.numel() + 1, device="cuda")
    off = buf[1:].view(plane.shape)
    off.copy_(plane)
    planes = {"aligned": plane, "off4": off,
              "ragged": plane[:, :NV - 3].contiguous()}
    q = np.ones(cs.NT)
    tc = fs.pack_mxu_consts(design, q, cs.NT, torch.float32, "cuda")
    ac = fs.pack_solve_consts(design, q, cs.NT, torch.float32)

    # form name -> (build or None for the main library, vb, plane)
    forms = {}
    for vb in (128, 64, 32, 256):
        forms[f"rotated_vb{vb}"] = (None, vb, "aligned")
    forms["rotated_vb128_off4"] = (None, 128, "off4")
    forms["rotated_vb128_ragged"] = (None, 128, "ragged")
    forms["streamed"] = (None, 0, "aligned")
    forms["streamed_ragged"] = (None, 0, "ragged")
    forms["early16_vb128"] = ("early", 128, "aligned")
    forms["early4_vb128"] = ("early", 128, "off4")
    for vb in (128, 64, 32):
        forms[f"bulk_vb{vb}"] = ("bulk", vb, "aligned")
    for vb in (128, 32):
        forms[f"rows4_vb{vb}"] = ("rows4", vb, "aligned")

    def use(build):
        if build is None:
            variants.restore()
        else:
            variants.swap(built[build][0], NAMES)

    refs = {k: fs.spectral_stats(x, tc, ac, _vb=0)
            for k, x in planes.items()}
    for form, (build, vb, pl) in forms.items():
        use(build)
        got = fs.spectral_stats(planes[pl], tc, ac, _vb=vb)
        log = _cuda.build_log if build is None else built[build][2]
        out["forms"][form] = {
            "plane": pl,
            "bits_equal_streamed": cs.bits_equal(got, refs[pl]),
            "blocks_per_sm": _cuda.stats_occupancy(3, vb, cs.NT),
            "ptxas": cs.ptxas_entry(log, "spectral_stats_kernel",
                                    f"ILi3ELb{int(vb > 0)}E"),
            "ms": float("inf")}
        del got
    del refs
    torch.cuda.empty_cache()
    order = list(forms)
    for rnd in (order, order[::-1]):
        for form in rnd:
            build, vb, pl = forms[form]
            use(build)
            x = planes[pl]
            ms = cs.best_ms(lambda: fs.spectral_stats(x, tc, ac, _vb=vb))
            out["forms"][form]["ms"] = min(out["forms"][form]["ms"], ms)
    variants.restore()
    del off, buf, planes
    torch.cuda.empty_cache()
    dst = torch.empty_like(plane)
    out["copy_ms"] = cs.best_ms(lambda: dst.copy_(plane))
    out["copy_GBps"] = 2 * plane.numel() * 4 / out["copy_ms"] / 1e6
    out["plane_at_copy_rate_ms"] = out["copy_ms"] / 2
    for form, info in out["forms"].items():
        print(form, info, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
