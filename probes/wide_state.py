#!/usr/bin/env python3
"""Kernel 4 past P = 8: a lane's state in registers (spilled to local
memory) or in shared memory, on one NVIDIA GPU.

Run from the repository root:

    python3 probes/wide_state.py

For (P, Q) = (12, 2) and (16, 1) it builds probes/csrc/fused_whole_smem.cu
with FABBER_INST_P, FABBER_INST_Q (probes/variants.py build): the
per-shape instance of csrc/fused_whole.cu as the port builds it
(fabber_inst_fused_whole: the states in registers, ptxas spilling the
rest to local memory) and, in the same library, fabber_probe_whole_smem
(each lane's states st, nx and MODE 2's best in the block's shared
memory at an odd stride; staged in blocks of 32 lanes). Then, on
chip_smoke.py phase 5j's inputs (4,194,304 voxels, T=106, a cosine
design, maxits, 10 iterations), it times both in turns (registers,
shared, shared, registers; CUDA events, best of 3 after a warm-up), both
in the staged form at 32 lanes a block, compares their outputs bit for
bit (the same arithmetic) and prints ptxas's registers and spills of
both entries. Every figure is printed with
the card's name and power limit; the last line is one JSON object (also
chiprun_out/wide_state.json).
"""

import ctypes
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import variants  # noqa: E402

SHAPES = ((12, 2), (16, 1))
NV = 4_194_304
VB = 32


def main():
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(card)
    jobs = {s: ("fused_whole_smem.cu", [f"-DFABBER_INST_P={s[0]}",
                                        f"-DFABBER_INST_Q={s[1]}"],
                variants.PATCHED) for s in SHAPES}
    built = variants.build_all(jobs)
    _cuda.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 47)
    out = {"card": card}
    ok = True
    for (p, nq), (path, secs, log) in built.items():
        lib = ctypes.CDLL(str(path))
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float)
        args = [i32, i32, i32, f32, vp, i32, f32, i32, i32, i32, vp, vp, vp,
                i32, vp, vp, i64] + [vp] * 7 + [i32, vp, vp]
        for name in ("fabber_inst_fused_whole", "fabber_probe_whole_smem"):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i32
        design = cs.cosine_design(p)
        plane = cs.pattern_plane(design, nq, NV, gen, "cuda", (1.0,) * p)
        data, tc, consts, pm, pp = cs.whole_inputs(
            design, cs.group_masks(nq), plane, "cuda")
        del plane
        dtqd = consts[:nq * p * p].cuda()

        def run(name):
            outs = [torch.empty(s, device="cuda") for s in (
                (p, NV), (p, p, NV), (p, p, NV), (nq, NV), (nq, NV),
                (nq, NV), (nq, NV))]
            err = getattr(lib, name)(
                p, nq, cs.ITERS, -1.0, consts.data_ptr(),
                *_cuda.detector_args(None), 0, data.data_ptr(),
                tc.data_ptr(), cs.NT, pm.data_ptr(), pp.data_ptr(), NV,
                *(o.data_ptr() for o in outs), VB, dtqd.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return outs
        t = {"registers": [], "shared": []}
        res = {}
        for who in ("registers", "shared", "shared", "registers"):
            name = ("fabber_inst_fused_whole" if who == "registers"
                    else "fabber_probe_whole_smem")
            ms, res[who] = cs.best_ms(lambda: run(name), keep=True)
            t[who].append(ms)
        same = cs.bits_equal(res["registers"], res["shared"])
        ok &= same
        ptx = {"registers": cs.ptxas_entry(log, "fused_whole_wide_kernel",
                                           f"ILi{p}ELi{nq}ELi0ELb1E"),
               "shared": cs.ptxas_entry(log, "fused_whole_smem_kernel",
                                        f"ILi{p}ELi{nq}ELi0E")}
        key = f"P={p} Q={nq}"
        out[key] = {"registers_ms": t["registers"], "shared_ms": t["shared"],
                    "bits_equal": same, "ptxas": ptx, "nvcc_s": secs}
        cs.log(f" kernel 4 {key} maxits, staged VB {VB}, {NV} voxels: "
               f"registers {t['registers']!r} ms ({ptx['registers']}), "
               f"shared {t['shared']!r} ms ({ptx['shared']}); outputs "
               f"{'equal' if same else 'DIFFER'} bit for bit; nvcc "
               f"{secs:.1f} s  [{card}]")
        del data, tc, pm, pp, dtqd, res
        torch.cuda.empty_cache()
    line = json.dumps(out)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/wide_state.json").write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
