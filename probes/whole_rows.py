#!/usr/bin/env python3
"""Where kernel 4's staged form (csrc/fused_whole.cu) keeps its design
rows, on one NVIDIA GPU: in shared memory beside the data tile (the
build as it is) or in __constant__ memory (-DFABBER_WHOLE_CONST_ROWS,
the tile alone in shared memory).

Run from the repository root:

    python3 probes/whole_rows.py

Each one-warp block copies the (P + QP + Q) x T rows beside its tile;
in __constant__ memory every lane of a warp reads the same rows[t] (a
broadcast) and the block holds less shared memory, so more blocks fit an
SM. The probe builds the kernel library twice from csrc/ and, on
chip_smoke.py phase 5d's plane (16,777,216 poly voxels, T=106, P=3, the
same seed), times kernel 4's staged form in turns (shared, constant,
constant, shared; CUDA events, best of 3 after a warm-up) in maxits at
Q=1 and Q=2, trialmode at Q=2 and lm at Q=1, with each build's blocks
per SM, and whether the two builds' outputs agree bit for bit. The last
line is one JSON object of those figures.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

NV = 16_777_216
SOURCE = "fused_whole.cu"


def use_build(const_rows):
    """Load the kernel library built with the rows in shared memory or
    (const_rows) in __constant__ memory."""
    from fabber_core_tpu_torch.ops import _cuda
    flags = dict(_cuda.SOURCE_FLAGS)
    flags.pop(SOURCE, None)
    if const_rows:
        flags[SOURCE] = ["-DFABBER_WHOLE_CONST_ROWS"]
    _cuda.SOURCE_FLAGS = flags
    _cuda._lib = None
    _cuda.load()
    return str(_cuda.library_path().name)


def main():
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_whole as fw
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    libs = {False: use_build(False), True: use_build(True)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 13)
    p, design = 3, cs.poly_design(3)
    plane = cs.pattern_plane(design, 2, NV, gen, "cuda")
    out = {"card": card, "voxels": NV, "libraries": libs, "runs": []}
    for kind, nq in ((None, 1), (None, 2), ("trialmode", 2), ("lm", 1)):
        args = cs.whole_inputs(design, cs.group_masks(nq), plane, "cuda")
        det, cap = (None, cs.ITERS) if kind is None \
            else cs.whole_detector(kind, p, nq)
        mode = 0 if kind is None else 2
        run = {"kind": kind or "maxits", "nq": nq}
        t, res = {False: [], True: []}, {}
        for const_rows in (False, True, True, False):
            use_build(const_rows)
            ms, res[const_rows] = cs.best_ms(lambda: fw.fused_whole(
                *args, cap, -1.0, det, _vb=32), keep=True)
            t[const_rows].append(ms)
            run[f"{'constant' if const_rows else 'shared'}_blocks_per_sm"] = \
                _cuda.whole_occupancy(p, nq, mode, 32, cs.NT)
        run["shared_ms"] = min(t[False])
        run["constant_ms"] = min(t[True])
        run["bits_equal"] = cs.bits_equal(res[False], res[True])
        out["runs"].append(run)
        print(run, flush=True)
        del res, args
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
