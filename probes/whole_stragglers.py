#!/usr/bin/env python3
"""How much kernel 4 (csrc/fused_whole.cu) loses to stragglers under
trialmode, on one NVIDIA GPU: the most a compaction of its lanes could
give.

Run from the repository root:

    python3 probes/whole_stragglers.py

On chip_smoke.py phase 5d's plane (16,777,216 poly voxels, T=106, P=3,
the noise pattern 12, the same seed) it launches kernel 4's MODE 2 under
trialmode (max-iterations 10, the engine's loop cap) in the plan's form
and reads each lane's iteration count from the kernel's last output
(ftr: the detector's count, which trialmode resets to 1 when F drops
and the lane enters its trials). The loop trips a lane makes are not
that count, so the probe also runs the plain version at float32 on the
same inputs with a per-lane trip counter (its decisions are the
kernel's on all but a few lanes in a thousand, chip_smoke.py phase 3d).
It then permutes the lanes by their trips (a stable argsort: the
plane's columns and the priors' lanes) and times the kernel on the
sorted plane beside the original one, in turns (unsorted, sorted,
sorted, unsorted; CUDA events, best of 3 after a warm-up), in both of
its forms. A warp of sorted lanes runs as many iterations as its
slowest lane, and nearly every warp's lanes then agree: the sorted
time is what a perfect compaction (phase 1, sort, resume) could reach
with its sort and gathers free. The sorted outputs, permuted back,
must equal the unsorted ones bit for bit (each lane's loop is its own).
lm at Q=1 (its detector counts are 6 or 7 on every lane) is timed the
same way beside it. The histograms, the mean over warps of the
slowest lane's count (unsorted and sorted), the times and the gain
(1 - sorted / unsorted) are printed with the card's name and power
limit (trips_* are loop trips, its the detector's count); the last
line is one JSON object of them.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

NV = 16_777_216


class LaneTrips:
    """A detector that the plain version takes in place of det (it reads
    the kind from the class's name), counting each lane's loop trips:
    one per test while the lane is not done."""

    def __init__(self, det):
        self.det = det
        self.trips = None

    def __getattr__(self, name):
        return getattr(self.det, name)

    def test(self, state, f):
        t = (~state.done).int()
        self.trips = t if self.trips is None else self.trips + t
        return self.det.test(state, f)


def lane_trips(det):
    cls = type("Trips" + type(det).__name__, (LaneTrips,),
               {"name": type(det).name})
    return cls(det)


def warp_max_mean(its):
    """Mean over 32-lane warps of the slowest lane's iteration count."""
    n = its.numel() // 32 * 32
    return float(its[:n].reshape(-1, 32).amax(dim=1).double().mean())


def main():
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_whole as fw
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    _cuda.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 13)
    p, design = 3, cs.poly_design(3)
    plane = cs.pattern_plane(design, 2, NV, gen, "cuda")
    out = {"card": card, "voxels": NV, "runs": {}}
    for kind, nq in (("trialmode", 2), ("lm", 1)):
        data, tc, consts, pm, pp = cs.whole_inputs(design, cs.group_masks(nq),
                                                   plane, "cuda")
        det, cap = cs.whole_detector(kind, p, nq)
        k = fw.fused_whole(data, tc, consts, pm, pp, cap, -1.0, det)
        its = k[6][0].to(torch.int32)
        del k
        counter = lane_trips(det["det"])
        fw.fused_whole_plain(data, tc, consts, pm, pp, cap, -1.0,
                             {**det, "det": counter})
        trips = counter.trips
        torch.cuda.empty_cache()
        perm = torch.argsort(trips, stable=True)
        sdata = data.index_select(1, perm)
        spm, spp = pm.index_select(1, perm), pp.index_select(1, perm)
        run = {"its": cs.its_histogram(its.cpu().numpy()),
               "trips": cs.its_histogram(trips.cpu().numpy()),
               "trips_warp_slowest_mean": warp_max_mean(trips),
               "trips_warp_slowest_mean_sorted": warp_max_mean(trips[perm]),
               "trips_mean": float(trips.double().mean())}
        for vb, form in ((None, "staged"), (0, "streamed")):
            t = {"unsorted": [], "sorted": []}
            res = {}
            for order in ("unsorted", "sorted", "sorted", "unsorted"):
                args = (data, tc, consts, pm, pp) if order == "unsorted" \
                    else (sdata, tc, consts, spm, spp)
                ms, res[order] = cs.best_ms(lambda: fw.fused_whole(
                    *args, cap, -1.0, det, _vb=vb), keep=True)
                t[order].append(ms)
            back = [torch.empty_like(x) for x in res["sorted"]]
            for b, x in zip(back, res["sorted"]):
                b[..., perm] = x
            run[form] = {
                "unsorted_ms": min(t["unsorted"]),
                "sorted_ms": min(t["sorted"]),
                "gain": 1 - min(t["sorted"]) / min(t["unsorted"]),
                "sorted_back_bits_equal": cs.bits_equal(back,
                                                        res["unsorted"])}
            del res, back
            torch.cuda.empty_cache()
        out["runs"][f"{kind}_q{nq}"] = run
        print(kind, nq, run, flush=True)
        del data, sdata, pm, pp, spm, spp, its, trips, perm
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
