#!/usr/bin/env python3
"""Kernels 7 and 8 with functors generated from a model's time_signal,
and what moving them into headers did to the hand-written instances, on
one NVIDIA GPU.

Run from the repository root:

    python3 probes/generated_kernels.py [--parent DIR]

It builds the kernel library (ops/_cuda.py build) and, in parallel,
kernels 7 and 8 with the functor generated from the torch myexp
plugin's time_signal (num-exps 2: biexp's signal; ops/_cuda.py
build_generated), then prints ptxas's registers and spills of every
generated instance and launches each once at 65,536 biexp voxels
(chip_smoke.py's plane, T=100): kernel 7 with and without its LM branch
and kernel 8 fresh (Levenberg and Marquardt), each against the
hand-written ExpSum<2> instance on the same inputs (the largest
difference over each output's max; the two functors round their
Jacobians differently) and its streamed form against its staged one
(bit for bit), and kernel 8's phase 1 + resume against its fresh launch
(bit for bit).

With --parent DIR (a directory holding an earlier csrc/'s
fused_vb_iter.cu, fused_nlls.cu, vb_device.cuh, tile.cuh and dual.cuh)
it also builds the earlier kernels 7 and 8 alone (probes/variants.py,
with their SOURCE_FLAGS) and compares the SASS of every kernel 7 and 8
entry the two builds share (cuobjdump; addresses, labels and the
anonymous namespace's path hash dropped): the hand-written instances
must not move. Every figure is printed with the card's name and power
limit; the last line is one JSON object of them (also written to
chiprun_out/generated_kernels.json).
"""

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import variants  # noqa: E402

NV = 65_536


def sass_compare(main, parent):
    """(entries compared, entries whose SASS differs) of the kernels in
    the library parent that main holds too."""
    a, b = variants.sass_text(main), variants.sass_text(parent)
    if a is None or b is None:
        return None
    both = sorted(set(a) & set(b))
    return len(both), [n for n in both if a[n] != b[n]]


def rel_diff(a, b):
    return max(float((x.double() - y.double()).abs().max()
                     / y.double().abs().max().clamp_min(1e-30))
               for x, y in zip(a, b) if x is not None)


def main():
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_vb as fv
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier csrc/'s sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    out = {"card": card}
    functors = [f for f in cs.kernel_functors() if f[2] == 4]
    jobs = {}
    if args.parent:
        for src in ("fused_vb_iter.cu", "fused_nlls.cu"):
            jobs[src] = (src, _cuda.SOURCE_FLAGS.get(src, []), args.parent)
    with ThreadPoolExecutor(len(functors) + 2) as pool:
        lib = pool.submit(_cuda.build)
        gens = [pool.submit(_cuda.build_generated, tle.source, p, q, kernel)
                for _, tle, p, q, kernel in functors]
        parents = pool.submit(variants.build_all, jobs) if jobs else None
        path = lib.result()
        for g in gens:
            g.result()
        built = parents.result() if parents else {}
    _cuda.load()
    for name, tle, p, q, kernel in functors:
        secs, text = _cuda.gen_build_log[_cuda.generated_key(
            tle.source, p, q, kernel)]
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        out[f"{kernel}_build_s"] = secs
        out[f"{kernel}_ptxas"] = regs
        print(f"{name}: nvcc {secs:.1f} s", flush=True)
        for ln in regs:
            print(f"  ptxas: {ln}", flush=True)
    for src, (ppath, secs, _) in built.items():
        res = sass_compare(path, ppath)
        out[f"sass_vs_parent_{src}"] = res
        print(f"SASS of {src}'s kernels against the parent's: "
              f"{res[0] if res else '?'} entries compared, differing: "
              f"{res[1] if res else 'cuobjdump missing'}", flush=True)

    device = "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(cs.SEED + 30)
    plane, _, truth = cs.biexp_plane(NV, gen, device)
    eng = cs.myexp_engine(plane, device)
    ref = cs.nl_engine("biexp", "1", plane, device)
    tr = eng._transforms()
    a = eng.nl_loop_args(eng.initial_state())
    phi = torch.full((1, NV), 1.0 / cs.BI_SD ** 2, device=device)
    alpha = torch.full((NV,), 1e-3, device=device)
    alpha[::4] = 0.0
    it = (torch.log(truth).contiguous(), a[1], a[2], phi, a[3], a[4], True)
    for lm in (False, True):
        extra = (alpha,) if lm else ()
        k = fv.fused_iteration(eng.model, tr, *it, *extra,
                               functor=eng.functor)
        ks = fv.fused_iteration(eng.model, tr, *it, *extra,
                                functor=eng.functor, _vb=0)
        h = fv.fused_iteration(ref.model, tr, *it, *extra)
        torch.cuda.synchronize()
        out[f"vb_iter_lm{int(lm)}_vs_expsum"] = rel_diff(k, h)
        out[f"vb_iter_lm{int(lm)}_staged_bits_equal_streamed"] = \
            cs.bits_equal(k, ks)
    neng = cs.nlls_engine(plane, device, {"num-exps": "2"}, "myexp")
    nref = cs.nlls_engine(plane, device)
    p0 = neng.initial_means()
    for lm in (False, True):
        nargs = (neng.tmask_host, neng.max_its, lm)
        k = fn.fused_nlls_loop(neng.model, tr, p0, plane, *nargs,
                               functor=neng.functor)
        ks = fn.fused_nlls_loop(neng.model, tr, p0, plane, *nargs,
                                functor=neng.functor, _vb=0)
        h = fn.fused_nlls_loop(nref.model, tr, p0, plane, *nargs)
        neng.marquardt = lm
        s, prec, cov = neng._solve_kernel(p0)
        torch.cuda.synchronize()
        tag = "lm" if lm else "l"
        out[f"nlls_{tag}_its_equal_expsum"] = float(
            (k[2] == h[2]).double().mean())
        out[f"nlls_{tag}_staged_bits_equal_streamed"] = cs.bits_equal(k, ks)
        out[f"nlls_{tag}_two_phase_bits_equal_fresh"] = cs.bits_equal(
            (s.params, s.cost, prec, cov), (k[0], k[1], k[3], k[4]))
        same = k[2] == h[2]
        out[f"nlls_{tag}_vs_expsum_same_its"] = rel_diff(
            (k[0][:, same], k[1][same]), (h[0][:, same], h[1][same]))
    for key, v in out.items():
        if key != "card":
            print(f" {key} = {v!r}  [{card}]", flush=True)
    dest = Path(__file__).resolve().parents[1] / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "generated_kernels.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
