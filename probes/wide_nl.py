#!/usr/bin/env python3
"""The nonlinear per-shape instances (kernels 6, 7 and 8 past P = 8 and Q =
4) on one NVIDIA GPU, without the rest of chip_smoke.py.

Run from the repository root:

    python3 probes/wide_nl.py [--phases 3k,4aa,5k] [--rolled] [--flags]
                              [--rolled-times]

Builds the kernel library, chip_smoke.py's NL_INSTANCE_SHAPES (ops/_cuda.py
build_instance "nl") and the functors generated from myexp's time_signal at
num-exps 6 (P = 12) for kernels 6, 7 and 8, all together, and logs each
build's nvcc seconds and ptxas lines; then runs the chosen phases of
chip_smoke.py (3k: the instances against their plain versions at
float64; 4aa: run_with_data on them; 5k: their times at 4,000,000
voxels), each on its own, a failure logged with its traceback. With
--rolled it also builds an unrolled exp num-exps 8 (P = 16, the largest
P ops/_cuda.py rolled_loops leaves unrolled; its nvcc seconds logged) and
exp num-exps 5 (P = 10) with FABBER_ROLL_LOOPS (roll_turns:
the two builds' kernel 6 outputs in every MODE compared, and kernels 6,
7 and 8 timed with both in turns on 4,000,000 voxels; CUDA events, best
of 3 after a warm-up). With --flags it builds the rolled P = 10 unit
under other nvcc flags and holds each one's kernel 6 trialmode outputs
against the unrolled build's, and kernel 7 at P = 24, Q = 4 (its folded
form) rolled under the same flags against its plain version
(flag_variants). With --rolled-times it times the rolled units of
NL_INSTANCE_SHAPES (P = 24 at Q = 4, P = 40) against their plain versions
at up to 1,048,576 voxels (rolled_times).

Every figure is printed with the card's name and power limit; the last
line is one JSON object of them (also written to
chiprun_out/wide_nl.json).
"""

import argparse
import json
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

NV = 4_000_000


def build(card, extra=()):
    """The library, the per-shape instances (and extra shapes) and myexp's
    P = 12 functors, built together; their seconds and ptxas lines
    logged."""
    from fabber_core_tpu_torch.ops import _cuda
    functors = cs.kernel_functors(wide=True)
    shapes = cs.NL_INSTANCE_SHAPES + tuple(extra)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(functors) + 2) as pool:
        lib = pool.submit(_cuda.build)
        inst = pool.submit(_cuda.build_instances, shapes, False)
        gens = [pool.submit(_cuda.build_generated, tle.source, p, q, kernel)
                for _, tle, p, q, kernel in functors]
        lib.result()
        inst.result()
        for g in gens:
            g.result()
    secs = time.perf_counter() - t0
    cs.log(f"built in {secs:.1f} s  [{card}]")
    cs.log_instance_builds(card, shapes)
    for name, tle, p, q, kernel in functors:
        gsecs, text = _cuda.gen_build_log.get(
            _cuda.generated_key(tle.source, p, q, kernel),
            (float("nan"), ""))
        cs.log(f"  generated {name} (P={p}, Q={q}): nvcc {gsecs:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  ptxas ({name}): {line.strip()}")
    _cuda.load()
    return secs


def roll_turns(card):
    """exp num-exps 5 (P = 10) from its default build (unrolled) and from
    one built with FABBER_ROLL_LOOPS: kernel 6 in MODEs 0, 1 and 2
    (maxits, pointzeroone, trialmode; 1 and 3 iterations) on 65,536
    voxels, each output's largest difference between the two builds and
    the non-finite count of each; then kernels 6, 7 and 8 timed in turns
    (unrolled, rolled, rolled, unrolled) at 4,000,000 voxels."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import smallmat as sm
    shape = ("nl", 10, 1, 1)
    default = _cuda._roll_define

    def rolled(p, q):
        return "#define FABBER_ROLL_LOOPS\n"

    def with_build(form, fn_):
        if form == "rolled":
            _cuda._roll_define = rolled
        try:
            return fn_()
        finally:
            _cuda._roll_define = default
    t0 = time.perf_counter()
    text = with_build("rolled", lambda: (
        _cuda.build_instance(*shape),
        _cuda.inst_build_log[_cuda.instance_key(*shape)][1])[1])
    cs.log(f"rolled ExpSum<5> built in {time.perf_counter() - t0:.1f} s "
           f" [{card}]")
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "== " in line:
            cs.log(f"  rolled: {line.strip()}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 56)
    out = {}
    small = 65_536
    data, _, truth = cs.multiexp_plane(5, small, gen, "cuda")
    for kind in ("maxits", "pointzeroone", "trialmode"):
        extra = {} if kind == "maxits" else {
            "convergence": kind, "max-iterations": "3", "max-trials": "2"}
        eng = cs.wide_nl_engine("exp", 5, data, "cuda", extra)
        tr = eng._transforms()
        s0 = eng.initial_state()
        args = eng.nl_loop_args(s0)
        kw = {} if kind == "maxits" else dict(
            detector=eng._nl_fdet_consts(),
            post_var0=sm.diag_of(s0.post.cov).contiguous())
        for its in (1, 3):
            res = {f: with_build(f, lambda: fnl.fused_nl_loop(
                eng.model, tr, *args, its, True, **kw))
                for f in ("unrolled", "rolled")}
            torch.cuda.synchronize()
            diffs = [float((a.double() - b.double()).abs().nan_to_num(
                nan=float("inf")).max()) for a, b in zip(res["unrolled"],
                                                          res["rolled"])]
            bad = {f: [int((~torch.isfinite(o)).sum()) for o in r]
                   for f, r in res.items()}
            out[f"{kind}_{its}"] = {"max_diff": diffs, "nonfinite": bad}
            cs.log(f" kernel 6 {kind} {its} its: max |unrolled - rolled| "
                   f"per output {diffs}; non-finite {bad}  [{card}]")
    del data, truth
    torch.cuda.empty_cache()
    data, _, truth = cs.multiexp_plane(5, NV, gen, "cuda")
    eng = cs.wide_nl_engine("exp", 5, data, "cuda")
    tr = eng._transforms()
    nargs = eng.nl_loop_args(eng.initial_state())
    lat = torch.log(truth).contiguous()
    phi = torch.full((1, NV), 1.0 / cs.BI_SD ** 2, device="cuda")
    neng = cs.nlls_engine(data, "cuda", {"num-exps": "5"}, "exp")
    p0 = neng.initial_means()
    runs = {
        "nl": lambda: fnl.fused_nl_loop(eng.model, tr, *nargs, cs.ITERS,
                                        True),
        "iter": lambda: fv.fused_iteration(
            eng.model, tr, lat, nargs[1], nargs[2], phi, nargs[3],
            nargs[4], True),
        "nlls": lambda: fn.fused_nlls_loop(
            neng.model, tr, p0, data, neng.tmask_host, neng.max_its,
            False)}
    for kname, run in runs.items():
        t = {"unrolled": [], "rolled": []}
        for form in ("unrolled", "rolled", "rolled", "unrolled"):
            ms = with_build(form, lambda: cs.best_ms(run))
            t[form].append(ms)
        out[kname] = t
        cs.log(f" {kname} ExpSum<5> at {NV} voxels: unrolled "
               f"{t['unrolled']} ms, rolled {t['rolled']} ms  [{card}]")
    return out


def rolled_times(card, nv=1_048_576, nv_low=262_144, nv_probe=4_096,
                 budget_ms=10_000.0):
    """The rolled units (ops/_cuda.py rolled_loops, built with ROLL_FLAGS)
    against their plain versions, T=100: kernel 6 maxits (ITERS) and
    kernel 7's folded form with exp num-exps 12 at noise-pattern 1234 (P
    = 24, Q = 4), kernel 7 rolled and kernel 8 fresh Levenberg with exp
    num-exps 20 (P = 40, Q = 1). Each kernel is timed once on nv_probe
    voxels (under one wave of the card), then best of 3 after a warm-up
    on the largest of nv, nv_low and 65,536 voxels to which that time
    scales within budget_ms (else nv_probe again); each plain version
    once on the first min(n, nv_low) voxels, with its kernel once beside
    it there (n: the voxels it was timed on). Bounds as chip_smoke.py phase 5k's (nl_pass_ops, nlls_ops;
    kernel 8 the steps this run's data took)."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_vb as fv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 57)
    out = {}
    nt = cs.BI_NT

    def cut(args, n):
        return tuple(a[..., :n].contiguous() if torch.is_tensor(a)
                     and a.dim() and a.shape[-1] == nv else a for a in args)

    def timed(tag, kernel, plain, args, bound_at):
        probe_ms = cs.once_ms(lambda: kernel(*cut(args, nv_probe)))[0]
        n = next((m for m in (nv, nv_low, 65_536)
                  if probe_ms * m / nv_probe <= budget_ms), nv_probe)
        ms, r = cs.best_ms(lambda: kernel(*cut(args, n)), keep=True)
        out[tag] = {"voxels": n, "ms": ms, "bound": bound_at(n, r)}
        del r
        torch.cuda.empty_cache()
        n_low = min(n, nv_low)
        low = cut(args, n_low)
        out[tag]["low_ms"] = cs.once_ms(lambda: kernel(*low))[0]
        out[tag]["plain_ms"] = cs.once_ms(lambda: plain(*low))[0]
        out[tag]["plain_voxels"] = n_low
        del low
        torch.cuda.empty_cache()
        cs.log(f" {tag}: kernel {ms:.2f} ms at {n} voxels (bound "
               f"{out[tag]['bound'][0]:.3f} ms, {out[tag]['bound'][1]}); at "
               f"{n_low}: kernel {out[tag]['low_ms']:.2f} ms, plain "
               f"{out[tag]['plain_ms']:.2f} ms  [{card}]")

    def nl_bound(p, nq, nexp):
        return lambda n, _: cs.bound(
            4 * nt * n + 4 * (3 * p + nq * p + 2 * p * p + 4 * nq) * n,
            (cs.ITERS * cs.nl_pass_ops(p, nq, nexp, "A") * nt
             + cs.nl_pass_ops(p, nq, nexp, "F") * nt + 200 * cs.ITERS) * n)

    def iter_bound(p, nq, nexp):
        return lambda n, _: cs.bound(
            4 * nt * n + 4 * (3 * p + nq + 4 * nq + 2 * p * p + 4) * n,
            ((cs.nl_pass_ops(p, nq, nexp, "A")
              + cs.nl_pass_ops(p, nq, nexp, "B")
              + cs.nl_pass_ops(p, nq, nexp, "F")) * nt + 400) * n)

    for num, pattern in ((12, "1234"), (20, "1")):
        p, nq = 2 * num, int(pattern[-1])
        data, _, truth = cs.multiexp_plane(num, nv, gen, "cuda")
        eng = cs.nl_case_engine("exp", num, pattern, data, "cuda")
        tr = eng._transforms()
        tsj = fv.signal_jac_fn(eng.model)
        nargs = eng.nl_loop_args(eng.initial_state())
        if num == 12:
            timed(f"nl_p{p}_q{nq}",
                  lambda *a: fnl.fused_nl_loop(eng.model, tr, *a, cs.ITERS,
                                               True),
                  lambda *a: fnl.fused_nl_loop_plain(tsj, tr, *a, cs.ITERS,
                                                     True),
                  nargs, nl_bound(p, nq, num))
        lat = torch.log(truth).contiguous()
        phi = torch.full((nq, nv), 1.0 / cs.BI_SD ** 2, device="cuda")
        timed(f"iter_p{p}_q{nq}",
              lambda *a: fv.fused_iteration(eng.model, tr, *a),
              lambda *a: fv.fused_iteration_plain(tsj, tr, *a),
              (lat, nargs[1], nargs[2], phi, nargs[3], nargs[4], True),
              iter_bound(p, nq, num))
        del eng, nargs, lat, phi
        torch.cuda.empty_cache()
        if num == 20:
            neng = cs.nlls_engine(data, "cuda", {"num-exps": str(num)}, "exp")
            p0 = neng.initial_means()
            largs = (neng.tmask_host, neng.max_its, False)
            ops = cs.nlls_ops(p, num, p, nt, False)

            def nlls_bound(n, r):
                trips = float(r[2].double().sum())
                return cs.bound(
                    4 * (nt + p) * n + 4 * (p + 2 + 2 * p * p) * n,
                    (n + trips) * ops["pass"] + trips * ops["step"]
                    + n * ops["post"])
            timed(f"nlls_p{p}",
                  lambda *a: fn.fused_nlls_loop(neng.model, tr, *a, *largs),
                  lambda *a: fn.fused_nlls_loop_plain(tsj, tr, *a, *largs),
                  (p0, data), nlls_bound)
            del neng, p0
        del data, truth
        torch.cuda.empty_cache()
    return out


def flag_variants(card):
    """exp num-exps 5 (P = 10) rolled under other nvcc flags (none of
    ops/_cuda.py ROLL_FLAGS: the evidence for them; default, -Xptxas
    -O0 and -O1, -Xcicc -O1 and -O2, -G with and without -dopt on), each
    built, run and restored in turn:
    kernel 6 under trialmode (3 iterations, 2 trials) on 65,536 voxels
    against the unrolled default build (non-finite counts, each output's
    largest difference); kernel 7 at exp num-exps 12, noise-pattern 1234
    (P = 24, its folded form) rolled under the same flags against its
    plain version at float32 (non-finite counts per output)."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import smallmat as sm
    default_roll, default_flags = _cuda._roll_define, dict(_cuda.SOURCE_FLAGS)
    default_roll_flags = list(_cuda.ROLL_FLAGS)

    def run_with(roll, flags, fn_):
        # the variants' own flags alone (ROLL_FLAGS left out)
        _cuda.ROLL_FLAGS = []
        _cuda._roll_define = (lambda p, q: "#define FABBER_ROLL_LOOPS\n") \
            if roll else (lambda p, q: "")
        _cuda.SOURCE_FLAGS = {**default_flags, "fused_nl_loop.cu": flags,
                              "fused_vb_iter.cu": flags}
        try:
            return fn_()
        finally:
            _cuda._roll_define = default_roll
            _cuda.SOURCE_FLAGS = dict(default_flags)
            _cuda.ROLL_FLAGS = list(default_roll_flags)
    variants = {"unrolled": (False, []), "rolled": (True, []),
                "rolled ptxas -O1": (True, ["-Xptxas", "-O1"]),
                "rolled ptxas -O0": (True, ["-Xptxas", "-O0"]),
                "rolled cicc -O1": (True, ["-Xcicc", "-O1"]),
                "rolled cicc -O2": (True, ["-Xcicc", "-O2"]),
                "rolled -G -dopt on": (True, ["-G", "-dopt", "on"]),
                "rolled -G": (True, ["-G"])}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 57)
    data, _, truth = cs.multiexp_plane(5, 65_536, gen, "cuda")
    eng = cs.wide_nl_engine("exp", 5, data, "cuda", {
        "convergence": "trialmode", "max-iterations": "3",
        "max-trials": "2"})
    tr = eng._transforms()
    s0 = eng.initial_state()
    args = eng.nl_loop_args(s0)
    kw = dict(detector=eng._nl_fdet_consts(),
              post_var0=sm.diag_of(s0.post.cov).contiguous())
    out, res = {}, {}
    shape = ("nl", 10, 1, 1)
    for name, (roll, flags) in variants.items():
        def go():
            key = _cuda.instance_key(*shape)
            t0 = time.perf_counter()
            try:
                _cuda.build_instance(*shape)
            except Exception as e:
                cs.log(f" {name}: the build failed: {str(e)[-600:]}")
                return None
            text = _cuda.inst_build_log[key][1]
            frames = [ln.strip() for ln in text.splitlines()
                      if "stack frame" in ln][:2]
            cs.log(f" {name} (key {key}, {time.perf_counter() - t0:.1f} s):"
                   f" MODE 2 entries {frames}  [{card}]")
            r = fnl.fused_nl_loop(eng.model, tr, *args, 3, True, **kw)
            torch.cuda.synchronize()
            return r
        res[name] = run_with(roll, flags, go)
    for name, r in list(res.items()):
        if r is None:
            del res[name]
            continue
        bad = [int((~torch.isfinite(o)).sum()) for o in r]
        diff = [float((a.double() - b.double()).abs().nan_to_num(
            nan=float("inf")).max()) for a, b in zip(r, res["unrolled"])]
        out[name] = {"nonfinite": bad, "max_diff": diff}
        cs.log(f" kernel 6 trialmode P=10 {name}: non-finite {bad}; max "
               f"|diff| from unrolled {diff}  [{card}]")
    del data, truth, res, eng, args
    torch.cuda.empty_cache()
    data, _, truth = cs.multiexp_plane(12, 65_536, gen, "cuda")
    eng = cs.wide_nl_engine("exp", 12, data, "cuda",
                            {"noise-pattern": "1234"})
    tr = eng._transforms()
    nargs = eng.nl_loop_args(eng.initial_state())
    lat = torch.log(truth) + 0.05 * torch.randn(truth.shape, generator=gen,
                                                device="cuda")
    phi = torch.full((4, 65_536), 1.0 / cs.BI_SD ** 2, device="cuda")
    it_args = (lat, nargs[1], nargs[2], phi, nargs[3], nargs[4], True)
    res = {"plain float32": fv.fused_iteration_plain(
        fv.signal_jac_fn(eng.model), tr, *it_args)}
    for name, (roll, flags) in variants.items():
        if not roll:
            continue

        def go():
            try:
                r = fv.fused_iteration(eng.model, tr, *it_args)
            except Exception as e:
                cs.log(f" {name}: {str(e)[-600:]}")
                return None
            torch.cuda.synchronize()
            return r
        r = run_with(roll, flags, go)
        if r is not None:
            res[name] = r
    for name, r in res.items():
        bad = [int((~torch.isfinite(o)).sum()) for o in r]
        out[f"iter P=24 {name}"] = {"nonfinite": bad}
        cs.log(f" kernel 7 P=24 Q=4 {name}: non-finite per output {bad}"
               f"  [{card}]")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="3k,4aa,5k")
    ap.add_argument("--rolled", action="store_true")
    ap.add_argument("--flags", action="store_true")
    ap.add_argument("--rolled-times", action="store_true")
    args = ap.parse_args()
    card = cs.card_line()
    cs.log(card)
    if args.phases:
        out = {"card": card, "build_s": build(
            card, (("nl", 16, 1, 1),) if args.rolled else ())}
    else:
        from fabber_core_tpu_torch.ops import _cuda
        _cuda.load()
        out = {"card": card}
    ok = True
    steps = {"3k": lambda: cs.check_nl_instances("cuda"),
             "4aa": lambda: cs.run_nl_instance_paths("cuda"),
             "5k": lambda: cs.time_nl_instances("cuda", card)}
    for name in [p for p in args.phases.split(",") if p]:
        cs.log(f"phase {name}")
        try:
            res = steps[name]()
            if name != "5k":
                ok &= bool(res[0])
            out[name] = res
        except Exception:
            ok = False
            cs.log(f"FAILED {name}:\n{traceback.format_exc()}")
        torch.cuda.empty_cache()
    if args.rolled:
        try:
            out["rolled"] = roll_turns(card)
        except Exception:
            ok = False
            cs.log(f"FAILED rolled:\n{traceback.format_exc()}")
    if args.rolled_times:
        try:
            out["rolled_times"] = rolled_times(card)
        except Exception:
            ok = False
            cs.log(f"FAILED rolled times:\n{traceback.format_exc()}")
    if args.flags:
        try:
            out["flags"] = flag_variants(card)
        except Exception:
            ok = False
            cs.log(f"FAILED flags:\n{traceback.format_exc()}")
    out["ok"] = ok
    text = json.dumps(out, default=str)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/wide_nl.json").write_text(text)
    print(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
