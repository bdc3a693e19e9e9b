#!/usr/bin/env python3
"""The nonlinear per-shape instances (kernels 6, 7 and 8 past P = 8 and Q =
4) on one NVIDIA GPU, without the rest of chip_smoke.py.

Run from the repository root:

    python3 probes/wide_nl.py [--phases 3k,4aa,5k] [--rolled]
                              [--rolled-times] [--bisect] [--repair]
                              [--fmad] [--witness] [--lanes] [--spread]
                              [--coop DIR]

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
of 3 after a warm-up). With --rolled-times it times the units past
rolled_loops' sizes (kernel 6 and 8 rolled, kernel 7's cooperative form)
against their plain versions at 262,144 and 1,048,576 voxels
(rolled_times). With --bisect it rolls one group of FABBER_UNROLL sites
at a time in a numbered copy of csrc/ until the sites whose rolled form
breaks kernel 6 under trialmode at P = 10 are found (bisect; kernel 8 at
P = 10 too), and writes the last failing unit and its PTX to
chiprun_out/bisect_*. With --repair it builds that kernel 6 unit rolled
in each code form of REPAIRS and holds it to the unrolled unit (repair).
With --fmad it runs phase 3k's ExpSum<12> case with kernel 6's units as
built and with -fmad=false (fmad_check). --witness, --lanes and --spread
look at the data where phase 3k's trialmode check, holding every lane to
float64, failed (FIRST_LAYOUT): the same unit optimized, with -G, with
-Xcicc -O1 and unrolled (witness), the lanes behind the failure and
their detector tests (lanes), and how far moving the data by one ulp
moves the plain float32 version's reading, with the failing lanes'
conditions (spread).

With --coop DIR (a checkout of an earlier tree, build/parent), kernel 7's
cooperative form (row 7c) at P = 44, 40 and 24 (Q = 4, folded) is timed
against DIR's in turns and profiled by section
(probes/coop_sections.py compare).

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
    shape = ("nl", 10, 1, 1, "nl_loop")
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


def rolled_times(card, nvs=(262_144, 1_048_576), plain_slice=262_144):
    """The units past ops/_cuda.py rolled_loops' sizes, optimized, against
    their plain versions at T=100 on each of nvs voxels: kernel 6 maxits
    (ITERS) with exp num-exps 12 at noise-pattern 1234 (P = 24, Q = 4, its
    loops rolled); kernel 7's cooperative form (one iteration from the
    latent truth) there (folded), at num-exps 20 (P = 40) and 22 (P = 44);
    kernel 8 fresh Levenberg at num-exps 20 (rolled). Each plain version
    once, then its kernel best of 3 after a warm-up (CUDA events), on the
    same voxels; past the card's memory (kernel 7's plain version at P >=
    40 on 1,048,576 voxels) the plain version in slices of plain_slice
    voxels, their times summed; kernel 8 at 1,048,576 once, its plain
    version not (82.7 s at 262,144). Bounds as chip_smoke.py phase 5k's
    (nl_pass_ops, nlls_ops; kernel 8 the steps this run's data took)."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_vb as fv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 57)
    out = {}
    nt = cs.BI_NT

    def timed(tag, n, kernel, plain, bound_at, slices=1, once=False):
        """plain (a function of a voxel slice (start, stop), or None: not
        timed) once over slices slices, then kernel best of 3 (once)."""
        plain_ms = None
        if plain is not None:
            plain_ms = 0.0
            for i in range(slices):
                plain_ms += cs.once_ms(
                    lambda: plain(i * n // slices, (i + 1) * n // slices))[0]
                torch.cuda.empty_cache()
        if once:
            ms, r = cs.once_ms(kernel)
        else:
            ms, r = cs.best_ms(kernel, keep=True)
        out[f"{tag}_v{n}"] = {"voxels": n, "ms": ms, "plain_ms": plain_ms,
                              "plain_slices": slices,
                              "bound": bound_at(n, r)}
        del r
        torch.cuda.empty_cache()
        cs.log(f" {tag} at {n} voxels: kernel {ms:.2f} ms"
               f"{' (once)' if once else ''}, plain {plain_ms!r} ms"
               f"{f' in {slices} slices' if slices > 1 else ''}, bound "
               f"{out[f'{tag}_v{n}']['bound'][0]:.3f} ms "
               f"({out[f'{tag}_v{n}']['bound'][1]})  [{card}]")

    def cut(args, a, b, n):
        return tuple(x[..., a:b].contiguous() if torch.is_tensor(x)
                     and x.dim() and x.shape[-1] == n else x for x in args)

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

    for n in nvs:
        for num, pattern in ((12, "1234"), (20, "1"), (22, "1")):
            p, nq = 2 * num, int(pattern[-1])
            data, _, truth = cs.multiexp_plane(num, n, gen, "cuda")
            eng = cs.nl_case_engine("exp", num, pattern, data, "cuda")
            tr = eng._transforms()
            tsj = fv.signal_jac_fn(eng.model)
            a = eng.nl_loop_args(eng.initial_state())
            if num == 12:
                timed(f"nl_p{p}_q{nq}", n,
                      lambda: fnl.fused_nl_loop(eng.model, tr, *a, cs.ITERS,
                                                True),
                      lambda i, j: fnl.fused_nl_loop_plain(
                          tsj, tr, *cut(a, i, j, n), cs.ITERS, True),
                      nl_bound(p, nq, num))
            ia = (torch.log(truth).contiguous(), a[1], a[2],
                  torch.full((nq, n), 1.0 / cs.BI_SD ** 2, device="cuda"),
                  a[3], a[4], True)
            timed(f"iter_p{p}_q{nq}", n,
                  lambda: fv.fused_iteration(eng.model, tr, *ia),
                  lambda i, j: fv.fused_iteration_plain(tsj, tr,
                                                        *cut(ia, i, j, n)),
                  iter_bound(p, nq, num),
                  slices=max(1, n // plain_slice) if p >= 40 else 1)
            del eng, a, ia
            torch.cuda.empty_cache()
            if num == 20:
                neng = cs.nlls_engine(data, "cuda", {"num-exps": str(num)},
                                      "exp")
                p0 = neng.initial_means()
                largs = (neng.tmask_host, neng.max_its, False)
                ops = cs.nlls_ops(p, num, p, nt, False)

                def nlls_bound(n_, r):
                    trips = float(r[2].double().sum())
                    return cs.bound(
                        4 * (nt + p) * n_ + 4 * (p + 2 + 2 * p * p) * n_,
                        (n_ + trips) * ops["pass"] + trips * ops["step"]
                        + n_ * ops["post"])
                big = n > plain_slice
                timed(f"nlls_p{p}", n,
                      lambda: fn.fused_nlls_loop(neng.model, tr, p0, data,
                                                 *largs),
                      None if big else lambda i, j: fn.fused_nlls_loop_plain(
                          tsj, tr, p0, data, *largs),
                      nlls_bound, once=big)
                del neng, p0
            del data, truth
            torch.cuda.empty_cache()
    return out


# ---- bisection over the rolled sites -----------------------------------

# the headers whose FABBER_UNROLL sites a bisection rolls one group at a
# time (kernel 6: fused_nl_loop.cuh and vb_device.cuh; kernel 8:
# fused_nlls.cuh and vb_device.cuh)
SITE_HEADERS = ("vb_device.cuh", "fused_nl_loop.cuh", "fused_nlls.cuh")


def site_copy(dst, patch=None):
    """csrc/ copied into dst with every FABBER_UNROLL site of SITE_HEADERS
    spelt FABBER_UNROLL_<n> (defined by each unit: rolled or unrolled);
    patch(name, text) -> text edits a header further. Returns the sites'
    names, "<header>:<line>", in order of n."""
    import re
    import shutil
    from fabber_core_tpu_torch.ops import _cuda
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, dst)
    sites = []
    for name in SITE_HEADERS:
        out = []
        for i, line in enumerate((_cuda.CSRC / name).read_text()
                                 .splitlines(keepends=True), 1):
            if line.strip() == "FABBER_UNROLL":
                out.append(f"FABBER_UNROLL_{len(sites)}\n")
                sites.append(f"{name}:{i}")
            else:
                out.append(line)
        text = "".join(out)
        if name == "vb_device.cuh":
            text = re.sub(r"#if defined\(FABBER_ROLL_LOOPS\)\n.*?#endif\n",
                          "", text, count=1, flags=re.S)
        if patch is not None:
            text = patch(name, text)
        (Path(dst) / name).write_text(text)
    return sites


_ENTRY = {"fused_nl_loop.cu": ("fabber_inst_fused_nl_loop",
                               "fabber_inst_nl_occupancy"),
          "fused_nlls.cu": ("fabber_inst_fused_nlls",
                            "fabber_inst_nlls_occupancy")}


def site_unit(srcdir, source, p, q, rolled, nsites, flags=(), tag=""):
    """(library path, seconds, nvcc output) of the per-shape unit of
    source (kernel 6 or 8, ExpSum) at (P, Q) from site_copy's srcdir,
    the sites in rolled rolled and the others unrolled."""
    import hashlib
    import subprocess
    from fabber_core_tpu_torch.ops import _cuda
    head = [f"#define FABBER_INST_P {p}", f"#define FABBER_INST_Q {q}",
            "#define FABBER_INST_KIND 1"]
    pragma = {True: '_Pragma("unroll 1")', False: '_Pragma("unroll")'}
    head += [f"#define FABBER_UNROLL_{n} {pragma[n in rolled]}"
             for n in range(nsites)]
    text = "\n".join(head) + f'\n#include "{source}"\n'
    flags = list(_cuda.SOURCE_FLAGS.get(source, [])) + list(flags)
    key = hashlib.sha256((text + " ".join(flags) + tag).encode()
                         ).hexdigest()[:12]
    unit = Path(srcdir) / f"unit_{key}.cu"
    unit.write_text(text)
    out = Path(srcdir) / f"lib_{key}.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-I", str(srcdir),
           "-shared", "-o", str(out), str(unit)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def with_unit(path, source, fn_):
    """fn_() with the wrappers' per-shape instance taken from the library
    at path (ops/_cuda.py build_instance stood in)."""
    import ctypes
    from fabber_core_tpu_torch.ops import _cuda
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    args = {"fabber_inst_fused_nl_loop": [
        i32, i32, i32, vp, f32, i32, i32, f32, vp, i32, f32, i32, i32, i32,
        vp, vp, vp, vp, vp, vp, vp, i32, i64] + [vp] * 7 + [i32, vp],
        "fabber_inst_fused_nlls": [
        i32, i32, vp, f32, vp, i32, i32, i32, f32, vp, vp, vp, vp, i32,
        i64] + [vp] * 6 + [i32, vp]}
    name = _ENTRY[source][0]
    getattr(lib, name).argtypes = args[name]
    getattr(lib, name).restype = i32
    real = _cuda.build_instance
    _cuda.build_instance = lambda *a, **k: lib
    try:
        return fn_()
    finally:
        _cuda.build_instance = real


def bisect_cases(card):
    """The cases a bisection runs (source, P, Q, run, what): kernel 6
    under trialmode at exp num-exps 5 (P = 10; 3 iterations, 2 trials) on
    65,536 voxels, the case that failed rolled and optimized; kernel 8
    fresh Levenberg at P = 10 on 65,536 voxels."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import smallmat as sm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 58)
    data, _, _ = cs.multiexp_plane(5, 65_536, gen, "cuda")
    eng = cs.wide_nl_engine("exp", 5, data, "cuda", {
        "convergence": "trialmode", "max-iterations": "3",
        "max-trials": "2"})
    tr = eng._transforms()
    s0 = eng.initial_state()
    args = eng.nl_loop_args(s0)
    kw = dict(detector=eng._nl_fdet_consts(),
              post_var0=sm.diag_of(s0.post.cov).contiguous())
    neng = cs.nlls_engine(data, "cuda", {"num-exps": "5"}, "exp")
    p0 = neng.initial_means()
    return {
        "k6": ("fused_nl_loop.cu", 10, 1, lambda: fnl.fused_nl_loop(
            eng.model, tr, *args, 3, True, **kw)),
        "k8": ("fused_nlls.cu", 10, 1, lambda: fn.fused_nlls_loop(
            neng.model, tr, p0, data, neng.tmask_host, neng.max_its,
            False))}


def outcome(res, ref):
    """(non-finite count per output, largest |res - ref| per output)."""
    import torch
    bad = [int((~torch.isfinite(o)).sum()) for o in res if o is not None]
    diff = [float((a.double() - b.double()).abs().nan_to_num(
        nan=float("inf")).max()) for a, b in zip(res, ref)
        if a is not None]
    return bad, diff


def bisect(card, width=8):
    """Rolls one group of FABBER_UNROLL sites at a time (the others
    unrolled) and halves the group that breaks the case (a non-finite
    output the all-unrolled unit does not give) until one site is left;
    where no group breaks it alone, the groups whose absence repairs the
    rest stay rolled as a base and the bisection goes on inside the
    first. Each round builds its width units at once. Per case (kernel 6
    trialmode, kernel 8 fresh, P = 10): the all-unrolled and the
    all-rolled units first; the bisection only where all-rolled fails.
    Also the all-rolled units with __restrict__ dropped from the kernels'
    pointers and with -Xcicc -O1, and, at the end, the PTX of the last
    failing unit into chiprun_out/bisect_<case>.ptx."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    # no prebuilt library: P = 10 is a per-shape shape of both kernels
    _cuda.has_nl_instance = lambda kind, p, q: False
    _cuda.has_nlls_instance = lambda kind, p: False
    root = _cuda.BUILD_DIR.parent / "bisect"
    srcdir = root / "csrc"
    sites = site_copy(srcdir)
    nosr = root / "norestrict"
    site_copy(nosr, lambda name, text: text)
    for f in list(nosr.glob("*.cuh")) + list(nosr.glob("*.cu")):
        f.write_text(f.read_text().replace("__restrict__", ""))
    n = len(sites)
    cs.log(f"bisect: {n} sites  [{card}]")
    cases = bisect_cases(card)
    out = {"sites": sites}
    pool = ThreadPoolExecutor(width)
    for cname, (source, p, q, run) in cases.items():
        own = [i for i, s in enumerate(sites)
               if s.startswith("vb_device") or s.startswith(
                   "fused_nl_loop" if source == "fused_nl_loop.cu"
                   else "fused_nlls")]
        tests = {}

        def test(rolled, d=srcdir, flags=(), tag=""):
            key = (tuple(sorted(rolled)), str(d), tuple(flags))
            if key not in tests:
                tests[key] = pool.submit(site_unit, d, source, p, q,
                                         set(rolled), n, flags, tag)
            return key

        def result(key, ref):
            path, secs, _ = tests[key].result()
            r = with_unit(path, source, run)
            torch.cuda.synchronize()
            bad, diff = outcome(r, ref if ref is not None else r)
            return bad, diff, secs, path
        k_un = test(())
        k_all = test(own)
        k_nr = test(own, nosr)
        k_o1 = test(own, flags=("-Xcicc", "-O1"))
        ref = with_unit(tests[k_un].result()[0], source, run)
        torch.cuda.synchronize()
        rec = {}
        for name, key in (("unrolled", k_un), ("rolled", k_all),
                          ("rolled, no __restrict__", k_nr),
                          ("rolled, -Xcicc -O1", k_o1)):
            bad, diff, secs, _ = result(key, ref)
            rec[name] = {"nonfinite": bad, "max_diff": diff, "nvcc_s": secs}
            cs.log(f" {cname} {name}: non-finite {bad}, max |diff| from "
                   f"unrolled {diff} (nvcc {secs:.1f} s)  [{card}]")
        out[cname] = rec
        base_bad = rec["unrolled"]["nonfinite"]

        def fails(key):
            bad, _, _, _ = result(key, ref)
            return any(b > a for b, a in zip(bad, base_bad))
        if not fails(k_all):
            cs.log(f" {cname}: rolled and optimized matches; no bisection")
            continue
        base, suspects, rounds = [], list(own), []
        last = k_all
        while len(suspects) > 1:
            k = min(width, len(suspects))
            groups = [suspects[i::k] for i in range(k)]
            keys = [test(base + g) for g in groups]
            bad = [fails(key) for key in keys]
            rounds.append({"base": [sites[i] for i in base],
                           "groups": [[sites[i] for i in g] for g in groups],
                           "fails": bad})
            cs.log(f" {cname} round {len(rounds)}: base {len(base)} sites, "
                   f"groups {[len(g) for g in groups]} fail {bad}")
            if any(bad):
                j = bad.index(True)
                suspects, last = groups[j], keys[j]
                continue
            keys = [test(base + [s for s in suspects if s not in g])
                    for g in groups]
            needed = [not fails(key) for key in keys]
            rounds.append({"complements_repair": needed})
            cs.log(f" {cname} round {len(rounds)}: without each group "
                   f"repaired {needed}")
            if not any(needed):
                cs.log(f" {cname}: no group is needed alone; stop")
                break
            need = [g for g, nd in zip(groups, needed) if nd]
            base = base + [s for g in need[1:] for s in g]
            suspects = need[0]
        found = {"base": [sites[i] for i in base],
                 "sites": [sites[i] for i in suspects]}
        if len(suspects) == 1:
            key = test(base + suspects)
            found["fails"] = fails(key)
            last = key if found["fails"] else last
            found["base_alone_fails"] = fails(test(base))
        rec["rounds"] = rounds
        rec["found"] = found
        cs.log(f" {cname}: found {found}  [{card}]")
        # the PTX of the last failing unit, for reading the rolled loop
        import subprocess
        path = tests[last].result()[0]
        unit = path.parent / path.name.replace("lib_", "unit_").replace(
            ".so", ".cu")
        ptx = Path("chiprun_out") / f"bisect_{cname}.ptx"
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS,
                        *_cuda.SOURCE_FLAGS.get(source, []), "-I",
                        str(srcdir), "-ptx", "-o", str(ptx), str(unit)],
                       capture_output=True, text=True)
        (Path("chiprun_out") / f"bisect_{cname}.cu").write_text(
            unit.read_text())
    pool.shutdown()
    return out



# ---- the repair: code forms of the rolled kernel 6 ----------------------

def _hoist_ch(name, text):
    """fused_nl_loop.cuh with the posterior factor ch declared at the
    kernel's scope, beside prec and cov, instead of in the iteration."""
    if name != "fused_nl_loop.cuh":
        return text
    assert "    float ch[NT];\n" in text
    text = text.replace("    float ch[NT];\n", "")
    return text.replace("  float prec[NT], cov[NT], means[P];\n",
                        "  float prec[NT], cov[NT], means[P], ch[NT];\n")


def _local_inverse(name, text):
    """vb_device.cuh with inverse_from_chol in its form before the repair
    (probes/csrc/inverse_local.cuh: L^-1 in a local array of its own)."""
    if name != "vb_device.cuh":
        return text
    import re
    old = (Path(__file__).resolve().parent / "csrc" /
           "inverse_local.cuh").read_text()
    old = old[old.index("// A^-1 = L^-T L^-1"):]
    text, n = re.subn(r"// A\^-1 = L\^-T L\^-1 .*?\n}\n", lambda m: old,
                      text, count=1, flags=re.S)
    assert n == 1
    return text


# the code forms of the rolled kernel 6 unit: csrc/ as it is (L^-1 in cov's
# storage), the form before the repair, and that form with the factor ch
# declared at the kernel's scope (which does not repair it)
REPAIRS = {"repaired": (), "pre-repair": (_local_inverse,),
           "pre-repair, ch at kernel scope": (_local_inverse, _hoist_ch)}


def repair(card):
    """Kernel 6 under trialmode, maxits and pointzeroone at exp num-exps 5
    (P = 10, 3 iterations, 65,536 voxels) with every site rolled
    (FABBER_ROLL_LOOPS) and optimized, in each code form of REPAIRS
    (patched copies of csrc/), against the unrolled unit of csrc/ as it
    is: non-finite counts and largest differences per output. The
    pre-repair form must fail and the repaired one match."""
    import shutil
    import subprocess
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import smallmat as sm
    _cuda.has_nl_instance = lambda kind, p, q: False
    root = _cuda.BUILD_DIR.parent / "repair"
    jobs = {}
    for name, patches in list(REPAIRS.items()) + [("unrolled", ())]:
        d = root / name.replace(" ", "_").replace("^", "")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_cuda.CSRC, d)
        for f in d.glob("*.cuh"):
            text = f.read_text()
            for patch in patches:
                text = patch(f.name, text)
            f.write_text(text)
        roll = "" if name == "unrolled" else "#define FABBER_ROLL_LOOPS\n"
        unit = d / "unit.cu"
        unit.write_text("#define FABBER_INST_P 10\n#define FABBER_INST_Q 1\n"
                        f"#define FABBER_INST_KIND 1\n{roll}"
                        '#include "fused_nl_loop.cu"\n')
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(d), "-shared",
               "-o", str(d / "lib.so"), str(unit)]
        jobs[name] = (d / "lib.so", cmd)
    with ThreadPoolExecutor(len(jobs)) as pool:
        procs = {n: pool.submit(subprocess.run, cmd, capture_output=True,
                                text=True) for n, (_, cmd) in jobs.items()}
        for n, f in procs.items():
            r = f.result()
            if r.returncode != 0:
                raise RuntimeError(f"{n}: {r.stdout}{r.stderr}")
            frames = [ln.strip() for ln in r.stdout.splitlines()
                      if "stack frame" in ln]
            cs.log(f" repair {n}: built; stack frames {frames[:6]}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 59)
    data, _, _ = cs.multiexp_plane(5, 65_536, gen, "cuda")
    out = {}
    for kind in ("trialmode", "maxits", "pointzeroone"):
        extra = {} if kind == "maxits" else {
            "convergence": kind, "max-iterations": "3", "max-trials": "2"}
        eng = cs.wide_nl_engine("exp", 5, data, "cuda", extra)
        tr = eng._transforms()
        s0 = eng.initial_state()
        args = eng.nl_loop_args(s0)
        kw = {} if kind == "maxits" else dict(
            detector=eng._nl_fdet_consts(),
            post_var0=sm.diag_of(s0.post.cov).contiguous())
        def run():
            return fnl.fused_nl_loop(eng.model, tr, *args, 3, True, **kw)
        res = {n: with_unit(path, "fused_nl_loop.cu", run)
               for n, (path, _) in jobs.items()}
        torch.cuda.synchronize()
        for n, r in res.items():
            bad, diff = outcome(r, res["unrolled"])
            out[f"{kind} {n}"] = {"nonfinite": bad, "max_diff": diff}
            cs.log(f" kernel 6 {kind} P=10 rolled, {n}: non-finite {bad}, "
                   f"max |diff| from unrolled {diff}  [{card}]")
    return out



def fmad_check(card, case="ExpSum<12> Q=4"):
    """chip_smoke.py phase 3k's case alone, twice on the same data: with
    kernel 6's per-shape units built as csrc/ builds them (nvcc contracts
    multiply-adds) and with -fmad=false; near_f64's verdicts logged."""
    from fabber_core_tpu_torch.ops import _cuda
    cases, flags = cs.NL_CASES, dict(_cuda.SOURCE_FLAGS)
    cs.NL_CASES = tuple(c for c in cases if c[0] == case)
    out = {}
    try:
        for label, extra in (("as built", None), ("-fmad=false",
                                                  ["-fmad=false"])):
            if extra:
                _cuda.SOURCE_FLAGS = {**flags, "fused_nl_loop.cu": extra}
            cs.log(f" {case}, kernel 6's units {label}  [{card}]")
            out[label] = cs.check_nl_instances("cuda")
    finally:
        cs.NL_CASES, _cuda.SOURCE_FLAGS = cases, flags
    return out


# phase 3k's cases in the order its first rolled layout ran them, with the
# rolled P = 10 case second on 65,536 voxels of the shared generator:
# (name, model, num-exps, noise pattern, whether it drew an LM alpha, V)
FIRST_LAYOUT = (("ExpSum<5>", "exp", 5, "1", True, 131_072),
                ("ExpSum<5> rolled", "exp", 5, "1", False, 65_536),
                ("biexp Q=6", "biexp", 2, "123456", True, 131_072),
                ("generated P=12", "myexp", 6, "1", False, 131_072),
                ("ExpSum<12> Q=4", "exp", 12, "1234", False, 65_536))


def first_layout_planes(device, seed=None):
    """{case name: data [T,V]} of FIRST_LAYOUT, drawn as
    chip_smoke.py check_nl_instances draws them (the case's plane, its
    latent centre, an LM alpha) from one generator seeded as phase 3k's."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(cs.SEED + 50 if seed is None else seed)
    out = {}
    for name, model, num, _, lm, nv in FIRST_LAYOUT:
        data, _, truth = cs.nl_case_plane(model, num, nv, gen, device)
        out[name] = data
        torch.randn(truth.shape, generator=gen, device=device)
        if lm:
            torch.rand(nv, generator=gen, device=device)
    return out


# the units a witness run builds: (label, source, P, Q, rolled, flags)
WITNESS_UNITS = (
    ("k6 P=24 Q=4 -O3", "fused_nl_loop.cu", 24, 4, True, ()),
    ("k6 P=24 Q=4 -G", "fused_nl_loop.cu", 24, 4, True, ("-G",)),
    ("k6 P=24 Q=4 -Xcicc -O1", "fused_nl_loop.cu", 24, 4, True,
     ("-Xcicc", "-O1")),
    ("k6 P=10 unrolled -O3", "fused_nl_loop.cu", 10, 1, False, ()),
    ("k6 P=10 rolled -O3", "fused_nl_loop.cu", 10, 1, True, ()),
    ("k6 P=10 rolled -G", "fused_nl_loop.cu", 10, 1, True, ("-G",)),
    ("k6 P=10 rolled -Xcicc -O1", "fused_nl_loop.cu", 10, 1, True,
     ("-Xcicc", "-O1")),
    ("k8 P=40 -O3", "fused_nlls.cu", 40, 1, True, ()),
    ("k8 P=40 -Xcicc -O1", "fused_nlls.cu", 40, 1, True, ("-Xcicc", "-O1")))


def witness_builds(card, labels=None):
    """WITNESS_UNITS (those of labels, default all) built from csrc/ as it
    is, one nvcc each, all started together (and the library beside
    them). Returns {label: path}."""
    import subprocess
    from fabber_core_tpu_torch.ops import _cuda
    root = _cuda.BUILD_DIR.parent / "witness"
    root.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for label, source, p, q, rolled, flags in WITNESS_UNITS:
        if labels is not None and label not in labels:
            continue
        stem = label.replace(" ", "_").replace("=", "").replace("-", "")
        unit = root / f"{stem}.cu"
        roll = "#define FABBER_ROLL_LOOPS\n" if rolled else ""
        unit.write_text(f"#define FABBER_INST_P {p}\n#define FABBER_INST_Q "
                        f"{q}\n#define FABBER_INST_KIND 1\n{roll}"
                        f'#include "{source}"\n')
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS,
               *_cuda.SOURCE_FLAGS.get(source, []), *flags, "-I",
               str(_cuda.CSRC), "-shared", "-o", str(root / f"{stem}.so"),
               str(unit)]
        jobs[label] = (root / f"{stem}.so", cmd)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        lib = pool.submit(_cuda.build)
        procs = {n: pool.submit(subprocess.run, cmd, capture_output=True,
                                text=True) for n, (_, cmd) in jobs.items()}
        for n, f in procs.items():
            r = f.result()
            if r.returncode != 0:
                raise RuntimeError(f"{n}: {r.stdout}{r.stderr}")
            frames = [ln.strip() for ln in r.stdout.splitlines()
                      if "stack frame" in ln]
            cs.log(f" witness {n}: built; stack frames {frames[:3]}")
        lib.result()
    cs.log(f" witness units built in {time.perf_counter() - t0:.1f} s  "
           f"[{card}]")
    return {n: path for n, (path, _) in jobs.items()}


def witness(card):
    """Where phase 3k's trialmode check, every lane held to float64
    (near_f64 without by_share), failed on FIRST_LAYOUT's data (ExpSum<12>
    at Q = 4, P = 24: 1.53 on F; the rolled P = 10 unit: 83.7 on the
    precision), the same unit built optimized,
    with -G and with -Xcicc -O1, held by near_f64 against the plain
    version at float32 and float64 on the card, beside a second plain
    float32 implementation (the plain version on the CPU) held the same
    way, and each build's largest difference from the optimized one; the
    rolled P = 10 unit beside the unrolled one. Kernel 8 rolled at P = 40
    (ExpSum<20>, 4,096 voxels, 8 steps) optimized against -Xcicc -O1."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import smallmat as sm
    paths = witness_builds(card)
    _cuda.has_nl_instance = lambda kind, p, q: False
    _cuda.has_nlls_instance = lambda kind, p: False
    planes = first_layout_planes("cuda")
    out = {}

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    def dec(o):
        return torch.stack([o[6][0].double(), 0 * o[6][0].double()])

    for name, num, pattern, p in (("ExpSum<12> Q=4", 12, "1234", 24),
                                  ("ExpSum<5> rolled", 5, "1", 10)):
        data = planes[name]
        teng = cs.nl_case_engine("exp", num, pattern, data, "cuda", {
            "convergence": "trialmode", "max-iterations": "3",
            "max-trials": "2"})
        tr = teng._transforms()
        tsj = fv.signal_jac_fn(teng.model)
        s0 = teng.initial_state()
        targs = teng.nl_loop_args(s0)
        det = teng._nl_fdet_consts()
        pd0 = sm.diag_of(s0.post.cov).contiguous()
        r32 = fnl.fused_nl_loop_plain(tsj, tr, *targs, 3, True,
                                      detector=det, post_var0=pd0)
        r64 = fnl.fused_nl_loop_plain(tsj, tr, *cs.to64(targs), 3, True,
                                      detector=det, post_var0=pd0.double())
        t0 = time.perf_counter()
        rcpu = fnl.fused_nl_loop_plain(tsj, tr, *(cpu(a) for a in targs), 3,
                                       True, detector=det,
                                       post_var0=pd0.cpu())
        rcpu = type(rcpu)(cpu_o.cuda() if torch.is_tensor(cpu_o) else
                          type(cpu_o)(x.cuda() for x in cpu_o)
                          for cpu_o in rcpu)
        cs.log(f" {name} V={data.shape[1]}: plain float32 on the CPU in "
               f"{time.perf_counter() - t0:.1f} s")
        res = {"plain float32, CPU": rcpu}
        for label in paths:
            if label.startswith(f"k6 P={p} "):
                res[label] = with_unit(
                    paths[label], "fused_nl_loop.cu",
                    lambda: fnl.fused_nl_loop(teng.model, tr, *targs, 3,
                                              True, detector=det,
                                              post_var0=pd0))
        torch.cuda.synchronize()
        base = res[f"k6 P={p} rolled -O3" if p == 10 else f"k6 P={p} Q=4 -O3"]
        for label, r in res.items():
            ok, err, ratio = cs.near_f64(f"fused_nl_loop {name} trialmode, "
                                         f"{label}", r, r32, r64, dec(r),
                                         dec(r32), dec(r64))
            bad, diff = outcome(r[:6], base[:6])
            cs.log(f"  {label}: non-finite {bad}, max |diff| from the "
                   f"optimized rolled unit {diff}  [{card}]")
            out[f"{name} {label}"] = {"ok": ok, "ratio": ratio,
                                      "nonfinite": bad, "max_diff": diff}
        del teng, s0, targs, r32, r64, rcpu, res, base
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 50)
    data, _, _ = cs.multiexp_plane(20, 4_096, gen, "cuda")
    neng = cs.nlls_engine(data, "cuda", {"num-exps": "20",
                                         "nlls-max-iterations": "8"}, "exp")
    tr = [pm.transform for pm in neng.params]
    p0 = neng.initial_means()
    res = {label: with_unit(paths[label], "fused_nlls.cu",
                            lambda: fn.fused_nlls_loop(
                                neng.model, tr, p0, data, neng.tmask_host,
                                neng.max_its, False))
           for label in paths if label.startswith("k8 ")}
    torch.cuda.synchronize()
    bad, diff = outcome(res["k8 P=40 -Xcicc -O1"], res["k8 P=40 -O3"])
    cs.log(f" kernel 8 P=40 rolled, -Xcicc -O1 against -O3: non-finite "
           f"{bad}, max |diff| {diff}  [{card}]")
    out["k8 P=40 -Xcicc -O1"] = {"nonfinite": bad, "max_diff": diff}
    return out


def lanes(card, top=4, device="cuda", nv=None):
    """The lanes behind witness's failing trialmode checks: on
    FIRST_LAYOUT's data of ExpSum<5> (P = 10) and ExpSum<12> at Q = 4 (P
    = 24), the top lanes of the kernel's error in its worst output over
    that output's max, and beside them those of the plain float32
    version; per lane, kernel 6 (its per-shape unit as the package builds
    it) and the plain version at float32 and float64 under trialmode at 1,
    2 and 3 iterations: the iteration count and F out, and the plain
    versions' detector tests (F, F - prev F, and the trial, save and
    revert flags after each test). device and nv (the first nv voxels of
    each plane): a dry run on the CPU, where the kernel is the plain
    version."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import smallmat as sm
    if device == "cuda":
        t0 = time.perf_counter()
        _cuda.build_instances((("nl", 10, 1, 1, "nl_loop"),
                               ("nl", 24, 4, 1, "nl_loop")))
        cs.log(f" lanes: units built in {time.perf_counter() - t0:.1f} s  "
               f"[{card}]")
    planes = first_layout_planes(device)
    out = {}
    for name, num, pattern, worst in (("ExpSum<5> rolled", 5, "1", 1),
                                      ("ExpSum<12> Q=4", 12, "1234", 5)):
        data = planes[name][:, :nv].contiguous()
        teng = cs.nl_case_engine("exp", num, pattern, data, device, {
            "convergence": "trialmode", "max-iterations": "3",
            "max-trials": "2"})
        tr = teng._transforms()
        tsj = fv.signal_jac_fn(teng.model)
        s0 = teng.initial_state()
        targs = teng.nl_loop_args(s0)
        det = teng._nl_fdet_consts()
        pd0 = sm.diag_of(s0.post.cov).contiguous()
        tests = []
        real = det["det"].test

        def spy(state, f, real=real):
            new = real(state, f)
            tests.append((f.double(), (f - state.prev_f).double(),
                          new.trialmode, new.save, new.revert, new.its))
            return new
        det["det"].test = spy
        runs = {}
        for n in (1, 2, 3):
            runs["kernel", n] = fnl.fused_nl_loop(
                teng.model, tr, *targs, n, True, detector=det,
                post_var0=pd0)
            for tag, args, pv in (("f32", targs, pd0),
                                  ("f64", cs.to64(targs), pd0.double())):
                del tests[:]
                runs[tag, n] = fnl.fused_nl_loop_plain(
                    tsj, tr, *args, n, True, detector=det, post_var0=pv)
                runs[tag, n, "tests"] = list(tests)
        det["det"].test = real
        if device == "cuda":
            torch.cuda.synchronize()
        ref = runs["f64", 3][worst].double()
        scale = ref.abs().max()

        def lane_err(r):
            e = (r[worst].double() - ref).abs() / scale
            return e.reshape(-1, e.shape[-1]).amax(dim=0)
        ek, e32 = lane_err(runs["kernel", 3]), lane_err(runs["f32", 3])
        pick = list(dict.fromkeys(
            torch.topk(ek, top).indices.tolist()
            + torch.topk(e32, top).indices.tolist()))
        cs.log(f" {name}: output {worst}, error over its max: kernel "
               f"{float(ek.max()):.3g}, plain float32 {float(e32.max()):.3g}"
               f"  [{card}]")
        rows = []
        for v in pick:
            cs.log(f"  lane {v}: error kernel {float(ek[v]):.3g}, plain "
                   f"float32 {float(e32[v]):.3g}")
            row = {"lane": v, "kernel_err": float(ek[v]),
                   "f32_err": float(e32[v])}
            for n in (1, 2, 3):
                for tag in ("kernel", "f32", "f64"):
                    r = runs[tag, n]
                    its, f = float(r[6][0, v]), float(r[5][0, v])
                    row[f"{tag} n={n}"] = (its, f)
                    cs.log(f"   n={n} {tag:6s} its {its:g}  F {f:.9g}")
            for tag in ("f32", "f64"):
                for i, (f, d, tm, sv, rv, its) in enumerate(
                        runs[tag, 3, "tests"]):
                    cs.log(f"   {tag} test {i}: F {float(f[v]):.9g} "
                           f"dF {float(d[v]):.3g} trial {bool(tm[v])} "
                           f"save {bool(sv[v])} revert {bool(rv[v])} "
                           f"its {int(its[v])}")
            rows.append(row)
        out[name] = rows
        del teng, s0, targs, runs
        torch.cuda.empty_cache()
    return out


def spread(card, seeds=(1, 2, 3)):
    """How far float32 rounding alone moves phase 3k's trialmode check on
    FIRST_LAYOUT's data of ExpSum<5> (P = 10) and ExpSum<12> at Q = 4 (P =
    24): the plain float32 version on the data moved by one ulp at every
    sample (a random direction per sample, each seed), held by near_f64
    against the plain float32 version and float64 on the data as it is,
    as the check holds the kernel; and, at the lanes where the kernel's
    error is largest, the scaled condition (chip_smoke.py scaled_cond) of
    the float64 precision after 1 and 2 iterations. Then kernel 8 rolled
    at P = 40 built -O3 and -Xcicc -O1: each one's non-finite counts and
    their largest differences."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import smallmat as sm
    paths = witness_builds(card, ("k8 P=40 -O3", "k8 P=40 -Xcicc -O1"))
    _cuda.build_instances((("nl", 10, 1, 1, "nl_loop"),
                           ("nl", 24, 4, 1, "nl_loop")), False)
    planes = first_layout_planes("cuda")
    out = {}

    def dec(o):
        return torch.stack([o[6][0].double(), 0 * o[6][0].double()])

    for name, num, pattern, worst in (("ExpSum<5> rolled", 5, "1", 1),
                                      ("ExpSum<12> Q=4", 12, "1234", 5)):
        data = planes[name]
        teng = cs.nl_case_engine("exp", num, pattern, data, "cuda", {
            "convergence": "trialmode", "max-iterations": "3",
            "max-trials": "2"})
        tr = teng._transforms()
        tsj = fv.signal_jac_fn(teng.model)
        s0 = teng.initial_state()
        targs = teng.nl_loop_args(s0)
        det = teng._nl_fdet_consts()
        pd0 = sm.diag_of(s0.post.cov).contiguous()
        kw = dict(detector=det, post_var0=pd0)
        k = fnl.fused_nl_loop(teng.model, tr, *targs, 3, True, **kw)
        r32 = fnl.fused_nl_loop_plain(tsj, tr, *targs, 3, True, **kw)
        r64 = fnl.fused_nl_loop_plain(tsj, tr, *cs.to64(targs), 3, True,
                                      detector=det, post_var0=pd0.double())
        res = {"kernel": cs.near_f64(f"{name} kernel", k, r32, r64, dec(k),
                                     dec(r32), dec(r64))[2]}
        gen = torch.Generator(device="cuda")
        for seed in seeds:
            gen.manual_seed(seed)
            up = torch.rand(data.shape, generator=gen, device="cuda") < 0.5
            moved = torch.nextafter(data, torch.where(
                up, torch.full_like(data, float("inf")),
                torch.full_like(data, -float("inf"))))
            pargs = targs[:3] + (moved,) + targs[4:]
            rp = fnl.fused_nl_loop_plain(tsj, tr, *pargs, 3, True, **kw)
            res[f"plain float32, data moved one ulp, seed {seed}"] = \
                cs.near_f64(f"{name} plain float32, data one ulp off "
                            f"(seed {seed})", rp, r32, r64, dec(rp),
                            dec(r32), dec(r64))[2]
            del rp, moved, pargs
        ref = r64[worst].double()
        e = ((k[worst].double() - ref).abs() / ref.abs().max())
        e = e.reshape(-1, e.shape[-1]).amax(dim=0)
        lanes_ = torch.topk(e, 4).indices
        conds = []
        for n in (1, 2):
            r = fnl.fused_nl_loop_plain(tsj, tr, *cs.to64(targs), n, True)
            conds.append(cs.scaled_cond(r[1][..., lanes_]).tolist())
            med = float(cs.scaled_cond(r[1][..., ::64]).median())
            cs.log(f"  {name}: float64 precision after {n} iteration(s), "
                   f"scaled condition at the kernel's worst lanes "
                   f"{lanes_.tolist()}: {conds[-1]} (median over every "
                   f"64th lane {med:.3g})  [{card}]")
        res["worst lanes"] = lanes_.tolist()
        res["scaled cond"] = conds
        out[name] = res
        del teng, s0, targs, k, r32, r64
        torch.cuda.empty_cache()
    _cuda.has_nlls_instance = lambda kind, p: False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 50)
    data, _, _ = cs.multiexp_plane(20, 4_096, gen, "cuda")
    neng = cs.nlls_engine(data, "cuda", {"num-exps": "20",
                                         "nlls-max-iterations": "8"}, "exp")
    tr = [pm.transform for pm in neng.params]
    p0 = neng.initial_means()
    res = {label: with_unit(paths[label], "fused_nlls.cu",
                            lambda: fn.fused_nlls_loop(
                                neng.model, tr, p0, data, neng.tmask_host,
                                neng.max_its, False))
           for label in paths}
    torch.cuda.synchronize()
    for label, r in res.items():
        bad, diff = outcome(r, res["k8 P=40 -O3"])
        cs.log(f" kernel 8 P=40 rolled, {label}: non-finite {bad}, max "
               f"|diff| from -O3 {diff}  [{card}]")
        out[label] = {"nonfinite": bad, "max_diff": diff}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="3k,4aa,5k")
    ap.add_argument("--rolled", action="store_true")
    ap.add_argument("--rolled-times", action="store_true")
    ap.add_argument("--bisect", action="store_true")
    ap.add_argument("--repair", action="store_true")
    ap.add_argument("--fmad", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--lanes", action="store_true")
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--coop", default=None)
    args = ap.parse_args()
    card = cs.card_line()
    cs.log(card)
    if args.phases:
        out = {"card": card, "build_s": build(
            card, tuple(("nl", 16, 1, 1, k)
                         for k in ("nl_loop", "vb_iter", "nlls"))
            if args.rolled else ())}
    else:
        from fabber_core_tpu_torch.ops import _cuda
        if args.rolled or args.rolled_times:
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
    if args.fmad:
        try:
            out["fmad"] = fmad_check(card)
        except Exception:
            ok = False
            cs.log(f"FAILED fmad:\n{traceback.format_exc()}")
    if args.witness:
        try:
            out["witness"] = witness(card)
        except Exception:
            ok = False
            cs.log(f"FAILED witness:\n{traceback.format_exc()}")
    if args.spread:
        try:
            out["spread"] = spread(card)
        except Exception:
            ok = False
            cs.log(f"FAILED spread:\n{traceback.format_exc()}")
    if args.lanes:
        try:
            out["lanes"] = lanes(card)
        except Exception:
            ok = False
            cs.log(f"FAILED lanes:\n{traceback.format_exc()}")
    if args.repair:
        try:
            out["repair"] = repair(card)
        except Exception:
            ok = False
            cs.log(f"FAILED repair:\n{traceback.format_exc()}")
    if args.bisect:
        try:
            out["bisect"] = bisect(card)
        except Exception:
            ok = False
            cs.log(f"FAILED bisect:\n{traceback.format_exc()}")
    if args.coop:
        import coop_sections
        out["coop"] = coop_sections.compare(
            card, args.coop, ("7c",), True)
        ok &= out["coop"]["ok"]
    out["ok"] = ok
    text = json.dumps(out, default=str)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/wide_nl.json").write_text(text)
    print(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
