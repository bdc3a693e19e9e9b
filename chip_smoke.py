#!/usr/bin/env python3
"""Smoke test of fabber_core_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from fabber_core_tpu_torch/csrc/ (one nvcc
per source, all started together, into build/kernels/) and holds each
kernel, in each of its modes, against its plain-torch version on the
card, with three functors generated from models' evaluate (the whole-loop
kernel's generic mode) built beside them. It drives the port's main paths end to end through the public
API on a 128x128x64 volume: poly degree 2 (T=106) on the fixed-design
spectral route, and biexp (T=100, bench.py's biexp data) on the
whole-loop nonlinear route, each under maxits and under
--convergence=trialmode (the kernels' in-kernel detector modes); poly
with --noise-pattern=12 (the whole-program kernel), under lm, with
engine-kernel=pallas-loop (the stats-input kernel), each held to the
float64 'xla' route on the card; the linear model (128x128x32) with
--spectral-impl=fused (the one-kernel spectral form). It checks that
each path went through its kernels and that the results are right;
runs the per-iteration nonlinear route, under maxits and under lm (its
LM branch); drives method=nlls (the NLLS kernel with its two-phase
straggler compaction, Levenberg and --lm, on the biexp volume; the
fixed-design route on linear) and the NLLS->VB workflow (nlls with
save-mvn, then VB continued from its finalMVN through the per-iteration
kernel); drives --noise=ar (the AR(1) kernel, one and two echoes, maxits
and pointzeroone, held to the float64 'xla' route on the card); drives
the generic mode (a Gaussian bump and biexp's evaluate through their
generated functors against the plain version, --loadmodels on the torch
myexp plugin through its time_signal functor and evaluate-only, a
suppdata run against the float64 'xla-generic' route on the card); then
times the kernels, their plain versions, a device-to-device copy and the
whole engine run, poly at 16,777,216 voxels (white and AR noise) and
biexp at 4,000,000 (VB and NLLS; the generated biexp functor beside the
hand-written one; kernels 6 and 8 in their staged and streamed forms,
csrc/tile.cuh, with each form's plan, blocks per SM and registers). Every phase passes or the script exits
non-zero without printing the result line. The last line of standard
output is the JSON result object; the line before it lists the
kernels, each with its bound (the least time the card could take:
bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, the
published H100 SXM peaks).

Without a CUDA device (or outside the repository) it exits non-zero.
"""

import json
import subprocess
import sys
import time

import numpy as np

NT = 106                 # timepoints of the main path (bench.py poly)
SEED = 1234
ITERS = 10
BI_NT, BI_DT, BI_SD = 100, 0.02, 0.05   # bench.py biexp: T, dt, noise sd
# biexp, 10 iterations: of the voxels where the plain version at float32
# agrees with float64, the share where the kernel agrees with float64
# too (0.817-0.854 over four H100 runs of phase 3b's shapes; a kernel
# fault sends most voxels off)
BIEXP_STABLE_AGREE = 0.75
# published H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s
# and float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# lanes of phase 5c's float64 reference: each lane's loop is its own, so
# a slice gives the same lanes at half the float32 run's bytes
F64_LANES = 1_048_576


def log(msg):
    print(msg, flush=True)


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def poly_design(p, nt=NT):
    t = np.arange(1, nt + 1, dtype=np.float64)
    return t[:, None] ** np.arange(p, dtype=np.float64)[None, :]


def synthetic_design(nt=NT):
    """A P=4 fixed design (offset, drift and two slow oscillations),
    standing in for the linear model's design matrix."""
    t = np.arange(nt, dtype=np.float64) / nt
    return np.stack([np.ones(nt), t, np.sin(2 * np.pi * 3 * t),
                     np.cos(2 * np.pi * 5 * t)], axis=1)


def gen_plane(design, nv, gen, scale, noise_sd, device):
    """[T,V] float32 data plane D @ truth + noise, made on the device."""
    import torch
    p = design.shape[1]
    d = torch.as_tensor(design, dtype=torch.float32, device=device)
    truth = (torch.rand((p, nv), generator=gen, device=device) * 2 - 1) \
        * torch.as_tensor(scale, dtype=torch.float32, device=device)[:, None]
    plane = torch.randn((design.shape[0], nv), generator=gen,
                        device=device).mul_(noise_sd)
    plane.addmm_(d, truth)
    return plane, truth


def err_check(name, got, ref, bound, scale=None):
    """Max abs error of got vs ref and that error over the scale
    (default max|ref|); passes when the scaled error <= bound."""
    got = got.double()
    ref = ref.double()
    abs_err = float((got - ref).abs().max())
    sc = float(ref.abs().max()) if scale is None else float(scale)
    rel = abs_err / sc if sc > 0 else abs_err
    ok = rel <= bound
    log(f"  {name:<24} max_abs_err={abs_err:.6g} scaled_err={rel:.3g} "
        f"bound={bound:g} {'ok' if ok else 'FAIL'}")
    return ok, abs_err, rel / bound


def check_kernels(device, nvs=(1_048_576, 1_000_003), seed=SEED):
    """Phase 3: each kernel against its plain version on the same
    inputs, at the main path's shapes (T=106; P=3 poly and a P=4
    synthetic design; a power-of-two and a ragged voxel count).

    Stated bounds (errors over the max |plain| of the quantity, both
    sides float32 with different summation orders):
      stats: m0 1e-3 (an OLS point through the cond~2e8 poly Gram:
      only a reference point, any finite value is correct), rtqr 1e-4,
      D'Qy = dtqr + A m0 1e-5 (the well-conditioned combination the
      core reads; dtqr alone is the rounding residue of an orthogonal
      projection), and the posterior means both statistics give
      through one float64 core, 1e-3 posterior sd;
      core: every output 1e-4 of its max."""
    import torch
    from fabber_core_tpu_torch.ops import fused_spectral as fs

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    worst = {"spectral_stats": [0.0, 0.0], "spectral_core": [0.0, 0.0]}
    ok_all = True
    cases = [(3, poly_design(3), [100.0, 0.5, 0.005], 1e-12),
             (4, synthetic_design(), [10.0, 5.0, 2.0, 2.0], 1e-2)]
    for p, design, scale, prec in cases:
        q = np.ones(NT)
        tc = fs.pack_mxu_consts(design, q, NT, torch.float32, device)
        ac = fs.pack_solve_consts(design, q, NT, torch.float32)
        pp = np.full(p, prec)
        c_post = (NT - 1) * 0.5 + 1e-6
        sc = fs.pack_spectral_consts(design, q, NT, pp, 1e-6, c_post,
                                     1e-8, 50.0, torch.float32,
                                     (-100.0, c_post + 0.5))
        for nv in nvs:
            log(f" P={p} T={NT} V={nv}")
            data, _ = gen_plane(design, nv, gen, scale, 1.0, device)
            ks = fs.spectral_stats(data, tc, ac)
            ps = fs.spectral_stats_plain(data, tc, ac)
            torch.cuda.synchronize()
            a64 = ac.double().reshape(p, p).to(device)
            dtqy_k = ks[2].double() + a64 @ ks[0].double()
            dtqy_p = ps[2].double() + a64 @ ps[0].double()
            sc64 = sc.double()
            pm0 = torch.zeros((p, nv), dtype=torch.float64, device=device)
            post_k = fs.spectral_core_plain(*(x.double() for x in ks), pm0,
                                            sc64, ITERS)
            post_p = fs.spectral_core_plain(*(x.double() for x in ps), pm0,
                                            sc64, ITERS)
            sd = torch.sqrt(torch.stack([post_p[2][i, i] for i in range(p)]))
            checks = [
                err_check("stats m0", ks[0], ps[0], 1e-3),
                err_check("stats rtqr", ks[1], ps[1], 1e-4),
                err_check("stats dtqr+A.m0", dtqy_k, dtqy_p, 1e-5),
                err_check("stats -> means/sd", post_k[0] / sd,
                          post_p[0] / sd, 1e-3, scale=1.0),
            ]
            del post_k, post_p, dtqy_k, dtqy_p, pm0
            pm = (torch.rand((p, nv), generator=gen, device=device) - 0.5) \
                * torch.as_tensor(scale, dtype=torch.float32,
                                  device=device)[:, None]
            kc = fs.spectral_core(*ps, pm, sc, ITERS)
            pc = fs.spectral_core_plain(*ps, pm, sc, ITERS)
            torch.cuda.synchronize()
            names = ["means", "prec", "cov", "b", "c", "F", "tr"]
            core_checks = [err_check(f"core {n}", k, r, 1e-4)
                           for n, k, r in zip(names, kc, pc)]
            for kname, cs in (("spectral_stats", checks),
                              ("spectral_core", core_checks)):
                for ok, abs_err, ratio in cs:
                    ok_all &= ok
                    worst[kname][0] = max(worst[kname][0], abs_err)
                    worst[kname][1] = max(worst[kname][1], ratio)
            del data, ks, ps, kc, pc, pm
            torch.cuda.empty_cache()
    return ok_all, worst


def make_volume(shape, seed=SEED):
    """Phase 4 input: a poly degree-2 volume [nx,ny,nz,T] (float32)
    with per-voxel truth and unit-sd white noise, from numpy."""
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    truth = np.stack([rng.uniform(50, 150, nv), rng.uniform(-0.5, 0.5, nv),
                      rng.uniform(-0.005, 0.005, nv)]).astype(np.float32)
    data = (poly_design(3).astype(np.float32) @ truth).T
    data += rng.standard_normal((nv, NT), dtype=np.float32)
    vol = data.reshape(shape + (NT,), order="F")
    c0 = truth[0].reshape(shape, order="F")
    return vol, c0


MAIN_OPTIONS = {"model": "poly", "degree": "2", "noise": "white",
                "method": "vb", "max-iterations": str(ITERS),
                "dtype": "single", "save-mean": True, "save-std": True,
                "save-noise-mean": True, "save-free-energy": True}


def run_main_path(device, shape=(128, 128, 64)):
    """Phase 4: the API's run_with_data on a whole volume; returns
    (ok, launches per kernel, seconds)."""
    from fabber_core_tpu_torch.api import FabberTpu
    from fabber_core_tpu_torch.ops import fused_spectral as fs

    vol, c0 = make_volume(shape)
    log(f" volume {shape + (NT,)}: {vol.nbytes / 1e6:.0f} MB float32")
    fs.spectral_stats.launches = 0
    fs.spectral_core.launches = 0
    t0 = time.perf_counter()
    run = FabberTpu(device=device).run_with_data(MAIN_OPTIONS, {"data": vol})
    secs = time.perf_counter() - t0
    launches = {"spectral_stats": fs.spectral_stats.launches,
                "spectral_core": fs.spectral_core.launches}
    log(f" run_with_data: {secs:.3f} s; launches {launches}")
    ok = all(n > 0 for n in launches.values())
    want = {"mean_c0", "mean_c1", "mean_c2", "std_c0", "std_c1", "std_c2",
            "noise_means", "freeEnergy"}
    if set(run.data) != want:
        log(f" FAIL outputs {sorted(run.data)}")
        return False, launches, secs
    for key, arr in run.data.items():
        if arr.shape != shape or not np.isfinite(arr).all():
            log(f" FAIL {key}: shape {arr.shape}, finite "
                f"{np.isfinite(arr).all()}")
            ok = False
    within = np.abs(run.data["mean_c0"] - c0) <= 3 * run.data["std_c0"]
    frac = float(within.mean())
    noise_sd = float(np.median(1 / np.sqrt(run.data["noise_means"])))
    log(f" c0 within 3 posterior sd of truth: {frac:.5f} of voxels "
        f"(bound >= 0.99); median noise sd {noise_sd:.4f} (truth 1)")
    ok &= frac >= 0.99 and abs(noise_sd - 1.0) < 0.05
    return ok, launches, secs


def check_engine_vs_f64(device, nv=4096):
    """Phase 4b: the float32 engine on the card against a float64
    reference of the same route on a small input: the plain statistics
    and core functions at float64 on the CPU, with the engine's own
    constants. Bounds: means 1e-2 posterior sd (the float32 route's own
    error at this signal scale, c0 ~ 100 and unit noise, is ~3e-3 sd on
    the CPU too), cov and noise precision 1e-4 relative, F 1e-2 abs."""
    import torch
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.options import RunOptions

    vol, _ = make_volume((nv, 1, 1), seed=SEED + 1)
    data = vol.reshape(nv, NT)
    opts = RunOptions({**MAIN_OPTIONS, "print-free-energy": True})
    eng = VBInference(get_model_class("poly")(opts), opts, data,
                      device=device)
    g = eng.run()
    tc, ac, sc = eng.spectral_consts(torch.float64, "cpu")
    stats = fs.spectral_stats_plain(
        torch.as_tensor(data.T, dtype=torch.float64), tc, ac)
    pm = eng.prior_setup.base_means.double().cpu().expand(3, nv)
    means, _, cov, b, c, f, _ = fs.spectral_core_plain(*stats, pm, sc, ITERS)
    means = means.T.numpy()
    cov = cov.permute(2, 0, 1).numpy()
    noise = (b * c)[0].numpy()
    sd = np.sqrt(np.diagonal(cov, axis1=1, axis2=2))
    errs = {"means/sd": float(np.max(np.abs(g.means - means) / sd)),
            "cov": float(np.max(np.abs(g.cov - cov) / np.abs(cov))),
            "noise": float(np.max(np.abs(g.noise_means[:, 0] - noise)
                                  / noise)),
            "F": float(np.max(np.abs(g.free_energy - f[0].numpy())))}
    bounds = {"means/sd": 1e-2, "cov": 1e-4, "noise": 1e-4, "F": 1e-2}
    ok = all(errs[k] <= bounds[k] for k in errs) and \
        not g.bad_voxels.any() and (g.iterations == ITERS).all()
    log(f" card engine vs float64 reference, {nv} voxels: {errs} "
        f"bounds {bounds} {'ok' if ok else 'FAIL'}")
    return ok


def biexp_plane(nv, gen, device, model="biexp"):
    """bench.py's biexp data made on the card: amp ~ U(0.5, 1.5), rates
    1 and 5, the second amplitude 0.5 amp, noise sd 0.05 (exp: the
    first term alone) -> (data [T,V], noiseless [T,V], truth [P,V])."""
    import torch
    t = torch.arange(BI_NT, dtype=torch.float32,
                     device=device)[:, None] * BI_DT
    amp = torch.rand((1, nv), generator=gen, device=device) + 0.5
    one = torch.ones_like(amp)
    clean = amp * torch.exp(-t)
    truth = [amp, one]
    if model == "biexp":
        clean = clean + 0.5 * amp * torch.exp(-5.0 * t)
        truth += [0.5 * amp, 5.0 * one]
    data = torch.randn((BI_NT, nv), generator=gen, device=device)
    data.mul_(BI_SD).add_(clean)
    return data, clean, torch.cat(truth)


def nl_engine(model, pattern, plane, device, extra=None):
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions
    opts = RunOptions({"model": model, "dt": str(BI_DT), "noise": "white",
                       "max-iterations": str(ITERS), "dtype": "single",
                       "noise-pattern": pattern, **(extra or {})})
    return VBInference(get_model_class(model)(opts), opts, None,
                       data_plane=plane, device=device)


def posterior_check(name, got, ref, bound_sd, min_frac, rel_bound=1e-3):
    """Means within bound_sd posterior sd of the plain version in at
    least min_frac of the voxels (a non-finite error is an outlier);
    over those voxels every other output within rel_bound of its max.
    Returns (ok, max_abs_err over the inliers, worst error/bound)."""
    import torch
    p = ref[0].shape[0]
    sd = torch.sqrt(torch.stack([ref[2][i, i] for i in range(p)]))
    e = ((got[0] - ref[0]).abs() / sd).amax(dim=0)
    inl = torch.nan_to_num(e, nan=float("inf")) <= bound_sd
    frac = float(inl.float().mean())
    n_out = int((~inl).sum())
    ok = frac >= min_frac
    abs_err = float((got[0] - ref[0]).abs()[:, inl].max())
    ratio = float(e[inl].max()) / bound_sd
    worst_rel = 0.0
    for g, r in zip(got[1:], ref[1:]):
        g, r = g[..., inl].double(), r[..., inl].double()
        scale = float(r.abs().max())
        d = float((g - r).abs().max())
        worst_rel = max(worst_rel, d / scale if scale > 0 else d)
        abs_err = max(abs_err, d)
    ok = ok and worst_rel <= rel_bound
    ratio = max(ratio, worst_rel / rel_bound)
    log(f"  {name:<30} means/sd<={bound_sd:g} in {frac:.6f} of voxels "
        f"(bound >= {min_frac:g}; {n_out} outliers); others max rel "
        f"{worst_rel:.3g} (bound {rel_bound:g}) {'ok' if ok else 'FAIL'}")
    return ok, abs_err, ratio


def fit_quality(model, transforms, means, clean):
    """Fraction of voxels whose model fit lies within 3 noise sd of the
    noiseless signal at every sample, and the fit [T,V]."""
    import torch
    from fabber_core_tpu_torch.ops import fused_vb as fv
    t = fv.time_index(clean.shape[0], torch.float32, clean.device)
    fit, _ = fv.block_eval(model.time_signal_jac, transforms, means, t)
    err = torch.nan_to_num((fit - clean).abs().amax(dim=0), nan=float("inf"))
    return float((err <= 3 * BI_SD).float().mean()), fit


def canonical_dist(m1, m2):
    """Per voxel, the largest difference of the biexp (amp, rate)
    latent pairs, each sorted by the rate latent (the model's exchange
    symmetry); inf where either is not finite."""
    import torch

    def canon(m):
        m = m.double()
        pairs = torch.stack([m[0:2], m[2:4]])            # [2,2,V]
        swap = (pairs[0, 1] > pairs[1, 1])[None]
        return torch.cat([torch.where(swap, pairs[1], pairs[0]),
                          torch.where(swap, pairs[0], pairs[1])])
    return torch.nan_to_num((canon(m1) - canon(m2)).abs().amax(dim=0),
                            nan=float("inf"))


def canonical_close(m1, m2, tol=2e-2):
    """Fraction of voxels whose sorted biexp parameters agree within
    tol."""
    return float((canonical_dist(m1, m2) < tol).float().mean())


def check_nl_kernels(device, nvs=(1_048_576, 1_000_003), seed=SEED + 3):
    """Phase 3b: the nonlinear kernels against their plain versions at
    the biexp path's shapes (T=100; exp P=2 and biexp P=4; one noise
    group and the pattern 12; a power-of-two and a ragged voxel count),
    on bench.py's biexp data with the engine's own start and priors.

    Stated bounds (both sides float32, different summation orders):
      fused_nl_loop, exp, 10 iterations: means within 1e-3 posterior sd
        in every voxel, prec/cov/b/c/F quadratics 1e-3 of their max;
      fused_nl_loop, biexp, 2 iterations: the same in >= 99.9% of
        voxels, outliers counted; biexp, 10 iterations: see
        check_biexp_10_iterations. Ten iterations from the engine's
        start are not comparable voxel by voxel: the first update, at
        the tiny initial noise precision, lands every voxel near the
        prior mean where the two components are exchangeable, and the
        fixed point there is ill-conditioned, so summation order alone
        settles many voxels in different basins (the plain version at
        float32 and at float64 agree on 63-67% of voxels, the JAX
        package's two routes on ~80% of tests/test_fused_loop_nl.py's
        data);
      fused_vb_iter, one iteration from the latent truth + N(0, 0.05^2):
        means within 1e-3 posterior sd in every exp voxel and >= 99.9%
        of biexp voxels, the other outputs 1e-3 of their max."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_vb as fv

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    worst = {"fused_nl_loop": [0.0, 0.0], "fused_vb_iter": [0.0, 0.0]}
    ok_all = True

    def note(kname, res):
        nonlocal ok_all
        ok, abs_err, ratio = res
        ok_all &= ok
        worst[kname][0] = max(worst[kname][0], abs_err)
        worst[kname][1] = max(worst[kname][1], ratio)

    for model in ("exp", "biexp"):
        for pattern in ("1", "12"):
            for nv in nvs:
                log(f" {model} Q={len(set(pattern))} T={BI_NT} V={nv}")
                data, clean, truth = biexp_plane(nv, gen, device, model)
                eng = nl_engine(model, pattern, data, device)
                tr = eng._transforms()
                args = eng.nl_loop_args(eng.initial_state())
                strict = model == "exp"
                n_strict = ITERS if strict else 2
                k = fl.fused_nl_loop(eng.model, tr, *args, n_strict, True)
                r = fl.fused_nl_loop_plain(eng.model.time_signal_jac, tr,
                                           *args, n_strict, True)
                torch.cuda.synchronize()
                note("fused_nl_loop", posterior_check(
                    f"fused_nl_loop {n_strict} its", k, r, 1e-3,
                    1.0 if strict else 0.999))
                del k, r
                if not strict:
                    ok_all &= check_biexp_10_iterations(eng, tr, args,
                                                        clean)
                # kernel 7: one iteration from the latent truth
                lat = torch.log(truth) + 0.05 * torch.randn(
                    truth.shape, generator=gen, device=device)
                nq = len(args[4])
                phi = torch.full((nq, nv), 1.0 / BI_SD ** 2, device=device)
                it_args = (lat, args[1], args[2], phi, args[3], args[4],
                           True)
                k = fv.fused_iteration(eng.model, tr, *it_args)
                r = fv.fused_iteration_plain(eng.model.time_signal_jac, tr,
                                             *it_args)
                torch.cuda.synchronize()
                note("fused_vb_iter", posterior_check(
                    "fused_vb_iter 1 it", k, r, 1e-3,
                    1.0 if strict else 0.999))
                del k, r, data, clean, truth, eng, args, lat, phi, it_args
                torch.cuda.empty_cache()
    return ok_all, worst


def check_biexp_10_iterations(eng, tr, args, clean):
    """Phase 3b's biexp whole-loop check at the engine's 10 iterations,
    held on the voxels float32 rounding does not move: those where the
    plain version at float32 and at float64 agree (sorted parameters
    within 2e-2). There the kernel must agree with float64 too, in
    >= BIEXP_STABLE_AGREE of them, outliers counted. The fit-quality
    gap to the plain version is printed beside it, not held: it moves
    with summation order."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    ts = eng.model.time_signal_jac
    k = fl.fused_nl_loop(eng.model, tr, *args, ITERS, True)[0]
    r32 = fl.fused_nl_loop_plain(ts, tr, *args, ITERS, True)[0]
    args64 = tuple(a.double() if torch.is_tensor(a) else a
                   for a in args)
    r64 = fl.fused_nl_loop_plain(ts, tr, *args64, ITERS, True)[0]
    stable = canonical_dist(r32, r64) < 2e-2
    k_off = stable & ~(canonical_dist(k, r64) < 2e-2)
    frac = 1.0 - float(k_off.sum()) / max(int(stable.sum()), 1)
    fk = fit_quality(eng.model, tr, k, clean)[0]
    fp = fit_quality(eng.model, tr, r32, clean)[0]
    ok = frac >= BIEXP_STABLE_AGREE
    log(f"  fused_nl_loop {ITERS} its: {float(stable.float().mean()):.5f} "
        f"of voxels stable (plain float32 = float64); the kernel agrees "
        f"with float64 in {frac:.6f} of them (bound >= "
        f"{BIEXP_STABLE_AGREE}; {int(k_off.sum())} outliers); fit within "
        f"3 sd {fk:.5f} (kernel) / {fp:.5f} (plain float32), gap "
        f"{fp - fk:+.5f} {'ok' if ok else 'FAIL'}")
    return ok


def make_biexp_volume(shape, seed=SEED + 4):
    """Phase 4c input: bench.py's biexp data as a [nx,ny,nz,T] float32
    volume from numpy, and its noiseless signal [V,T]."""
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    t = np.arange(BI_NT, dtype=np.float32) * BI_DT
    amp = rng.uniform(0.5, 1.5, (nv, 1)).astype(np.float32)
    clean = amp * np.exp(-t)[None] + 0.5 * amp * np.exp(-5.0 * t)[None]
    data = clean + BI_SD * rng.standard_normal((nv, BI_NT), dtype=np.float32)
    return data.reshape(shape + (BI_NT,), order="F"), clean


BIEXP_OPTIONS = {"model": "biexp", "dt": str(BI_DT), "noise": "white",
                 "method": "vb", "max-iterations": str(ITERS),
                 "dtype": "single", "save-mean": True, "save-std": True,
                 "save-noise-mean": True, "save-model-fit": True,
                 "save-residuals": True, "allow-bad-voxels": True}


def run_biexp_path(device, shape=(128, 128, 64)):
    """Phase 4c: biexp through run_with_data on a whole volume. Bounds:
    kernel 6 launched, in its staged form (and kernel 7 not); every
    output of the volume's shape and finite, except in voxels whose
    means or sds overflow float32 in model space, at most 1% (0.2% of
    8,192 voxels on the CPU, 0.24% of the volume on the H100; the
    model-space output is the JAX package's own unguarded float32 cast,
    ROADMAP Queue 3 fault 4); residuals = data - fit; median noise sd
    within 5% of 0.05; the fit within 3 noise sd of the noiseless
    signal at every sample in >= 70% of voxels. Not 99%: ten iterations
    from the model's start leave ~20% of voxels unconverged or in a poor
    basin and ~3% numerically failed (allow-bad-voxels degrades those to
    the zero-mean posterior), on the CPU too (0.776 of 4,096 voxels with
    the plain version, 0.681 with the JAX package's XLA route)."""
    from fabber_core_tpu_torch.api import FabberTpu
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_vb as fv

    vol, clean = make_biexp_volume(shape)
    log(f" volume {shape + (BI_NT,)}: {vol.nbytes / 1e6:.0f} MB float32")
    fl.fused_nl_loop.launches = fl.fused_nl_loop.staged_launches = 0
    fv.fused_iteration.launches = 0
    t0 = time.perf_counter()
    run = FabberTpu(device=device).run_with_data(BIEXP_OPTIONS,
                                                 {"data": vol})
    secs = time.perf_counter() - t0
    launches = {"fused_nl_loop": fl.fused_nl_loop.launches,
                "fused_vb_iter": fv.fused_iteration.launches}
    staged = fl.fused_nl_loop.staged_launches
    log(f" run_with_data: {secs:.3f} s; launches {launches}, "
        f"{staged} in the staged form")
    ok = (launches["fused_nl_loop"] >= 1 and launches["fused_vb_iter"] == 0
          and staged == launches["fused_nl_loop"])
    ok &= check_biexp_outputs(run, vol, clean, shape,
                              ["amp1", "r1", "amp2", "r2"])
    return ok, launches, secs


def check_biexp_outputs(run, vol, clean, shape, names):
    """Phase 4c's checks of a biexp run_with_data (the run_biexp_path
    docstring's bounds)."""
    want = ({f"mean_{n}" for n in names} | {f"std_{n}" for n in names}
            | {"noise_means", "modelfit", "residuals"})
    if set(run.data) != want:
        log(f" FAIL outputs {sorted(run.data)}")
        return False
    ok = True
    # a voxel whose latent means or variances left float32's range in
    # model space (exp(x) > 3.4e38: a diverged fit) has an infinite
    # mean_* or std_* output, and its fit need not be finite either;
    # every other voxel's outputs must be finite
    nv = int(np.prod(shape))
    over = np.zeros(shape, bool)
    for n in names:
        over |= ~np.isfinite(run.data[f"mean_{n}"])
        over |= ~np.isfinite(run.data[f"std_{n}"])
    for key, arr in run.data.items():
        want_shape = shape + (BI_NT,) if key in ("modelfit", "residuals") \
            else shape
        fin = np.isfinite(arr).reshape(shape + (-1,)).all(axis=-1)
        if arr.shape != want_shape or not fin[~over].all():
            log(f" FAIL {key}: shape {arr.shape}, non-finite outside the "
                f"overflowed voxels {int((~fin & ~over).sum())}")
            ok = False
    n_over = int(over.sum())
    log(f" voxels whose means or sds overflow float32 in model space: "
        f"{n_over} "
        f"(bound <= 1% = {nv // 100})")
    ok &= n_over <= nv // 100
    fit = run.data["modelfit"].reshape(-1, BI_NT, order="F")
    resid_err = float(np.nanmax(np.abs(run.data["residuals"] - (
        vol - run.data["modelfit"]))))
    within = float((np.abs(fit - clean).max(axis=1) <= 3 * BI_SD).mean())
    noise_sd = float(np.median(1 / np.sqrt(run.data["noise_means"])))
    log(f" fit within 3 noise sd of the noiseless signal: {within:.5f} of "
        f"voxels (bound >= 0.70); median noise sd {noise_sd:.5f} (truth "
        f"0.05, bound 5%); residual - (data - fit) max {resid_err:.3g}")
    return ok and within >= 0.70 and abs(noise_sd / BI_SD - 1) <= 0.05 \
        and resid_err <= 1e-5


def check_exp_engine_vs_f64(device, nv=4096):
    """Phase 4d: the float32 exp engine on the card (whole-loop kernel)
    against a float64 reference of the same route on a small input: the
    plain whole-loop function at float64 on the CPU with the engine's
    own inputs. Bounds: means 1e-2 posterior sd, cov and noise
    precision 1e-3 relative, F 1e-2 absolute; iterations equal."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)
    data, _, _ = biexp_plane(nv, gen, device, "exp")
    eng = nl_engine("exp", "1", data, device, {"save-free-energy": True})
    g = eng.run()
    args = eng.nl_loop_args(eng.initial_state())
    args64 = tuple(a.double().cpu() if torch.is_tensor(a) else a
                   for a in args)
    means, prec, cov, b, c, fkqk, ftr = fl.fused_nl_loop_plain(
        eng.model.time_signal_jac, eng._transforms(), *args64, ITERS, True)
    from fabber_core_tpu_torch.noise.white import WhiteNoiseState
    prior = WhiteNoiseState(eng.noise_prior.b.double().cpu(),
                            eng.noise_prior.c.double().cpu())
    f = eng.noise.free_energy_from_parts(
        WhiteNoiseState(b, c), prior, means, prec, cov, args64[1],
        args64[2], list(fkqk), list(ftr)).numpy()
    m = means.T.numpy()
    cv = cov.permute(2, 0, 1).numpy()
    noise = (b * c)[0].numpy()
    sd = np.sqrt(np.diagonal(cv, axis1=1, axis2=2))
    errs = {"means/sd": float(np.max(np.abs(g.means - m) / sd)),
            "cov": float(np.max(np.abs(g.cov - cv) / np.abs(cv).max())),
            "noise": float(np.max(np.abs(g.noise_means[:, 0] - noise)
                                  / noise)),
            "F": float(np.max(np.abs(g.free_energy - f)))}
    bounds = {"means/sd": 1e-2, "cov": 1e-3, "noise": 1e-3, "F": 1e-2}
    ok = all(errs[k] <= bounds[k] for k in errs) and \
        not g.bad_voxels.any() and (g.iterations == ITERS).all()
    log(f" card exp engine vs float64 reference, {nv} voxels: {errs} "
        f"bounds {bounds} {'ok' if ok else 'FAIL'}")
    return ok


def check_per_iteration_route(device, nv=65_536):
    """Phase 4e: the per-iteration route (engine-kernel=pallas) on the
    biexp data at 65,536 voxels: kernel 7 launched once per iteration
    (10), and the result against the whole-loop route's on the same
    data. Bound: the fraction of voxels whose fit is within 3 noise sd
    of the noiseless signal within 0.03 between the routes, and the
    sorted parameters agreeing in >= 50% of voxels (the two plain
    routes agree in 68% of 8,192 such voxels on the CPU: see phase 3b
    on why biexp is compared so)."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)
    data, clean, _ = biexp_plane(nv, gen, device)
    res = {}
    for mode in ("pallas", "auto"):
        eng = nl_engine("biexp", "1", data, device, {"engine-kernel": mode})
        fl.fused_nl_loop.launches = 0
        fv.fused_iteration.launches = 0
        r = eng.run()
        res[mode] = (eng.route, fv.fused_iteration.launches,
                     fl.fused_nl_loop.launches,
                     torch.as_tensor(r.means.T.copy(), device=device))
    good = {m: fit_quality(eng.model, eng._transforms(), res[m][3],
                           clean)[0] for m in res}
    agree = canonical_close(res["pallas"][3], res["auto"][3])
    ok = (res["pallas"][0] == "pallas" and res["pallas"][1] == ITERS
          and res["pallas"][2] == 0 and res["auto"][0] == "pallas-loop-nl"
          and res["auto"][2] == 1 and abs(good["pallas"] - good["auto"])
          <= 0.03 and agree >= 0.5)
    log(f" per-iteration route: {res['pallas'][1]} fused_vb_iter launches "
        f"(want {ITERS}); fit within 3 sd {good['pallas']:.5f} vs "
        f"whole-loop {good['auto']:.5f} (bound |diff| <= 0.03); sorted "
        f"parameters agree in {agree:.5f} (bound >= 0.5) "
        f"{'ok' if ok else 'FAIL'}")
    return ok, res["pallas"][1]


def best_ms(fn, reps=3, keep=False):
    """Best of `reps` CUDA-event timings of fn(), after one warm-up;
    with keep, (best, the last timed call's result)."""
    import torch
    fn()
    torch.cuda.synchronize()
    best, res = float("inf"), None
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return (best, res) if keep else best


def time_forms(run, reps=3):
    """Kernels 6 and 8 in their two forms (csrc/tile.cuh) on the same
    inputs: run(vb) launches with the plan's form (vb None: staged at
    T=100) or the streamed one (vb 0), timed in turns (streamed, staged,
    staged, streamed; each best of reps after a warm-up). Returns (staged
    ms, streamed ms, the last staged result, the last streamed
    result)."""
    t, res = {None: [], 0: []}, {}
    for vb in (0, None, None, 0):
        ms, res[vb] = best_ms(lambda: run(vb), reps=reps, keep=True)
        t[vb].append(ms)
    return min(t[None]), min(t[0]), res[None], res[0]


def ptxas_entry(text, *parts):
    """'N registers, S B spill stores' of the kernel entry whose mangled
    name holds every string of parts, from nvcc's -Xptxas -v output."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and all(x in line for x in parts):
            regs, spill = "?", "?"
            for nxt in lines[i + 1:i + 6]:
                if "spill stores" in nxt:
                    spill = nxt.split("bytes stack frame,")[-1].split(
                        "bytes spill stores")[0].strip()
                if "Used" in nxt and "registers" in nxt:
                    regs = nxt.split("Used")[1].split("registers")[0].strip()
                    break
            return f"{regs} registers, {spill} B spill stores"
    return "not found"


def log_forms(name, nt, nq, occ, ptx):
    """One line per kernel of phases 5b, 5c, 5e, 5g: the plan
    (ops/_cuda.py tile_plan), the blocks per SM of each form (occ(vb),
    cudaOccupancyMaxActiveBlocksPerMultiprocessor) and ptxas's registers
    and spills of each form (ptx(staged))."""
    from fabber_core_tpu_torch.ops import _cuda
    staged, vb, smem = _cuda.tile_plan(nt, nq)
    log(f"  {name}: plan staged={staged} VB={vb} smem={smem} B, "
        f"{occ(vb if staged else 0)} blocks/SM ({ptx(True)}); streamed "
        f"{occ(0)} blocks/SM of {_cuda.STREAM_THREADS} ({ptx(False)})")
    return {"vb": vb, "smem": smem, "staged_blocks_per_sm":
            occ(vb if staged else 0), "streamed_blocks_per_sm": occ(0)}


def time_headline(device, card, nv=16_777_216):
    """Phase 5: kernels, plain versions, copy probe and the whole
    engine run at the README's headline size, with the [T,V] plane
    made on the card and passed as data_plane."""
    import torch
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.options import RunOptions

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    design = poly_design(3)
    plane, _ = gen_plane(design, nv, gen, [100.0, 0.5, 0.005], 1.0, device)
    opts = RunOptions({k: v for k, v in MAIN_OPTIONS.items()
                       if not k.startswith("save")})
    eng = VBInference(get_model_class("poly")(opts), opts, None,
                      data_plane=plane, device=device)
    p = eng.nparams
    q = np.ones(NT)
    tc = fs.pack_mxu_consts(design, q, NT, torch.float32, device)
    ac = fs.pack_solve_consts(design, q, NT, torch.float32)
    sc = fs.pack_spectral_consts(design, q, NT, np.full(p, 1e-12), 1e-6,
                                 (NT - 1) * 0.5 + 1e-6, 1e-8, 50.0,
                                 torch.float32, (-100.0, 53.5))
    stats = fs.spectral_stats(plane, tc, ac)
    pm = torch.zeros((p, nv), dtype=torch.float32, device=device)
    fig = {}
    fig["stats_ms"] = best_ms(lambda: fs.spectral_stats(plane, tc, ac))
    fig["stats_plain_ms"] = best_ms(
        lambda: fs.spectral_stats_plain(plane, tc, ac))
    fig["core_ms"] = best_ms(lambda: fs.spectral_core(*stats, pm, sc, ITERS))
    fig["core_plain_ms"] = best_ms(
        lambda: fs.spectral_core_plain(*stats, pm, sc, ITERS))
    dst = torch.empty_like(plane)
    fig["copy_ms"] = best_ms(lambda: dst.copy_(plane))
    del dst, stats, pm
    torch.cuda.empty_cache()
    eng.run()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    fig["run_s"] = time.perf_counter() - t0
    if res.bad_voxels.any() or not np.isfinite(res.means).all():
        raise RuntimeError("headline run produced bad voxels")

    data_bytes = 4 * NT * nv
    copy_gbs = 2 * data_bytes / fig["copy_ms"] / 1e6
    stats_bytes = data_bytes + 4 * (2 * p + 1) * nv
    core_bytes = 4 * ((3 * p + 1) + (2 * p * p + p + 4)) * nv
    fig["copy_GBps"] = copy_gbs
    fig["stats_GBps"] = stats_bytes / fig["stats_ms"] / 1e6
    fig["core_GBps"] = core_bytes / fig["core_ms"] / 1e6
    fig["stats_share_of_copy_bw"] = fig["stats_GBps"] / copy_gbs
    fig["core_share_of_copy_bw"] = fig["core_GBps"] / copy_gbs
    fig["run_voxels_per_s"] = nv / fig["run_s"]
    for k, v in fig.items():
        log(f" {k} = {v!r}  [V={nv} T={NT} P={p}; {card}]")
    return fig


def time_biexp(device, card, nv=4_000_000):
    """Phase 5b: the nonlinear kernels, their plain versions, a copy
    probe and the whole engine run at bench.py's biexp size (4,000,000
    voxels, T=100, P=4), data made on the card; kernel 6 in its staged
    and streamed forms (time_forms), with their plan, occupancy and
    registers, and whether their outputs agree bit for bit (nvcc
    contracts multiply-adds in kernel 6, so they need not)."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_vb as fv

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    plane, _, truth = biexp_plane(nv, gen, device)
    eng = nl_engine("biexp", "1", plane, device)
    tr = eng._transforms()
    args = eng.nl_loop_args(eng.initial_state())
    phi = torch.full((1, nv), 1.0 / BI_SD ** 2, device=device)
    lat = torch.log(truth).contiguous()
    it_args = (lat, args[1], args[2], phi, args[3], args[4], True)
    ts = eng.model.time_signal_jac
    fig = {}
    fig["nl_loop_ms"], fig["nl_loop_streamed_ms"], ks, kt = time_forms(
        lambda vb: fl.fused_nl_loop(eng.model, tr, *args, ITERS, True,
                                    _vb=vb))
    fig["nl_loop_staged_bits_equal_streamed"] = bits_equal(ks, kt)
    fig["nl_loop_forms"] = log_forms(
        "fused_nl_loop ExpSum<2> Q=1 MODE 0", BI_NT, 1,
        lambda vb: _cuda.nl_occupancy(1, 4, 1, 0, vb, BI_NT),
        lambda st: ptxas_entry(_cuda.build_log, "fused_nl_loop_kernel",
                               f"ExpSumILi2EEELi1ELi0ELb{int(st)}E"))
    del ks, kt
    fig["nl_loop_plain_ms"] = best_ms(
        lambda: fl.fused_nl_loop_plain(ts, tr, *args, ITERS, True))
    fig["vb_iter_ms"] = best_ms(lambda: fv.fused_iteration(eng.model, tr,
                                                           *it_args))
    fig["vb_iter_plain_ms"] = best_ms(
        lambda: fv.fused_iteration_plain(ts, tr, *it_args))
    dst = torch.empty_like(plane)
    fig["copy_ms"] = best_ms(lambda: dst.copy_(plane))
    del dst, phi, lat, it_args
    torch.cuda.empty_cache()
    eng.run()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    fig["run_s"] = time.perf_counter() - t0
    data_bytes = 4 * BI_NT * nv
    fig["copy_GBps"] = 2 * data_bytes / fig["copy_ms"] / 1e6
    # the whole-loop kernel reads the column n_iters + 1 times
    fig["nl_loop_data_GBps"] = (ITERS + 1) * data_bytes / \
        fig["nl_loop_ms"] / 1e6
    fig["nl_loop_share_of_copy_bw"] = fig["nl_loop_data_GBps"] / \
        fig["copy_GBps"]
    fig["run_voxels_per_s"] = nv / fig["run_s"]
    for k, v in fig.items():
        log(f" {k} = {v!r}  [V={nv} T={BI_NT} P=4; {card}]")
    return fig


# ---------------------------------------------------------------------------
# Detector modes (phases 3c, 4f, 4g, 4h, 5c)
# ---------------------------------------------------------------------------

def make_detector(kind, extra=None):
    from fabber_core_tpu_torch.inference.convergence import \
        get_detector_class
    from fabber_core_tpu_torch.options import RunOptions
    return get_detector_class(kind)(RunOptions(
        {"max-iterations": str(ITERS), **(extra or {})}))


class TripCounter:
    """A detector that counts, over the calls of its test, the lanes
    still running before each test: in a plain loop that is the number
    of lane iterations this run's data needs (the operation count of a
    kernel whose lanes leave their loops when done)."""

    def __init__(self, det):
        self.det = det
        self.trips = 0

    def __getattr__(self, name):
        return getattr(self.det, name)

    def test(self, state, f):
        self.trips += int((~state.done).sum())
        return self.det.test(state, f)


def trip_counter(det):
    """A TripCounter that the plain versions take for det (they read
    the detector's kind from its class)."""
    cls = type("Counted" + type(det).__name__, (TripCounter,),
               {"name": type(det).name})
    return cls(det)


def lane_rel(got, ref):
    """Per lane, the error of one output in the lane's own scale (the
    largest over its elements): a [P,P,V] matrix (prec, cov) element by
    element over sqrt(|ref_ii ref_jj|); a row over |ref|, or over
    max(|ref|, 1) where the row changes sign across lanes (F, in nats:
    at 0 it has no scale of its own). Returns [V] float64."""
    import torch
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    if ref.dim() == 3 and ref.shape[0] == ref.shape[1]:
        dg = torch.stack([ref[i, i] for i in range(ref.shape[0])]).abs()
        scale = torch.sqrt(dg[:, None] * dg[None, :])
    else:
        mixed = ((ref > 0).any(dim=-1, keepdim=True)
                 & (ref < 0).any(dim=-1, keepdim=True))
        scale = torch.where(mixed, ref.abs().clamp_min(1.0), ref.abs())
    err = err / scale.clamp_min(1e-30)
    return err.reshape(-1, err.shape[-1]).amax(dim=0)


def lane_errors(a, r64):
    """Per output, the [V] errors of the outputs a against the plain
    version at float64: the means over float64's posterior sd, the
    others in each lane's own scale (lane_rel)."""
    import torch
    p = r64[0].shape[0]
    sd = torch.sqrt(torch.stack([r64[2][i, i] for i in range(p)])).double()
    means = ((a[0].double() - r64[0].double()).abs() / sd).amax(dim=0)
    return [means] + [lane_rel(a[i], r64[i]) for i in range(1, len(a))]


def near_f64(name, k, r32, r64, dk=None, d32=None, d64=None, tol=1e-2):
    """A kernel against its plain version at float64. With decisions
    dk/d32/d64 [2,V] (iteration count, revert; a detector mode), the
    share of lanes whose decisions differ from float64 at most twice the
    plain float32 version's own share + 1e-3. On the lanes where both
    agree with float64: the means within max(1e-3, 2x the plain float32
    distance) posterior sd of float64, every other output within
    max(1e-3, 2x the plain float32 distance) of its max; and in each
    lane's own scale (lane_errors: noise sd and precisions span six
    decades over the lanes of phase 3d, so a scale shared by the lanes
    would hide a wrong low-noise lane) —
      without decisions: each output's worst lane within max(1e-3, 2x
      the plain float32 version's worst);
      with decisions: a lane is off where an output lies beyond tol of
      float64 (an lm step taken or refused, or a revert that is no
      output, moves a lane's state without a decision to show it): the
      kernel's share of lanes off at most twice the plain float32
      version's own + 1e-3.
    Returns (ok, max abs error on the lanes whose decisions agree, worst
    ratio to its bound)."""
    import torch
    if dk is None:
        keep = torch.ones(r64[0].shape[-1], dtype=torch.bool,
                          device=r64[0].device)
        ratios, labels = [], []
    else:
        miss_k = (dk != d64).any(dim=0)
        miss_32 = (d32 != d64).any(dim=0)
        keep = ~(miss_k | miss_32)
        ratios = [float(miss_k.double().mean())
                  / (2 * float(miss_32.double().mean()) + 1e-3)]
        labels = ["decision share"]
    e_k = [e[keep] for e in lane_errors(k, r64)]
    e_32 = [e[keep] for e in lane_errors(r32, r64)]

    def rel_max(a, i):
        ref = r64[i][..., keep].double()
        return float((a[i][..., keep].double() - ref).abs().max()
                     / ref.abs().max().clamp_min(1e-30))

    ratios.append(float(e_k[0].max()) / max(1e-3, 2 * float(e_32[0].max())))
    labels.append("means")
    for i in range(1, len(k)):
        ratios.append(rel_max(k, i) / max(1e-3, 2 * rel_max(r32, i)))
        labels.append(f"output {i} over its max")
    if dk is None:
        ratios += [float(a.max()) / max(1e-3, 2 * float(b.max()))
                   for a, b in zip(e_k, e_32)]
        labels += [f"output {i}'s worst lane" for i in range(len(e_k))]
        lanes = ""
    else:
        def share_off(e):
            return float((~(torch.stack(e).amax(dim=0) <= tol)).double()
                         .mean())
        off_k, off_32 = share_off(e_k), share_off(e_32)
        ratios.append(off_k / (2 * off_32 + 1e-3))
        labels.append("share of lanes off")
        lanes = (f"; decisions off float64 (kernel or plain) in "
                 f"{1 - float(keep.double().mean()):.6f} of lanes; beyond "
                 f"{tol:g} in the lane's scale in {off_k:.6f} of the rest "
                 f"(plain float32 {off_32:.6f})")
    ok = all(r <= 1.0 for r in ratios)          # False where NaN
    ratio, label = max((r if r == r else float("inf"), lb)
                       for r, lb in zip(ratios, labels))
    abs_err = max(float((a[..., keep].double() - r[..., keep].double())
                        .abs().max()) for a, r in zip(k, r64)) \
        if bool(keep.any()) else 0.0
    log(f"  {name:<34} worst err/bound {ratio:.3g} ({label}){lanes}; "
        f"max abs err {abs_err:.4g} {'ok' if ok else 'FAIL'}")
    return ok, abs_err, ratio


def lane_decisions(name, k, r32, r64, sl):
    """A detector mode at a full horizon, where float32 decisions are
    chaotic (biexp: Queue 3 item 7 of ROADMAP.md), held by its lanes'
    decisions: the iteration count and whether the means are finite.
    The kernel k and the plain version at float32 r32 cover every lane,
    the plain version at float64 r64 the lanes sl. Passes when the
    kernel's share of lanes in sl whose decisions differ from float64 is
    at most twice the plain float32 version's own + 1e-3, and its share
    of non-finite lanes over every lane lies within [0.8, 1.25] times the
    plain float32 version's, +-1e-3 (float32 lm diverges on ~4.5% of
    bench.py's biexp lanes, float64 on ~0.7%: a kernel fault that
    diverges where the plain version does not moves that share)."""
    import torch

    def nonfinite(o):
        return ~torch.isfinite(o[0]).all(dim=0)

    def dec(o, lanes):
        return torch.stack([o[6][0][lanes].double(),
                            nonfinite(o)[lanes].double()])

    d64 = dec(r64, slice(None))
    share_k = float((dec(k, sl) != d64).any(dim=0).double().mean())
    share_32 = float((dec(r32, sl) != d64).any(dim=0).double().mean())
    nf_k, nf_32 = nonfinite(k), nonfinite(r32)
    frac_k, frac_32 = float(nf_k.double().mean()), float(nf_32.double().mean())
    frac_64 = float(nonfinite(r64).double().mean())
    both = int((nf_k & nf_32).sum())
    ok = (share_k <= 2 * share_32 + 1e-3
          and 0.8 * frac_32 - 1e-3 <= frac_k <= 1.25 * frac_32 + 1e-3)
    log(f"  {name:<34} decisions off float64 (first {d64.shape[1]} lanes) "
        f"in {share_k:.6f} of lanes (plain float32 {share_32:.6f}; bound "
        f"{2 * share_32 + 1e-3:.6f}); non-finite means in {frac_k:.6f} of "
        f"lanes (plain float32 {frac_32:.6f}, bound x[0.8, 1.25] +-1e-3; "
        f"float64 {frac_64:.6f}), {both} lanes non-finite in both "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def check_detector_kernels(device, nvs=(1_048_576, 1_000_003),
                           seed=SEED + 8):
    """Phase 3c: the three detector modes against their plain versions
    on the card, held by near_f64:
      spectral_core (2d) at the main path's poly shapes under
        pointzeroone, freduce and trialmode (max-iterations 10,
        max-trials 10, loop bound max_iterations + 2), on the statistics
        kernel's output;
      fused_nl_loop (6d) on bench.py's biexp data with the engine's own
        start, priors and ELBO constants: exp under all four detectors
        at max-iterations 10, biexp under all four at a short horizon
        (max-iterations 3, max-trials 2; float32 biexp is chaotic
        further out);
      fused_vb_iter (7l) one launch from the latent truth + N(0, 0.05^2)
        with alpha 0 in a quarter of the voxels and 1e-6..1e2 elsewhere
        (no decisions: every lane held)."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import smallmat as sm

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    worst = {k: [0.0, 0.0] for k in ("spectral_core:detector",
                                     "fused_nl_loop:detector",
                                     "fused_vb_iter:lm")}
    ok_all = True

    def note(kname, res):
        nonlocal ok_all
        ok, abs_err, ratio = res
        ok_all &= ok
        worst[kname][0] = max(worst[kname][0], abs_err)
        worst[kname][1] = max(worst[kname][1], ratio)

    # 2d
    p, design = 3, poly_design(3)
    q = np.ones(NT)
    c_post = (NT - 1) * 0.5 + 1e-6
    from fabber_core_tpu_torch.ops.spectral import eigen_elbo_const
    tc = fs.pack_mxu_consts(design, q, NT, torch.float32, device)
    ac = fs.pack_solve_consts(design, q, NT, torch.float32)
    sc = fs.pack_spectral_consts(
        design, q, NT, np.full(p, 1e-12), 1e-6, c_post, 1e-8, 50.0,
        torch.float32, (eigen_elbo_const(q, c_post, 1e-6, 1e6, p),
                        c_post + 0.5))
    for nv in nvs:
        data, _ = gen_plane(design, nv, gen, [100.0, 0.5, 0.005], 1.0,
                            device)
        stats = fs.spectral_stats(data, tc, ac)
        del data
        pm = torch.zeros((p, nv), device=device)
        stats64 = tuple(x.double() for x in stats)
        for kind in fs.DETECTOR_KINDS:
            det = make_detector(kind)
            cap = int(det.max_iterations) + 2
            k = fs.spectral_core(*stats, pm, sc, cap, det)
            r32 = fs.spectral_core_plain(*stats, pm, sc, cap, det)
            r64 = fs.spectral_core_plain(*stats64, pm.double(), sc.double(),
                                         cap, det)
            torch.cuda.synchronize()

            def dec(o):
                return torch.stack([o[6][0].double(),
                                    (o[3][0] < 0).double()])

            def tidy(o):
                return (o[0], o[1], o[2], o[3].abs()) + tuple(o[4:])

            note("spectral_core:detector", near_f64(
                f"spectral_core {kind} P={p} V={nv}", tidy(k), tidy(r32),
                tidy(r64), dec(k), dec(r32), dec(r64)))
            del k, r32, r64
        del stats, stats64, pm
        torch.cuda.empty_cache()

    # 6d
    nv = nvs[-1]
    for model, extra in (("exp", {}), ("biexp", {"max-iterations": "3",
                                                 "max-trials": "2"})):
        data, clean, truth = biexp_plane(nv, gen, device, model)
        for kind in fl.DETECTOR_KINDS:
            eng = nl_engine(model, "1", data, device,
                            {"convergence": kind, **extra})
            tr = eng._transforms()
            s0 = eng.initial_state()
            args = eng.nl_loop_args(s0)
            det = eng._nl_fdet_consts()
            pd0 = sm.diag_of(s0.post.cov).contiguous()
            n_it = int(eng.detector.max_iterations)
            kw = dict(detector=det, post_var0=pd0)
            k = fl.fused_nl_loop(eng.model, tr, *args, n_it, True, **kw)
            ts = eng.model.time_signal_jac
            r32 = fl.fused_nl_loop_plain(ts, tr, *args, n_it, True, **kw)
            args64 = tuple(a.double() if torch.is_tensor(a) else a
                           for a in args)
            r64 = fl.fused_nl_loop_plain(ts, tr, *args64, n_it, True,
                                         detector=det,
                                         post_var0=pd0.double())
            torch.cuda.synchronize()

            def dec(o):
                rev = o[5][1] if kind == "freduce" else 0 * o[6][0]
                return torch.stack([o[6][0].double(), rev.double()])

            note("fused_nl_loop:detector", near_f64(
                f"fused_nl_loop {model} {kind} V={nv}", k, r32, r64,
                dec(k), dec(r32), dec(r64)))
            del k, r32, r64, args, args64, eng, s0, pd0
            torch.cuda.empty_cache()

        # 7l
        eng = nl_engine(model, "1", data, device, {"convergence": "lm"})
        tr = eng._transforms()
        args = eng.nl_loop_args(eng.initial_state())
        lat = torch.log(truth) + 0.05 * torch.randn(
            truth.shape, generator=gen, device=device)
        phi = torch.full((1, nv), 1.0 / BI_SD ** 2, device=device)
        alpha = 10.0 ** (torch.rand(nv, generator=gen, device=device) * 8
                         - 6)
        alpha[::4] = 0.0
        it_args = (lat, args[1], args[2], phi, args[3], args[4], True)
        k = fv.fused_iteration(eng.model, tr, *it_args, alpha)
        ts = eng.model.time_signal_jac
        r32 = fv.fused_iteration_plain(ts, tr, *it_args, alpha)
        r64 = fv.fused_iteration_plain(ts, tr, *(
            a.double() if torch.is_tensor(a) else a for a in it_args),
            alpha.double())
        torch.cuda.synchronize()
        note("fused_vb_iter:lm", near_f64(
            f"fused_vb_iter lm {model} V={nv}", k, r32, r64))
        del k, r32, r64, data, clean, truth, lat, phi, alpha, eng, args
        torch.cuda.empty_cache()
    return ok_all, worst


def capture_results(cls=None):
    """Wrap cls.run (default VBInference.run) so that a run through the
    API leaves its engine and VBResult here (the API returns volumes,
    not iteration counts)."""
    if cls is None:
        from fabber_core_tpu_torch.inference.vb import VBInference as cls
    captured = []
    orig = cls.run

    def run(self, *a, **kw):
        res = orig(self, *a, **kw)
        captured.append((self, res))
        return res
    cls.run = run
    return captured, lambda: setattr(cls, "run", orig)


def its_histogram(its):
    counts = np.bincount(np.asarray(its, np.int64))
    return {int(i): int(c) for i, c in enumerate(counts) if c}


def run_biexp_trialmode_path(device, shape=(128, 128, 64)):
    """Phase 4f: biexp through run_with_data under
    --convergence=trialmode (max-iterations 10, max-trials 10): kernel
    6 launched once, in detector mode and its staged form, and kernel 7
    not at all; the
    bounds of phase 4c on the outputs, fit quality and noise; no lane
    reports more iterations than the detector's bound
    (max_iterations)."""
    from fabber_core_tpu_torch.api import FabberTpu
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_vb as fv

    vol, clean = make_biexp_volume(shape)
    opts = {**BIEXP_OPTIONS, "convergence": "trialmode"}
    fl.fused_nl_loop.launches = fl.fused_nl_loop.det_launches = 0
    fl.fused_nl_loop.staged_launches = 0
    fv.fused_iteration.launches = 0
    captured, restore = capture_results()
    t0 = time.perf_counter()
    try:
        run = FabberTpu(device=device).run_with_data(opts, {"data": vol})
    finally:
        restore()
    secs = time.perf_counter() - t0
    launches = {"fused_nl_loop:detector": fl.fused_nl_loop.det_launches}
    eng, res = captured[-1]
    hist = its_histogram(res.iterations)
    log(f" run_with_data: {secs:.3f} s; fused_nl_loop launches "
        f"{fl.fused_nl_loop.launches} (detector mode "
        f"{fl.fused_nl_loop.det_launches}, staged "
        f"{fl.fused_nl_loop.staged_launches}), fused_vb_iter "
        f"{fv.fused_iteration.launches}; route: "
        f"{eng.route_description()}")
    log(f" iterations histogram {hist} (bound {eng.detector.max_iterations})")
    ok = (fl.fused_nl_loop.det_launches == 1
          and fl.fused_nl_loop.launches == 1
          and fl.fused_nl_loop.staged_launches == 1
          and fv.fused_iteration.launches == 0
          and int(res.iterations.max()) <= eng.detector.max_iterations
          and int(res.iterations.min()) >= 1)
    nv = int(np.prod(shape))
    over = ~(np.isfinite(res.means).all(axis=1))
    names = ["amp1", "r1", "amp2", "r2"]
    mover = np.zeros(shape, bool)
    for n in names:
        mover |= ~np.isfinite(run.data[f"mean_{n}"])
        mover |= ~np.isfinite(run.data[f"std_{n}"])
    n_over = int(mover.sum())
    fit = run.data["modelfit"].reshape(-1, BI_NT, order="F")
    within = float((np.abs(fit - clean).max(axis=1) <= 3 * BI_SD).mean())
    noise_sd = float(np.median(1 / np.sqrt(run.data["noise_means"])))
    log(f" fit within 3 noise sd of the noiseless signal: {within:.5f} of "
        f"voxels (bound >= 0.70); median noise sd {noise_sd:.5f} (truth "
        f"0.05, bound 5%); model-space overflow {n_over} voxels (bound "
        f"<= {nv // 100}); non-finite latent means {int(over.sum())}")
    ok &= (within >= 0.70 and abs(noise_sd / BI_SD - 1) <= 0.05
           and n_over <= nv // 100)
    return ok, launches, secs, hist


def run_poly_trialmode_path(device, shape=(128, 128, 64)):
    """Phase 4g: poly degree 2 (T=106) through run_with_data under
    --convergence=trialmode: the statistics kernel and the core
    kernel's detector mode each launched once; c0 within 3 posterior sd
    of truth in >= 99% of voxels and the median noise sd within 5% of
    1, as phase 4."""
    from fabber_core_tpu_torch.api import FabberTpu
    from fabber_core_tpu_torch.ops import fused_spectral as fs

    vol, c0 = make_volume(shape)
    fs.spectral_stats.launches = 0
    fs.spectral_core.launches = fs.spectral_core.det_launches = 0
    captured, restore = capture_results()
    t0 = time.perf_counter()
    try:
        run = FabberTpu(device=device).run_with_data(
            {**MAIN_OPTIONS, "convergence": "trialmode"}, {"data": vol})
    finally:
        restore()
    secs = time.perf_counter() - t0
    eng, res = captured[-1]
    launches = {"spectral_stats": fs.spectral_stats.launches,
                "spectral_core:detector": fs.spectral_core.det_launches}
    log(f" run_with_data: {secs:.3f} s; launches {launches}; route: "
        f"{eng.route_description()}")
    log(f" iterations histogram {its_histogram(res.iterations)}")
    within = np.abs(run.data["mean_c0"] - c0) <= 3 * run.data["std_c0"]
    frac = float(within.mean())
    noise_sd = float(np.median(1 / np.sqrt(run.data["noise_means"])))
    log(f" c0 within 3 posterior sd of truth: {frac:.5f} of voxels "
        f"(bound >= 0.99); median noise sd {noise_sd:.4f} (truth 1)")
    ok = (launches["spectral_stats"] == 1
          and launches["spectral_core:detector"] == 1
          and fs.spectral_core.launches == 1
          and all(np.isfinite(a).all() for a in run.data.values())
          and frac >= 0.99 and abs(noise_sd - 1.0) < 0.05)
    return ok, launches, secs


def check_per_iteration_lm(device, nv=65_536):
    """Phase 4h: the per-iteration route under lm (engine-kernel=pallas,
    biexp, 65,536 voxels): kernel 7 launched with its LM branch once
    per iteration of the engine's while loop, and the result against
    the whole-loop route under lm on the same data, held as phase 4e."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 9)
    data, clean, _ = biexp_plane(nv, gen, device)
    res = {}
    for mode in ("pallas", "auto"):
        eng = nl_engine("biexp", "1", data, device,
                        {"engine-kernel": mode, "convergence": "lm"})
        fl.fused_nl_loop.launches = fl.fused_nl_loop.det_launches = 0
        fv.fused_iteration.launches = fv.fused_iteration.lm_launches = 0
        r = eng.run()
        res[mode] = (eng.route, fv.fused_iteration.lm_launches,
                     fv.fused_iteration.launches,
                     fl.fused_nl_loop.det_launches,
                     torch.as_tensor(r.means.T.copy(), device=device),
                     r.iterations, eng.max_iter_cap)
    good = {m: fit_quality(eng.model, eng._transforms(), res[m][4],
                           clean)[0] for m in res}
    agree = canonical_close(res["pallas"][4], res["auto"][4])
    n_lm = res["pallas"][1]
    ok = (res["pallas"][0] == "pallas" and n_lm == res["pallas"][2]
          and 1 <= n_lm <= res["pallas"][6] and res["auto"][3] == 1
          and res["auto"][0] == "pallas-loop-nl"
          and abs(good["pallas"] - good["auto"]) <= 0.03 and agree >= 0.5)
    log(f" per-iteration route under lm: {n_lm} fused_vb_iter launches, "
        f"all with the LM branch (one per iteration of the engine's while "
        f"loop, cap {res['pallas'][6]}); iterations "
        f"{its_histogram(res['pallas'][5])}; fit within 3 sd "
        f"{good['pallas']:.5f} vs whole-loop {good['auto']:.5f} (bound "
        f"|diff| <= 0.03); sorted parameters agree in {agree:.5f} (bound "
        f">= 0.5) {'ok' if ok else 'FAIL'}")
    return ok, n_lm


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and float32 operations over its float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nl_pass_ops(p, nq, nexp, kind):
    """float32 operations per voxel and sample of one pass of the
    nonlinear kernels (expf counted as one): 'A' the iteration pass
    (model, J'QJ, J'Qr, r'Qr), 'B' the per-iteration kernel's k pass,
    'F' the free-energy pass."""
    nt = p * (p + 1) // 2
    model = 6 * nexp + p
    if kind == "A":
        return model + 1 + nq * (1 + p + 2 * nt + 2 * p + 2)
    if kind == "B":
        return model + 1 + 2 * p + 1 + 2 * nq
    return model + 1 + 1 + nq * (2 + p + 2 * nt)


def time_detectors(device, card, fig, fig_nl, nv_poly=16_777_216,
                   nv_bi=4_000_000):
    """Phase 5c: the detector modes at the headline sizes (CUDA events,
    best of 3 after a warm-up; the plain versions best of 1 after a
    warm-up): spectral_core under trialmode at 16,777,216 poly voxels
    beside its maxits time (phase 5); fused_nl_loop under trialmode
    and lm at 4,000,000 biexp voxels beside its maxits time (phase 5b),
    its lanes held to the plain version by lane_decisions; one
    fused_vb_iter launch with the LM branch; VBInference.run() of biexp
    under trialmode. The iteration histograms are the kernels' own (the
    last timed launch), the plain version's beside them; the pass counts
    behind the bounds are the plain version's. fused_nl_loop's detector
    modes in their staged and streamed forms (time_forms); MODE 1's plan
    and registers logged beside. Returns (ok, figures)."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import smallmat as sm
    from fabber_core_tpu_torch.ops.spectral import eigen_elbo_const

    out, ok = {}, True
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    p, design = 3, poly_design(3)
    q = np.ones(NT)
    c_post = (NT - 1) * 0.5 + 1e-6
    plane, _ = gen_plane(design, nv_poly, gen, [100.0, 0.5, 0.005], 1.0,
                         device)
    tc = fs.pack_mxu_consts(design, q, NT, torch.float32, device)
    ac = fs.pack_solve_consts(design, q, NT, torch.float32)
    sc = fs.pack_spectral_consts(
        design, q, NT, np.full(p, 1e-12), 1e-6, c_post, 1e-8, 50.0,
        torch.float32, (eigen_elbo_const(q, c_post, 1e-6, 1e6, p),
                        c_post + 0.5))
    stats = fs.spectral_stats(plane, tc, ac)
    del plane
    pm = torch.zeros((p, nv_poly), dtype=torch.float32, device=device)
    det = make_detector("trialmode")
    cap = int(det.max_iterations) + 2
    out["core_det_ms"], k = best_ms(
        lambda: fs.spectral_core(*stats, pm, sc, cap, det), keep=True)
    out["core_det_its"] = its_histogram(k[6][0].cpu().numpy())
    del k
    counter = trip_counter(det)
    r = fs.spectral_core_plain(*stats, pm, sc, cap, counter)
    out["core_det_plain_ms"] = best_ms(
        lambda: fs.spectral_core_plain(*stats, pm, sc, cap, det), reps=1)
    core_bytes = 4 * ((3 * p + 1) + (2 * p * p + p + 4)) * nv_poly
    core_ops = (10 * p * p + 12 * p + 2 * p * p + 3 * p ** 3 + 40) * nv_poly \
        + (12 * p + 30) * counter.trips
    out["core_det_bound"] = bound(core_bytes, core_ops)
    out["core_maxits_bound"] = bound(
        core_bytes, (10 * p * p + 12 * p + 2 * p * p + 3 * p ** 3 + 40
                     + (ITERS - 1) * (9 * p + 5)) * nv_poly)
    out["stats_bound"] = bound(4 * NT * nv_poly
                               + 4 * (2 * p + 1) * nv_poly,
                               (6 * p + 2) * NT * nv_poly)
    del stats, pm, r
    torch.cuda.empty_cache()

    gen.manual_seed(SEED + 7)
    plane, _, truth = biexp_plane(nv_bi, gen, device)
    nl_bytes = 4 * BI_NT * nv_bi + 4 * (3 * 4 + 4 + 2 * 16 + 4) * nv_bi
    a_ops = nl_pass_ops(4, 1, 2, "A") * BI_NT
    f_ops = nl_pass_ops(4, 1, 2, "F") * BI_NT
    out["nl_maxits_bound"] = bound(nl_bytes,
                                   (ITERS * a_ops + f_ops + 200 * ITERS)
                                   * nv_bi)
    out["nl_mode1_forms"] = log_forms(
        "fused_nl_loop ExpSum<2> Q=1 MODE 1", BI_NT, 1,
        lambda vb: _cuda.nl_occupancy(1, 4, 1, 1, vb, BI_NT),
        lambda st: ptxas_entry(_cuda.build_log, "fused_nl_loop_kernel",
                               f"ExpSumILi2EEELi1ELi1ELb{int(st)}E"))
    for kind in ("trialmode", "lm"):
        eng = nl_engine("biexp", "1", plane, device, {"convergence": kind})
        tr = eng._transforms()
        s0 = eng.initial_state()
        args = eng.nl_loop_args(s0)
        det = eng._nl_fdet_consts()
        n_it = int(eng.detector.max_iterations)
        out[f"nl_{kind}_ms"], out[f"nl_{kind}_streamed_ms"], k, _ = \
            time_forms(lambda vb: fl.fused_nl_loop(
                eng.model, tr, *args, n_it, True, detector=det, _vb=vb))
        out[f"nl_{kind}_forms"] = log_forms(
            f"fused_nl_loop ExpSum<2> Q=1 MODE 2 ({kind})", BI_NT, 1,
            lambda vb: _cuda.nl_occupancy(1, 4, 1, 2, vb, BI_NT),
            lambda st: ptxas_entry(_cuda.build_log, "fused_nl_loop_kernel",
                                   f"ExpSumILi2EEELi1ELi2ELb{int(st)}E"))
        out[f"nl_{kind}_its"] = its_histogram(k[6][0].cpu().numpy())
        ts = eng.model.time_signal_jac
        counter = trip_counter(eng.detector)
        cdet = {**det, "det": counter}
        r = fl.fused_nl_loop_plain(ts, tr, *args, n_it, True, detector=cdet)
        out[f"nl_{kind}_plain_its"] = its_histogram(r[6][0].cpu().numpy())
        out[f"nl_{kind}_plain_ms"] = best_ms(
            lambda: fl.fused_nl_loop_plain(ts, tr, *args, n_it, True,
                                           detector=det), reps=1)
        # the plain version at float64 on a slice of the lanes (each
        # lane's loop is its own, so a slice gives the same lanes)
        sl = slice(0, F64_LANES)
        r64 = fl.fused_nl_loop_plain(
            ts, tr, *(a[..., sl].double() for a in args[:4]), *args[4:],
            n_it, True, detector=det)
        ok &= lane_decisions(f"fused_nl_loop biexp {kind} V={nv_bi}", k, r,
                             r64, sl)
        # model passes of the plain version: pass 0 of every lane plus
        # one per test of a lane still running (the last of which is the
        # F pass's)
        passes = nv_bi + counter.trips
        out[f"nl_{kind}_plain_passes_per_voxel"] = passes / nv_bi
        out[f"nl_{kind}_bound"] = bound(nl_bytes, passes * (a_ops + 300))
        del k, r, r64, args, s0
        torch.cuda.empty_cache()
    # one LM launch of the per-iteration kernel
    args = eng.nl_loop_args(eng.initial_state())
    phi = torch.full((1, nv_bi), 1.0 / BI_SD ** 2, device=device)
    lat = torch.log(truth).contiguous()
    alpha = torch.full((nv_bi,), 1e-3, device=device)
    it_args = (lat, args[1], args[2], phi, args[3], args[4], True)
    out["vb_iter_lm_ms"] = best_ms(lambda: fv.fused_iteration(
        eng.model, tr, *it_args, alpha))
    out["vb_iter_lm_plain_ms"] = best_ms(lambda: fv.fused_iteration_plain(
        eng.model.time_signal_jac, tr, *it_args, alpha), reps=1)
    vb_ops = (nl_pass_ops(4, 1, 2, "A") + nl_pass_ops(4, 1, 2, "B")
              + nl_pass_ops(4, 1, 2, "F")) * BI_NT + 400
    vb_bytes = 4 * BI_NT * nv_bi + 4 * (3 * 4 + 1 + 4 + 2 * 16 + 4) * nv_bi
    out["vb_iter_bound"] = bound(vb_bytes, vb_ops * nv_bi)
    out["vb_iter_lm_bound"] = bound(vb_bytes + 4 * nv_bi,
                                    (vb_ops + 100) * nv_bi)
    del phi, lat, alpha, it_args, args
    torch.cuda.empty_cache()
    # the whole engine run under trialmode
    eng = nl_engine("biexp", "1", plane, device, {"convergence": "trialmode"})
    eng.run()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    out["run_trialmode_s"] = time.perf_counter() - t0
    out["run_trialmode_voxels_per_s"] = nv_bi / out["run_trialmode_s"]
    out["run_trialmode_its"] = its_histogram(res.iterations)
    for k, v in out.items():
        log(f" {k} = {v!r}  [{card}]")
    log(f" beside: spectral_core maxits {fig['core_ms']!r} ms, "
        f"fused_nl_loop maxits {fig_nl['nl_loop_ms']!r} ms, fused_vb_iter "
        f"{fig_nl['vb_iter_ms']!r} ms (phases 5, 5b)")
    return ok, out


# ---------------------------------------------------------------------------
# The fixed-design statistics routes (phases 3d, 4i-4l, 5d)
# ---------------------------------------------------------------------------

def group_masks(nq, masked=False, nt=NT):
    """[Q,T] indicators of the noise pattern '12..Q' (timepoint t in
    group t mod Q); masked drops samples 6 and 61 from every group."""
    q = np.zeros((nq, nt))
    q[np.arange(nt) % nq, np.arange(nt)] = 1.0
    if masked:
        q[:, [5, 60]] = 0.0
    return q


def pattern_plane(design, nq, nv, gen, device,
                  scale=(1.0, 0.05, 5e-4, 1.0)):
    """[T,V] float32 plane D @ truth + noise whose sd varies per voxel
    (log-uniform over 1e-2..3, so detector lanes stop apart) and grows
    with the group (x1, x2, x3 for the groups of the pattern 123)."""
    import torch
    nt, p = design.shape
    d = torch.as_tensor(design, dtype=torch.float32, device=device)
    truth = (torch.rand((p, nv), generator=gen, device=device) * 2 - 1) \
        * torch.as_tensor(scale[:p], dtype=torch.float32,
                          device=device)[:, None]
    sd = 10.0 ** (torch.rand(nv, generator=gen, device=device) * 2.5 - 2)
    gfac = torch.as_tensor(1.0 + np.arange(nt) % nq, dtype=torch.float32,
                           device=device)
    plane = torch.randn((nt, nv), generator=gen, device=device)
    plane.mul_(gfac[:, None]).mul_(sd[None])
    plane.addmm_(d, truth)
    return plane


def whole_inputs(design, q, plane, device):
    """Kernel 4's inputs for the poly priors (mean 0, precision 1e-12):
    (data, tconsts, consts, prior_means, prior_prec)."""
    import torch
    from fabber_core_tpu_torch.ops import fused_whole as fw
    p, nv = design.shape[1], plane.shape[1]
    nq = q.shape[0]
    tc = fw.pack_whole_time_consts(design, q, NT, torch.float32, device)
    consts = fw.pack_whole_consts(design, q, NT, np.full(nq, 1e6),
                                  np.full(nq, 1e-6), q.sum(axis=1), 1e-8,
                                  50.0)
    pm = torch.zeros((p, nv), dtype=torch.float32, device=device)
    pp = torch.full((p, nv), 1e-12, dtype=torch.float32, device=device)
    return plane, tc, consts, pm, pp


def whole_detector(kind, p, nq, masked=False):
    """Kernel 4's detector dict (the host ELBO constants of an engine on
    the CPU with the same groups, max-iterations 10) and the engine's
    loop cap."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions
    extra = {"mt1": "6", "mt2": "61"} if masked else {}
    opts = RunOptions({"model": "poly", "degree": str(p - 1),
                       "noise": "white", "dtype": "single",
                       "convergence": kind, "max-iterations": str(ITERS),
                       "noise-pattern": "123"[:nq], **extra})
    eng = VBInference(get_model_class("poly")(opts), opts,
                      np.ones((4, NT), np.float32), device="cpu")
    return eng._nl_fdet_consts(), eng.max_iter_cap


def to64(args):
    return tuple(a.double() if hasattr(a, "double") else a for a in args)


def check_fixed_design_kernels(device, nvs=(1_048_576, 1_000_003),
                               seed=SEED + 10):
    """Phase 3d: the fixed-design kernels against their plain versions
    at the main path's poly shapes (P=3, T=106), each held by near_f64
    (the plain version at float64 beside the plain float32 one):
      fused_whole (4) in maxits at Q = 1, 2, 3 (Q=3 with two masked
        timepoints) and with a locked noise sd (Q=2, masked);
      fused_whole's detector modes pointzeroone, trialmode and lm (4d,
        4l) at Q = 1, 2, at the engine's loop cap, by decision share;
      fused_vb_loop (5) at Q = 1, 2 from the plain statistics;
      spectral_fused (3) in maxits and trialmode, against the split
        pair (kernels 1 + 2) bit for bit and against its plain version.
    Voxel noise sd varies over 1e-2..3 (detector lanes stop apart); the
    truth is c0 ~ U(-1, 1), c1 ~ U(-0.05, 0.05), c2 ~ U(-5e-4, 5e-4)."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.ops import fused_whole as fw
    from fabber_core_tpu_torch.ops.spectral import eigen_elbo_const

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    worst = {k: [0.0, 0.0] for k in ("spectral_fused", "fused_whole",
                                     "fused_whole:detector",
                                     "fused_whole:lm", "fused_vb_loop")}
    ok_all = True

    def note(kname, res):
        nonlocal ok_all
        ok, abs_err, ratio = res
        ok_all &= ok
        worst[kname][0] = max(worst[kname][0], abs_err)
        worst[kname][1] = max(worst[kname][1], ratio)

    p, design = 3, poly_design(3)
    for nv in nvs:
        for nq, masked, locked in ((1, False, -1.0), (2, False, -1.0),
                                   (3, True, -1.0), (2, True, 0.2)):
            q = group_masks(nq, masked)
            plane = pattern_plane(design, nq, nv, gen, device)
            args = whole_inputs(design, q, plane, device)
            k = fw.fused_whole(*args, ITERS, locked)
            r32 = fw.fused_whole_plain(*args, ITERS, locked)
            r64 = fw.fused_whole_plain(*to64(args), ITERS, locked)
            torch.cuda.synchronize()
            tag = f"Q={nq}{' masked' if masked else ''}" \
                f"{' locked' if locked > 0 else ''} V={nv}"
            note("fused_whole", near_f64(f"fused_whole {tag}", k, r32, r64))
            del k, r32, r64
            if nq <= 2 and locked < 0:
                stats = tuple(x.contiguous() for x in fw.whole_stats_plain(
                    plane, args[1], args[2], p, nq))
                rest = (args[2], args[3], args[4], ITERS)
                k = fl.fused_vb_loop(*stats, *rest)
                r32 = fl.fused_vb_loop_plain(*stats, *rest)
                r64 = fl.fused_vb_loop_plain(*to64(stats), args[2],
                                             args[3].double(),
                                             args[4].double(), ITERS)
                torch.cuda.synchronize()
                note("fused_vb_loop", near_f64(f"fused_vb_loop {tag}", k,
                                               r32, r64))
                del k, r32, r64, stats
            if nq <= 2 and not masked:
                for kind in ("pointzeroone", "trialmode", "lm"):
                    det, cap = whole_detector(kind, p, nq)
                    k = fw.fused_whole(*args, cap, -1.0, det)
                    r32 = fw.fused_whole_plain(*args, cap, -1.0, det)
                    r64 = fw.fused_whole_plain(*to64(args), cap, -1.0, det)
                    torch.cuda.synchronize()

                    def dec(o):
                        return torch.stack([o[6][0].double(),
                                            0 * o[6][0].double()])

                    kname = "fused_whole:lm" if kind == "lm" \
                        else "fused_whole:detector"
                    note(kname, near_f64(f"fused_whole {kind} {tag}", k, r32,
                                         r64, dec(k), dec(r32), dec(r64)))
                    del k, r32, r64
            del plane, args
            torch.cuda.empty_cache()

        q1 = np.ones(NT)
        c_post = (NT - 1) * 0.5 + 1e-6
        tc = fs.pack_mxu_consts(design, q1, NT, torch.float32, device)
        ac = fs.pack_solve_consts(design, q1, NT, torch.float32)
        sc = fs.pack_spectral_consts(
            design, q1, NT, np.full(p, 1e-12), 1e-6, c_post, 1e-8, 50.0,
            torch.float32, (eigen_elbo_const(q1, c_post, 1e-6, 1e6, p),
                            c_post + 0.5))
        data, _ = gen_plane(design, nv, gen, [100.0, 0.5, 0.005], 1.0,
                            device)
        pm = torch.zeros((p, nv), dtype=torch.float32, device=device)
        for kind in (None, "trialmode"):
            det = None if kind is None else make_detector(kind)
            n_it = ITERS if det is None else int(det.max_iterations) + 2
            k = fs.spectral_fused(data, tc, ac, pm, sc, n_it, det)
            split = fs.spectral_core(*fs.spectral_stats(data, tc, ac), pm,
                                     sc, n_it, det)
            same = all(torch.equal(a, b) for a, b in zip(k, split))
            del split
            r32 = fs.spectral_fused_plain(data, tc, ac, pm, sc, n_it, det)
            r64 = fs.spectral_fused_plain(data.double(), tc, ac, pm.double(),
                                          sc, n_it, det)
            torch.cuda.synchronize()

            def dec(o):
                return None if det is None else torch.stack(
                    [o[6][0].double(), (o[3][0] < 0).double()])

            def tidy(o):
                return (o[0], o[1], o[2], o[3].abs()) + tuple(o[4:])

            log(f"  spectral_fused {kind or 'maxits'} V={nv}: the split "
                f"pair's outputs bit for bit: {same}")
            ok_all &= same
            note("spectral_fused", near_f64(
                f"spectral_fused {kind or 'maxits'} V={nv}", tidy(k),
                tidy(r32), tidy(r64), dec(k), dec(r32), dec(r64)))
            del k, r32, r64
        del data, pm
        torch.cuda.empty_cache()
    return ok_all, worst


PATTERN_OPTIONS = {**MAIN_OPTIONS, "noise-pattern": "12"}


def make_pattern_volume(shape, seed=SEED + 11):
    """Phases 4i, 4j, 4l input: poly degree 2 with c0 ~ U(0.5, 1.5),
    c1 ~ U(-0.05, 0.05), c2 ~ U(-5e-4, 5e-4) and white noise of sd 0.1
    and 0.2 on alternate timepoints, from numpy. (At c0 ~ 100 with noise
    sd 0.1 the float32 routes sit up to 3.6e-2 posterior sd from float64
    on the CPU alike: the uncentred Gram of ROADMAP Queue 3 item 5.)"""
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    truth = np.stack([rng.uniform(0.5, 1.5, nv), rng.uniform(-0.05, 0.05, nv),
                      rng.uniform(-5e-4, 5e-4, nv)]).astype(np.float32)
    sd = np.where(np.arange(NT) % 2 == 0, 0.1, 0.2).astype(np.float32)
    data = (poly_design(3).astype(np.float32) @ truth).T
    data += sd[None, :] * rng.standard_normal((nv, NT), dtype=np.float32)
    return data.reshape(shape + (NT,), order="F")


def launch_counts():
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import fused_whole as fw
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    return {"fused_ar_loop": fa.fused_ar_loop.launches,
            "fused_ar_loop:detector": fa.fused_ar_loop.det_launches,
            "fused_nlls": fn.fused_nlls_loop.launches,
            "fused_nlls:resume": fn.fused_nlls_loop.resume_launches,
            "fused_nlls:marquardt": fn.fused_nlls_loop.marquardt_launches,
            "fused_nlls:staged": fn.fused_nlls_loop.staged_launches,
            "spectral_stats": fs.spectral_stats.launches,
            "spectral_core": fs.spectral_core.launches,
            "spectral_fused": fs.spectral_fused.launches,
            "fused_whole": fw.fused_whole.launches,
            "fused_whole:detector": fw.fused_whole.det_launches,
            "fused_whole:lm": fw.fused_whole.lm_launches,
            "fused_vb_loop": fl.fused_vb_loop.launches,
            "fused_nl_loop": fnl.fused_nl_loop.launches,
            "fused_nl_loop:generic": fnl.fused_nl_loop.generic_launches,
            "fused_nl_loop:staged": fnl.fused_nl_loop.staged_launches,
            "fused_vb_iter": fv.fused_iteration.launches}


def reset_launches():
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.ops import fused_loop_nl as fnl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import fused_whole as fw
    for f in (fs.spectral_stats, fs.spectral_core, fs.spectral_fused,
              fw.fused_whole, fl.fused_vb_loop, fnl.fused_nl_loop,
              fv.fused_iteration, fn.fused_nlls_loop):
        f.launches = 0
    fs.spectral_core.det_launches = fs.spectral_fused.det_launches = 0
    fw.fused_whole.det_launches = fw.fused_whole.lm_launches = 0
    fnl.fused_nl_loop.det_launches = 0
    fnl.fused_nl_loop.generic_launches = 0
    fnl.fused_nl_loop.staged_launches = 0
    fv.fused_iteration.lm_launches = 0
    fn.fused_nlls_loop.resume_launches = 0
    fn.fused_nlls_loop.marquardt_launches = 0
    fn.fused_nlls_loop.staged_launches = 0
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    fa.fused_ar_loop.launches = fa.fused_ar_loop.det_launches = 0


def api_run(device, options, vol, extra_data=None):
    """run_with_data with its launch counters zeroed just before and
    read just after: (run, VBResult, engine, launches, seconds);
    extra_data: more data keys (suppdata)."""
    from fabber_core_tpu_torch.api import FabberTpu
    captured, restore = capture_results()
    reset_launches()
    t0 = time.perf_counter()
    try:
        run = FabberTpu(device=device).run_with_data(
            options, {"data": vol, **(extra_data or {})})
    finally:
        restore()
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    eng, res = captured[-1]
    log(f" {eng.route_description()}: {secs:.3f} s; launches {launches}")
    return run, res, eng, launches, secs


def voxel_errors(res, ref):
    """Per voxel, against the reference run ref: the largest |means -
    ref means| over ref's posterior sd, the largest |std / ref std - 1|
    over the parameters and the largest |noise / ref noise - 1| over
    the groups' noise precision means. Returns the three [V] arrays."""
    sd = np.sqrt(np.diagonal(ref.cov, axis1=1, axis2=2))
    sd_res = np.sqrt(np.diagonal(res.cov, axis1=1, axis2=2))
    return (np.max(np.abs(res.means - ref.means) / sd, axis=1),
            np.max(np.abs(sd_res / sd - 1), axis=1),
            np.max(np.abs(res.noise_means / ref.noise_means - 1), axis=1))


def against_f64(name, res, ref, bound=1e-2):
    """Phases 4i and 4l: every voxel's means within bound posterior sd
    of the float64 run, its std and noise within bound relative."""
    e_m, e_s, e_n = voxel_errors(res, ref)
    good = (max(e_m.max(), e_s.max(), e_n.max()) <= bound
            and not res.bad_voxels.any())
    log(f" {name} against float64, in every voxel: means within "
        f"{e_m.max():.4g} posterior sd (p99.9 {np.quantile(e_m, 0.999):.3g}"
        f"), std within {e_s.max():.3g} and noise within {e_n.max():.3g} "
        f"relative (bound {bound:g} each) {'ok' if good else 'FAIL'}")
    return good


def detector_against_f64(name, res, ref, bound=1e-2):
    """Phase 4j: a detector's decisions are discontinuous and the
    revert flag is no output, so the share of voxels whose iteration
    count differs from the float64 run's, or whose means, std, noise
    (voxel_errors) or F lie beyond bound of it, is at most 1e-3."""
    e_m, e_s, e_n = voxel_errors(res, ref)
    other = res.iterations != ref.iterations
    off = (other | (e_m > bound) | (e_s > bound) | (e_n > bound)
           | (np.abs(res.free_energy - ref.free_energy) > bound))
    good = float(off.mean()) <= 1e-3 and not res.bad_voxels.any()
    log(f" {name} float32 against float64: {int(off.sum())} voxels off "
        f"({off.mean():.3g}; bound 1e-3), of them {int(other.sum())} with "
        f"another iteration count; iterations {its_histogram(res.iterations)}"
        f" (float64 {its_histogram(ref.iterations)}) "
        f"{'ok' if good else 'FAIL'}")
    return good


def run_pattern_paths(device, shape=(128, 128, 64)):
    """Phases 4i, 4j, 4l on one 128x128x64 x 106 volume with the noise
    pattern 12 (make_pattern_volume), each through run_with_data:
      4i  float32 (auto: the whole-program kernel): fused_whole launched
          once and no spectral kernel; in every voxel the posterior
          means within 1e-2 posterior sd of the float64 run (the 'xla'
          route, plain torch on the card, no kernel launched), the std
          and both groups' noise within 1e-2 relative; both groups'
          median noise sd within 5% of the truth (0.1, 0.2);
      4j  --convergence=trialmode (kernel 4's detector mode, launched
          once) and --convergence=lm (its lm mode, launched once), each
          at float32 and at float64 ('xla', no kernel), held by
          detector_against_f64;
      4l  --engine-kernel=pallas-loop (kernel 5, launched once, from
          make_design_stats in plain torch): against the float64 run as
          4i.
    Returns (ok, launches per kernel)."""
    vol = make_pattern_volume(shape)
    nv = int(np.prod(shape))
    log(f" volume {shape + (NT,)}: {vol.nbytes / 1e6:.0f} MB float32, "
        "noise sd 0.1 / 0.2 on alternate timepoints")
    ok, launches = True, {}
    log("phase 4i: run_with_data, noise-pattern=12")
    run, res, eng, n32, _ = api_run(device, PATTERN_OPTIONS, vol)
    launches["fused_whole"] = n32.get("fused_whole", 0)
    ok &= (eng.route == "pallas-whole" and n32 == {"fused_whole": 1})
    _, r64, eng64, n64, _ = api_run(device, {**PATTERN_OPTIONS,
                                             "dtype": "double"}, vol)
    ok &= eng64.route == "xla" and not n64
    nsd = np.median(1 / np.sqrt(run.data["noise_means"].reshape(nv, -1)),
                    axis=0)
    good = (abs(nsd[0] / 0.1 - 1) <= 0.05 and abs(nsd[1] / 0.2 - 1) <= 0.05
            and all(np.isfinite(a).all() for a in run.data.values()))
    log(f" median noise sd {nsd[0]:.5f} / {nsd[1]:.5f} (truth 0.1 / 0.2, "
        f"bound 5%) {'ok' if good else 'FAIL'}")
    ok &= good and against_f64("float32", res, r64)

    log("phase 4j: the same volume under trialmode and lm, at float32 and "
        "float64")
    for kind in ("trialmode", "lm"):
        opts = {**PATTERN_OPTIONS, "convergence": kind}
        _, rd, engd, nd, _ = api_run(device, opts, vol)
        want = {"fused_whole": 1, "fused_whole:detector": 1}
        if kind == "lm":
            want["fused_whole:lm"] = 1
            launches["fused_whole:lm"] = nd.get("fused_whole:lm", 0)
        else:
            launches["fused_whole:detector"] = nd.get(
                "fused_whole:detector", 0)
        ok &= engd.route == "pallas-whole" and nd == want
        _, rd64, engd64, nd64, _ = api_run(device, {**opts, "dtype": "double"},
                                           vol)
        ok &= engd64.route == "xla" and not nd64
        ok &= detector_against_f64(kind, rd, rd64)

    log("phase 4l: the same volume, engine-kernel=pallas-loop")
    _, rp, engp, npl, _ = api_run(device, {**PATTERN_OPTIONS,
                                           "engine-kernel": "pallas-loop"},
                                  vol)
    launches["fused_vb_loop"] = npl.get("fused_vb_loop", 0)
    ok &= engp.route == "pallas-loop" and npl == {"fused_vb_loop": 1}
    ok &= against_f64("kernel 5", rp, r64)
    return ok, launches


def run_linear_path(device, shape=(128, 128, 32)):
    """Phase 4k: the linear model (P=4 synthetic_design, T=106, written
    by this script to a VEST file under build/) through run_with_data
    with --spectral-impl=fused: spectral_fused launched once and no
    other kernel; each parameter within 3 posterior sd of the truth in
    >= 99% of voxels; median noise sd within 5% of 1."""
    from pathlib import Path
    from fabber_core_tpu_torch.io import matfile
    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    design = synthetic_design()
    path = str(out / "linear_design.mat")
    matfile.write_vest(design, path)
    rng = np.random.default_rng(SEED + 12)
    nv = int(np.prod(shape))
    truth = rng.uniform(-1, 1, (4, nv)) * np.array([[10.0], [5.0], [2.0],
                                                     [2.0]])
    data = (design.astype(np.float32) @ truth.astype(np.float32)).T
    data += rng.standard_normal((nv, NT), dtype=np.float32)
    vol = data.reshape(shape + (NT,), order="F")
    opts = {**MAIN_OPTIONS, "model": "linear", "basis": path,
            "spectral-impl": "fused"}
    opts.pop("degree")
    run, res, eng, n, _ = api_run(device, opts, vol)
    ok = eng.route == "spectral-fused" and n == {"spectral_fused": 1}
    fracs = []
    for i in range(4):
        m = run.data[f"mean_Parameter_{i + 1}"].reshape(-1, order="F")
        s = run.data[f"std_Parameter_{i + 1}"].reshape(-1, order="F")
        fracs.append(float((np.abs(m - truth[i]) <= 3 * s).mean()))
    nsd = float(np.median(1 / np.sqrt(run.data["noise_means"])))
    good = min(fracs) >= 0.99 and abs(nsd - 1) <= 0.05
    log(f" linear P=4: parameters within 3 posterior sd of truth in "
        f"{[round(f, 5) for f in fracs]} of voxels (bound >= 0.99); median "
        f"noise sd {nsd:.4f} (truth 1, bound 5%) {'ok' if good else 'FAIL'}")
    return ok and good, {"spectral_fused": n.get("spectral_fused", 0)}


def whole_ops(p, nq, iters, det=False):
    """float32 operations per voxel of kernel 4 (iters=None: kernel 5's
    fixed point alone), counted from its arithmetic: the two statistics
    passes, the m0 solve, and per iteration the precision, Cholesky,
    inverse, means, noise quadratics (and, in a detector mode, F)."""
    ntri = p * (p + 1) // 2
    stats = NT * (2 * p + (nq - 1) * p + 2 * p + 3 * nq + 2 * nq * p) \
        + p ** 3 + 2 * p * p
    step = (2 * nq * ntri + p + p ** 3 + 2 * p ** 3 + 2 * nq * p + 2 * p * p
            + nq * (2 * p + 4 * p * p + 8))
    if det:
        step += 4 * p + 6 * nq + 20
    return stats + 2 * nq * p * p + step * iters


def time_fixed_design(device, card, fig, nv=16_777_216):
    """Phase 5d at 16,777,216 voxels, T=106, P=3, on a plane made on the
    card: kernel 4 in maxits at Q=1 and Q=2, under trialmode at Q=2 and
    lm at Q=1; kernel 5 at Q=2 with make_design_stats's time beside it;
    kernel 3 beside the split pair (phase 5); VBInference.run() of poly
    with noise-pattern 12. CUDA events, best of 3 after a warm-up; the
    plain versions best of 1 after a warm-up. Detector bounds count the
    loop trips the plain version needed on this data."""
    import torch
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.ops import fused_spectral as fs
    from fabber_core_tpu_torch.ops import fused_whole as fw
    from fabber_core_tpu_torch.options import RunOptions

    out = {}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 13)
    p, design = 3, poly_design(3)
    plane = pattern_plane(design, 2, nv, gen, device)
    out_bytes = {nq: 4 * (p + 2 * p * p + 4 * nq) * nv for nq in (1, 2)}
    in_bytes = 4 * NT * nv + 4 * 2 * p * nv
    for nq in (1, 2):
        args = whole_inputs(design, group_masks(nq), plane, device)
        out[f"whole_q{nq}_ms"] = best_ms(lambda: fw.fused_whole(*args, ITERS))
        out[f"whole_q{nq}_plain_ms"] = best_ms(
            lambda: fw.fused_whole_plain(*args, ITERS), reps=1)
        out[f"whole_q{nq}_bound"] = bound(
            in_bytes + out_bytes[nq], whole_ops(p, nq, ITERS) * nv)
    for kind, nq in (("trialmode", 2), ("lm", 1)):
        args = whole_inputs(design, group_masks(nq), plane, device)
        det, cap = whole_detector(kind, p, nq)
        out[f"whole_{kind}_ms"], k = best_ms(
            lambda: fw.fused_whole(*args, cap, -1.0, det), keep=True)
        out[f"whole_{kind}_its"] = its_histogram(k[6][0].cpu().numpy())
        del k
        counter = trip_counter(det["det"])
        fw.fused_whole_plain(*args, cap, -1.0, {**det, "det": counter})
        out[f"whole_{kind}_plain_ms"] = best_ms(
            lambda: fw.fused_whole_plain(*args, cap, -1.0, det), reps=1)
        out[f"whole_{kind}_bound"] = bound(
            in_bytes + 4 * (p + 2 * p * p + 2 * nq + 2) * nv,
            whole_ops(p, nq, 0) * nv
            + (whole_ops(p, nq, 1, det=True) - whole_ops(p, nq, 0))
            * counter.trips)
        torch.cuda.empty_cache()
    # kernel 5 at Q=2, from make_design_stats
    opts = RunOptions({**{k: v for k, v in PATTERN_OPTIONS.items()
                          if not k.startswith("save")},
                       "engine-kernel": "pallas-loop"})
    eng = VBInference(get_model_class("poly")(opts), opts, None,
                      data_plane=plane, device=device)
    dt = eng._design_tensor()
    out["design_stats_ms"] = best_ms(
        lambda: eng.noise.make_design_stats(dt, plane), reps=1)
    largs, _ = eng.loop_kernel_args()
    out["loop_q2_ms"] = best_ms(lambda: fl.fused_vb_loop(*largs, ITERS))
    out["loop_q2_plain_ms"] = best_ms(
        lambda: fl.fused_vb_loop_plain(*largs, ITERS), reps=1)
    out["loop_q2_bound"] = bound(
        4 * (p + 2 + 2 * p + 2 * p) * nv + 4 * (p + 2 * p * p + 4) * nv,
        (whole_ops(p, 2, ITERS) - whole_ops(p, 2, 0)
         + 2 * 2 * p * p) * nv)
    del largs, eng
    torch.cuda.empty_cache()
    # kernel 3 beside the split pair
    q1 = np.ones(NT)
    tc = fs.pack_mxu_consts(design, q1, NT, torch.float32, device)
    ac = fs.pack_solve_consts(design, q1, NT, torch.float32)
    sc = fs.pack_spectral_consts(design, q1, NT, np.full(p, 1e-12), 1e-6,
                                 (NT - 1) * 0.5 + 1e-6, 1e-8, 50.0,
                                 torch.float32, (-100.0, 53.5))
    pm = torch.zeros((p, nv), dtype=torch.float32, device=device)
    out["fused_ms"] = best_ms(
        lambda: fs.spectral_fused(plane, tc, ac, pm, sc, ITERS))
    out["fused_plain_ms"] = best_ms(
        lambda: fs.spectral_fused_plain(plane, tc, ac, pm, sc, ITERS),
        reps=1)
    out["fused_bound"] = bound(
        4 * NT * nv + 4 * p * nv + 4 * (2 * p * p + p + 4) * nv,
        ((6 * p + 2) * NT + 10 * p * p + 12 * p + 2 * p * p + 3 * p ** 3
         + 40 + (ITERS - 1) * (9 * p + 5)) * nv)
    del pm
    torch.cuda.empty_cache()
    # the whole engine run with the noise pattern 12
    opts = RunOptions({k: v for k, v in PATTERN_OPTIONS.items()
                       if not k.startswith("save")})
    eng = VBInference(get_model_class("poly")(opts), opts, None,
                      data_plane=plane, device=device)
    eng.run()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    out["run_pattern_s"] = time.perf_counter() - t0
    out["run_pattern_voxels_per_s"] = nv / out["run_pattern_s"]
    if res.bad_voxels.any() or eng.route != "pallas-whole":
        raise RuntimeError("pattern run: bad voxels or another route")
    for k, v in out.items():
        log(f" {k} = {v!r}  [V={nv} T={NT} P={p}; {card}]")
    log(f" beside: the split pair spectral_stats + spectral_core "
        f"{fig['stats_ms']!r} + {fig['core_ms']!r} ms (phase 5)")
    return out


# ---------------------------------------------------------------------------
# method=nlls (phases 3e, 4m, 4n, 4o, 5e)
# ---------------------------------------------------------------------------

NLLS_MAX_ITS = 100          # nlls-max-iterations' default
NLLS_PHASE1 = 32            # nlls-phase1-iterations' default
POLY_LOG = {"model": "poly", "degree": "2", "PSP_byname1": "c0",
            "PSP_byname1_transform": "L"}


def nlls_engine(plane, device, extra=None, model="biexp"):
    from fabber_core_tpu_torch.inference.nlls import NLLSInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions
    opts = RunOptions({"model": model, "dt": str(BI_DT), "method": "nlls",
                       "dtype": "single", **(extra or {})})
    return NLLSInference(get_model_class(opts.get_string("model"))(opts),
                         opts, None, data_plane=plane, device=device)


def nlls_fit(eng, params):
    """The model [T,V] float64 at latent params [P,V]."""
    import torch
    from fabber_core_tpu_torch.ops import fused_vb as fv
    t = fv.time_index(eng.nt, torch.float64, params.device)
    tr = [pm.transform for pm in eng.params]
    return fv.block_eval(eng.model.time_signal_jac, tr, params.double(),
                         t)[0]


def nlls_off(eng, o, r64, f64):
    """([V], [V]) bool: lanes of the NLLS outputs o off the float64 run
    r64 (fit f64) by their fit (beyond 1e-3 of f64's largest sample) or
    cost (beyond 1e-3 relative), and by fit, cost or iteration count;
    a non-finite value counts as off."""
    fit_off = (nlls_fit(eng, o[0]) - f64).abs().amax(dim=0) \
        > 1e-3 * f64.abs().max()
    cost_off = (o[1].double() - r64[1]).abs() > 1e-3 * r64[1].abs()
    fit_cost = ~(~fit_off & ~cost_off)
    return fit_cost, fit_cost | (o[2].double() != r64[2])


def bits_equal(a, b):
    import torch
    return all(torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


NLLS_POST_TOL = 1e-3        # posterior off float64, in the lane's scale


def nlls_post_off(o, r64, keep):
    """[K] bool over the lanes keep: where prec or cov of the NLLS
    outputs o lies beyond NLLS_POST_TOL of the float64 run r64 in the
    lane's own scale (lane_rel: each element over sqrt(|ref_ii ref_jj|),
    so cov in units of the float64 sds, prec relative to its diagonal);
    a non-finite value counts as off."""
    import torch
    err = torch.maximum(lane_rel(o[3], r64[3]), lane_rel(o[4], r64[4]))
    return ~(err[keep] <= NLLS_POST_TOL)


def check_nlls_case(name, eng, p0, worst, two_phase=True):
    """One kernel 8 check (phase 3e): the fresh launch against the plain
    version at float32 and float64 by three shares, each at most 2x the
    plain float32 version's + 1e-3: lanes off float64 in fit or cost,
    in fit, cost or its (nlls_off), and, on the lanes where the kernel
    and plain float32 agree with float64 in fit and cost, in the
    posterior (nlls_post_off); no lane past the budget; the fresh launch
    in the streamed form bit-identical to the staged one (the plan's at
    T=100, csrc/tile.cuh); with two_phase, the engine's compaction
    (NLLSInference._solve_kernel: phase 1 + resume) bit-identical to the
    fresh launch. max_abs_err: fit, prec
    and cov on the agreeing lanes whose posterior is finite in both the
    kernel's and the float64 run (a non-finite one counts in the
    posterior share). Returns ok."""
    import torch
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    tr = [pm.transform for pm in eng.params]
    tsj = eng.model.time_signal_jac
    args = (eng.tmask_host, eng.max_its, eng.marquardt)
    k = fn.fused_nlls_loop(eng.model, tr, p0, eng.data, *args)
    r32 = fn.fused_nlls_loop_plain(tsj, tr, p0, eng.data, *args)
    r64 = fn.fused_nlls_loop_plain(tsj, tr, p0.double(), eng.data.double(),
                                   *args)
    torch.cuda.synchronize()
    f64 = nlls_fit(eng, r64[0])
    ratios, lines = [], []
    off_k, off_32 = nlls_off(eng, k, r64, f64), nlls_off(eng, r32, r64, f64)
    keep = ~(off_k[0] | off_32[0])
    for what, a, b in (("fit/cost", off_k[0], off_32[0]),
                       ("fit/cost/its", off_k[1], off_32[1]),
                       ("posterior", nlls_post_off(k, r64, keep),
                        nlls_post_off(r32, r64, keep))):
        share_k = float(a.double().mean()) if a.numel() else 0.0
        share_32 = float(b.double().mean()) if b.numel() else 0.0
        ratios.append(share_k / (2 * share_32 + 1e-3))
        lines.append(f"{what} off float64 {share_k:.6f} (plain float32 "
                     f"{share_32:.6f})")
    nv = k[1].shape[0]
    seen = keep & torch.stack([torch.isfinite(o[i]).reshape(-1, nv).all(dim=0)
                               for o in (k, r64) for i in (3, 4)]).all(dim=0)
    errs = {"fit": nlls_fit(eng, k[0]) - f64, "prec": k[3].double() - r64[3],
            "cov": k[4].double() - r64[4]}
    errs = {w: float(e[..., seen].abs().max()) if bool(seen.any()) else 0.0
            for w, e in errs.items()}
    abs_err = max(errs.values())
    its_max = float(k[2].max())
    ok = all(r <= 1.0 for r in ratios) and its_max <= eng.max_its
    bits = ""
    if two_phase:
        s, prec, cov = eng._solve_kernel(p0)
        same = (bits_equal((s.params, s.cost, prec, cov),
                           (k[0], k[1], k[3], k[4]))
                and torch.equal(s.its, k[2].to(torch.int32)))
        ok &= same
        bits = f"; two-phase {'bit-identical' if same else 'DIFFERS'}"
    # the streamed form (csrc/tile.cuh) on the same inputs, bit for bit
    same = bits_equal(fn.fused_nlls_loop(eng.model, tr, p0, eng.data, *args,
                                         _vb=0), k)
    ok &= same
    bits += f"; streamed {'bit-identical' if same else 'DIFFERS'}"
    ratio = max(r if r == r else float("inf") for r in ratios)
    log(f"  {name:<30} {'; '.join(lines)}; worst ratio {ratio:.3g}; max its "
        f"{its_max:g}{bits}; max abs err on agreeing finite lanes "
        f"{', '.join(f'{w} {e:.3g}' for w, e in errs.items())} "
        f"{'ok' if ok else 'FAIL'}")
    kname = "fused_nlls:marquardt" if eng.marquardt else "fused_nlls"
    for key in (kname,) + (("fused_nlls:resume",) if two_phase else ()):
        worst[key][0] = max(worst[key][0], abs_err)
        worst[key][1] = max(worst[key][1], ratio)
    return ok


def check_nlls_kernels(device, nvs=(1_048_576, 1_000_003), nv_small=65_536,
                       seed=SEED + 13):
    """Phase 3e: kernel 8 (csrc/fused_nlls.cu) against its plain version
    on bench.py's biexp data (T=100, dt=0.02) at a power-of-two and a
    ragged voxel count, from the engine's own start (the model's
    data-driven initial means), budget 100 steps: fresh Levenberg and
    fresh Marquardt (check_nlls_case: the shares of lanes off float64 in
    fit, cost, its and posterior, the budget) and the engine's phase 1
    (32) + resume against the fresh launch, bit for bit; then exp (P=2)
    and poly P=3 with a log-transformed c0 at
    65,536 voxels (poly from the latent truth + N(0, 0.2^2))."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    worst = {k: [0.0, 0.0] for k in ("fused_nlls", "fused_nlls:resume",
                                     "fused_nlls:marquardt")}
    ok = True
    for nv in nvs:
        data, _, _ = biexp_plane(nv, gen, device)
        for lm in (False, True):
            eng = nlls_engine(data, device, {"lm": True} if lm else None)
            ok &= check_nlls_case(f"biexp {'LM' if lm else 'L'} V={nv}", eng,
                                  eng.initial_means(), worst)
            del eng
            torch.cuda.empty_cache()
        del data
    nv = nv_small
    data, _, _ = biexp_plane(nv, gen, device, "exp")
    for lm in (False, True):
        eng = nlls_engine(data, device, {"lm": True} if lm else None, "exp")
        ok &= check_nlls_case(f"exp {'LM' if lm else 'L'} V={nv}", eng,
                              eng.initial_means(), worst, two_phase=False)
    t = torch.arange(1, BI_NT + 1, dtype=torch.float32, device=device)[:, None]
    c = [torch.rand((1, nv), generator=gen, device=device) + 1.0,
         (torch.rand((1, nv), generator=gen, device=device) - 0.5) * 0.02,
         (torch.rand((1, nv), generator=gen, device=device) - 0.5) * 2e-4]
    plane = c[0] + c[1] * t + c[2] * t * t
    plane += BI_SD * torch.randn(plane.shape, generator=gen, device=device)
    lat = torch.cat([torch.log(c[0]), c[1], c[2]])
    p0 = lat + 0.2 * torch.randn(lat.shape, generator=gen, device=device) \
        * torch.tensor([[1.0], [0.01], [1e-4]], device=device)
    for lm in (False, True):
        eng = nlls_engine(plane, device, {**POLY_LOG, **(
            {"lm": True} if lm else {})}, "poly")
        ok &= check_nlls_case(f"poly-log P=3 {'LM' if lm else 'L'} V={nv}",
                              eng, p0.contiguous(), worst, two_phase=False)
    return ok, worst


NLLS_OPTIONS = {"model": "biexp", "dt": str(BI_DT), "method": "nlls",
                "dtype": "single", "save-mean": True, "save-std": True,
                "save-model-fit": True, "save-residuals": True,
                "allow-bad-voxels": True}


def run_nlls_path(device, shape=(128, 128, 64)):
    """Phase 4m: method=nlls through run_with_data on phase 4c's biexp
    volume, under Levenberg and under --lm, at the default phase-1 cap
    (32) and budget (100): kernel 8 launched twice per run (phase 1 and
    the resume; under --lm both with Marquardt damping); every output of
    the volume's shape, finite outside the bad voxels; the fit within 3
    noise sd of the noiseless signal in >= 70% of voxels; residuals =
    data - fit; the bad-voxel share no more than the plain version's on
    the same inputs (run single-phase on the card: its outcome is the
    compaction's, lane for lane) + 1e-3; no lane past the budget; as
    phase 4c, at most 1% of voxels whose means or sds overflow float32
    in model space.
    Returns (ok, launches)."""
    import torch
    from fabber_core_tpu_torch.api import FabberTpu
    from fabber_core_tpu_torch.inference.nlls import NLLSInference
    from fabber_core_tpu_torch.ops import fused_nlls as fn

    vol, clean = make_biexp_volume(shape)
    nv = int(np.prod(shape))
    ok, launches = True, {}
    for lm in (False, True):
        opts = {**NLLS_OPTIONS, **({"lm": True} if lm else {})}
        captured, restore = capture_results(NLLSInference)
        reset_launches()
        t0 = time.perf_counter()
        try:
            run = FabberTpu(device=device).run_with_data(opts, {"data": vol})
        finally:
            restore()
        secs = time.perf_counter() - t0
        n = {k: v for k, v in launch_counts().items() if v}
        eng, res = captured[-1]
        # both launches in the staged form (the plan's at T=100)
        want = {"fused_nlls": 2, "fused_nlls:resume": 1,
                "fused_nlls:staged": 2}
        if lm:
            want["fused_nlls:marquardt"] = 2
            launches["fused_nlls:marquardt"] = n.get("fused_nlls:marquardt",
                                                     0)
        else:
            launches.update({k: n.get(k, 0) for k in want})
        good = n == want and eng.route == "nlls-kernel"
        fit = run.data["modelfit"].reshape(-1, BI_NT, order="F")
        resid = float(np.nanmax(np.abs(run.data["residuals"]
                                       - (vol - run.data["modelfit"]))))
        within = float((np.abs(fit - clean).max(axis=1) <= 3 * BI_SD).mean())
        bad = float(res.bad_voxels.mean())
        # as phase 4c: a voxel whose latent means or variances leave
        # float32's range in model space has an infinite mean_* or std_*
        # output (the API's float32 cast); every other voxel outside the
        # bad ones is finite in every output
        over = np.zeros(nv, bool)
        for key in run.data:
            if key.startswith(("mean_", "std_")):
                over |= ~np.isfinite(run.data[key].reshape(-1, order="F"))
        rest = ~(res.bad_voxels | over)
        fin = all(np.isfinite(a.reshape(nv, -1, order="F")[rest]).all()
                  for a in run.data.values())
        shapes = all(a.shape == (shape + (BI_NT,) if k in (
            "modelfit", "residuals") else shape) for k, a in run.data.items())
        # the plain version, single-phase, on the engine's inputs
        tr = [pm.transform for pm in eng.params]
        r = fn.fused_nlls_loop_plain(eng.model.time_signal_jac, tr,
                                     eng.initial_means(), eng.data,
                                     eng.tmask_host, eng.max_its, lm)
        plain_bad = float((~(torch.isfinite(r[0]).all(dim=0)
                             & torch.isfinite(r[4]).reshape(-1, nv).all(
                                 dim=0))).double().mean())
        del r
        torch.cuda.empty_cache()
        good &= (within >= 0.70 and resid <= 1e-5 and fin and shapes
                 and int(over.sum()) <= nv // 100
                 and bad <= plain_bad + 1e-3
                 and int(res.iterations.max()) <= NLLS_MAX_ITS)
        log(f" {'--lm' if lm else 'Levenberg'}: {eng.route_description()}: "
            f"{secs:.3f} s; launches {n} (want {want}); fit within 3 noise "
            f"sd {within:.5f} (bound >= 0.70); bad voxels {bad:.6f} (plain "
            f"{plain_bad:.6f}, bound +1e-3); model-space overflow "
            f"{int(over.sum())} voxels (bound <= {nv // 100}), non-finite "
            f"outputs elsewhere {'none' if fin else 'SOME'}; residual - "
            f"(data - fit) max "
            f"{resid:.3g}; iterations {its_histogram(res.iterations)} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
    return ok, launches


def flow_volume(shape, seed=SEED + 14):
    """tests/test_flows.py's phantom: a1 ~ U(0.8, 1.2), biexp a1 e^-t +
    0.5 a1 e^-5t, T=100, dt=0.02, noise sd 0.05; float32 from numpy."""
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    t = np.arange(BI_NT) * BI_DT
    a1 = rng.uniform(0.8, 1.2, nv)
    data = (a1[:, None] * np.exp(-t)[None] + 0.5 * a1[:, None]
            * np.exp(-5.0 * t)[None] + rng.normal(0, BI_SD, (nv, BI_NT)))
    return (data.reshape(shape + (BI_NT,), order="F").astype(np.float32),
            a1.reshape(shape, order="F"))


def run_nlls_vb_flow(device, shape=(32, 32, 16)):
    """Phase 4n: tests/test_flows.py's NLLS->VB workflow at
    dtype=single: method=nlls with save-mvn (kernel 8), then VB
    --convergence=trialmode (max-iterations 30) from its finalMVN with
    continue-from-mvn and continue-from-params (the VB route the JAX
    gates give a continued run: 'pallas', kernel 7 once per iteration;
    kernel 6 not at all). Bounds, that test's: the VB total amplitude
    amp1 + amp2 within 0.25 of 1.5 a1 in every voxel and within 0.08 on
    average; NLLS's within 0.2 on average. Returns (ok, launches)."""
    from pathlib import Path
    from fabber_core_tpu_torch.api import FabberTpu
    from fabber_core_tpu_torch.inference.vb import VBInference
    vol, a1 = flow_volume(shape)
    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    pfile = out / "nlls_params.txt"
    pfile.write_text("amp1\nr1\namp2\nr2\n")
    base = {"model": "biexp", "dt": str(BI_DT), "noise": "white",
            "dtype": "single"}
    fab = FabberTpu(device=device)
    reset_launches()
    nlls = fab.run_with_data({**base, "method": "nlls", "vb-init": True,
                              "save-mvn": True, "save-mean": True},
                             {"data": vol})
    n_nlls = {k: v for k, v in launch_counts().items() if v}
    captured, restore = capture_results(VBInference)
    reset_launches()
    try:
        vb = fab.run_with_data({
            **base, "method": "vb", "convergence": "trialmode",
            "max-iterations": "30", "save-mean": True,
            "continue-from-params": str(pfile)},
            {"data": vol, "continue-from-mvn": nlls.data["finalMVN"]})
    finally:
        restore()
    n_vb = {k: v for k, v in launch_counts().items() if v}
    eng, res = captured[-1]
    total = vb.data["mean_amp1"] + vb.data["mean_amp2"]
    err = np.abs(total - 1.5 * a1)
    err_nlls = np.abs(nlls.data["mean_amp1"] + nlls.data["mean_amp2"]
                      - 1.5 * a1)
    ok = (n_nlls.get("fused_nlls", 0) == 2 and eng.route == "pallas"
          and set(n_vb) == {"fused_vb_iter"}
          and 1 <= n_vb["fused_vb_iter"] <= eng.max_iter_cap
          and float(err.max()) <= 0.25 and float(err.mean()) < 0.08
          and float(err_nlls.mean()) < 0.2)
    log(f" NLLS launches {n_nlls}; VB route {eng.route} "
        f"({eng.route_description()}), launches {n_vb}, iterations "
        f"{its_histogram(res.iterations)}; VB total amplitude off 1.5 a1 "
        f"max {float(err.max()):.5f} (bound 0.25) mean "
        f"{float(err.mean()):.5f} (bound 0.08); NLLS mean "
        f"{float(err_nlls.mean()):.5f} (bound 0.2) {'ok' if ok else 'FAIL'}")
    return ok, n_vb.get("fused_vb_iter", 0)


def run_nlls_linear_path(device, shape=(128, 128, 32)):
    """Phase 4o: method=nlls on the linear model (P=4, phase 4k's
    synthetic design as a VEST file, T=106, unit noise) through
    run_with_data: the nlls-stats route (plain torch, no kernel
    launched); each parameter within 3 posterior sd of the truth in
    >= 99% of voxels."""
    from pathlib import Path
    from fabber_core_tpu_torch.io import matfile
    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    design = synthetic_design()
    path = str(out / "linear_design.mat")
    matfile.write_vest(design, path)
    rng = np.random.default_rng(SEED + 15)
    nv = int(np.prod(shape))
    truth = rng.uniform(-1, 1, (4, nv)) * np.array([[10.0], [5.0], [2.0],
                                                     [2.0]])
    data = (design.astype(np.float32) @ truth.astype(np.float32)).T
    data += rng.standard_normal((nv, NT), dtype=np.float32)
    vol = data.reshape(shape + (NT,), order="F")
    from fabber_core_tpu_torch.api import FabberTpu
    from fabber_core_tpu_torch.inference.nlls import NLLSInference
    captured, restore = capture_results(NLLSInference)
    reset_launches()
    t0 = time.perf_counter()
    try:
        run = FabberTpu(device=device).run_with_data(
            {"model": "linear", "basis": path, "method": "nlls",
             "dtype": "single", "save-mean": True, "save-std": True},
            {"data": vol})
    finally:
        restore()
    secs = time.perf_counter() - t0
    n = {k: v for k, v in launch_counts().items() if v}
    eng, res = captured[-1]
    fracs = []
    for i in range(4):
        m = run.data[f"mean_Parameter_{i + 1}"].reshape(-1, order="F")
        s = run.data[f"std_Parameter_{i + 1}"].reshape(-1, order="F")
        fracs.append(float((np.abs(m - truth[i]) <= 3 * s).mean()))
    ok = (eng.route == "nlls-stats" and not n and min(fracs) >= 0.99
          and not res.bad_voxels.any())
    log(f" {eng.route_description()}: {secs:.3f} s; launches {n}; "
        f"iterations {its_histogram(res.iterations)}; parameters within 3 "
        f"posterior sd of truth in {[round(f, 5) for f in fracs]} of voxels "
        f"(bound >= 0.99) {'ok' if ok else 'FAIL'}")
    return ok


def nlls_ops(p, nexp, nlog, nt, marquardt):
    """float32 operations per voxel of the pieces of csrc/fused_nlls.cu
    for an exp-sum model (nexp terms, nlog log-transformed parameters),
    counted from its source and vb_device.cuh's (expf, sqrtf, a division
    and a compare each one; the rare jitter refactorization left out):
      'pass'  nlls_pass with the Jacobian over nt samples: model_rows (2
              expf per log parameter), per sample ExpSum::eval (5 nexp),
              the chain (p), d and r (2), w jac_i (p), J'J (2 per packed
              element), J'r (2p) and r'r (2), and per kTB = 8 block the
              block sums into the totals;
      'cost'  the same pass without the Jacobian (4 nexp + 4 per sample);
      'step'  solve_step (the damped diagonal, the Cholesky with its
              finite test, chol_solve, the trial) and the accept tests
              (16);
      'post'  mse, prec = J'J / mse with the floor, the Cholesky and
              inverse_from_chol."""
    ntri = p * (p + 1) // 2
    blocks = -(-nt // 8)
    rows = 2 * nlog
    jac_pass = rows + nt * (5 * nexp + p + 4 + 3 * p + 2 * ntri) \
        + blocks * (ntri + p + 1)
    cost_pass = rows + nt * (4 * nexp + 4) + blocks
    chol = chol_ops(p)
    solve = (2 if marquardt else 1) * p + chol + 2 * p * p + p
    return {"pass": jac_pass, "cost": cost_pass, "step": solve + 16,
            "post": 1 + ntri + p + chol + inverse_ops(p)}


def chol_ops(p):
    """float32 operations of vb_device.cuh's P x P Cholesky with its
    finite test (the jitter refactorization left out)."""
    return sum(3 + 2 * i + (p - 1 - i) * (2 * i + 1) for i in range(p)) + p


def inverse_ops(p):
    """float32 operations of vb_device.cuh inverse_from_chol."""
    return p + sum(2 * (i - j) + 1 for i in range(p) for j in range(i)) \
        + sum((i + 1) * 2 * (p - i) for i in range(p))


def once_ms(fn):
    """One CUDA-event timing of fn() (the plain versions: seconds per
    call, no compile step to warm)."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), res


def time_nlls(device, card, nv=4_000_000):
    """Phase 5e at bench.py's biexp size (4,000,000 voxels, T=100, P=4),
    data made on the card, from the engine's start: kernel 8 fresh
    (single-phase) and the engine's two-phase pair (phase 1, sort,
    gathers, resume, inverse permutation), Levenberg and Marquardt, and
    the resume launch alone on the compacted inputs (CUDA events, best
    of 3 after a warm-up); the plain version of each once; the kernel's
    and the plain version's its histograms; NLLSInference.run() on the
    host clock with its stages (initial means, solve, _to_result).
    Bounds: bytes = each input read once and each output written once;
    operations = nlls_ops' counts times the steps the plain version
    needed (its its): fresh, a pass per voxel to start, a pass and a
    step per lane step, the posterior per voxel; the resume launch, per
    lane step past phase 1 a pass, a cost pass and a step, then a pass
    and the posterior per voxel. The fresh and resume launches in their
    staged and streamed forms (time_forms), each form's plan, occupancy
    and registers; the two forms' fresh outputs must agree bit for bit.
    Returns (ok, figures)."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_nlls as fn

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 16)
    plane, _, _ = biexp_plane(nv, gen, device)
    out, ok = {}, True
    p, t = 4, BI_NT
    io_bytes = 4 * (p + t) * nv + 4 * (p + 2 + 2 * p * p) * nv
    resume_bytes = io_bytes + 4 * 4 * nv
    for lm in (False, True):
        tag = "lm" if lm else "l"
        ops = nlls_ops(p, 2, p, t, lm)
        eng = nlls_engine(plane, device, {"lm": True} if lm else None)
        tr = [pm.transform for pm in eng.params]
        tsj = eng.model.time_signal_jac
        p0 = eng.initial_means()
        args = (eng.tmask_host, eng.max_its, lm)
        out[f"fresh_{tag}_ms"], out[f"fresh_{tag}_streamed_ms"], k, ks = \
            time_forms(lambda vb: fn.fused_nlls_loop(
                eng.model, tr, p0, plane, *args, _vb=vb))
        same = bits_equal(k, ks)
        ok &= same
        out[f"fresh_{tag}_staged_bits_equal_streamed"] = same
        del ks
        out[f"fresh_{tag}_forms"] = log_forms(
            f"fused_nlls ExpSum<2> fresh {'Marquardt' if lm else 'Levenberg'}",
            BI_NT, 1, lambda vb: _cuda.nlls_occupancy(1, 4, 0, lm, vb, BI_NT),
            lambda st: ptxas_entry(
                _cuda.build_log, "fused_nlls_kernel",
                f"ExpSumILi2EEELi0ELb{int(lm)}ELb{int(st)}E"))
        out[f"fresh_{tag}_its"] = its_histogram(k[2].cpu().numpy())
        out[f"pair_{tag}_ms"] = best_ms(lambda: eng._solve_kernel(p0))
        resume_in, _ = eng._phase1(p0)
        out[f"resume_{tag}_ms"], out[f"resume_{tag}_streamed_ms"], _, _ = \
            time_forms(lambda vb: fn.fused_nlls_loop(
                eng.model, tr, resume_in[0], resume_in[1], eng.tmask_host,
                eng.max_its - NLLS_PHASE1, lm, state=resume_in[2], _vb=vb))
        if not lm:
            out["resume_l_forms"] = log_forms(
                "fused_nlls ExpSum<2> resume Levenberg", BI_NT, 1,
                lambda vb: _cuda.nlls_occupancy(1, 4, 2, False, vb, BI_NT),
                lambda st: ptxas_entry(_cuda.build_log, "fused_nlls_kernel",
                                       f"ExpSumILi2EEELi2ELb0ELb{int(st)}E"))
        out[f"resume_{tag}_lanes_unfinished"] = int(
            (resume_in[2][2] < 0.5).sum())
        del k
        torch.cuda.empty_cache()
        out[f"fresh_{tag}_plain_ms"], r = once_ms(
            lambda: fn.fused_nlls_loop_plain(tsj, tr, p0, plane, *args))
        its = r[2].double()
        out[f"fresh_{tag}_plain_its"] = its_histogram(its.cpu().numpy())
        trips = float(its.sum())
        out[f"fresh_{tag}_plain_passes_per_voxel"] = (nv + trips) / nv
        out[f"fresh_{tag}_bound"] = bound(
            io_bytes, (nv + trips) * ops["pass"] + trips * ops["step"]
            + nv * ops["post"])
        late = float((its - NLLS_PHASE1).clamp_min(0).sum())
        out[f"resume_{tag}_bound"] = bound(
            resume_bytes, late * (ops["pass"] + ops["cost"] + ops["step"])
            + nv * (ops["pass"] + ops["post"]))
        del r
        torch.cuda.empty_cache()
        if not lm:
            out["resume_l_plain_ms"], _ = once_ms(
                lambda: fn.fused_nlls_loop_plain(
                    tsj, tr, resume_in[0], resume_in[1], eng.tmask_host,
                    eng.max_its - NLLS_PHASE1, lm, state=resume_in[2]))
            torch.cuda.empty_cache()
            eng.run()                                   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            out["run_s"] = time.perf_counter() - t0
            out["run_voxels_per_s"] = nv / out["run_s"]
            stages = {}
            t0 = time.perf_counter()
            p0 = eng.initial_means()
            torch.cuda.synchronize()
            stages["initial_means_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            s, _prec, cov = eng.solve(p0)
            torch.cuda.synchronize()
            stages["solve_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            eng._to_result(s, cov)
            stages["to_result_ms"] = (time.perf_counter() - t0) * 1e3
            out["run_stages"] = stages
            del s, _prec, cov
        del eng, resume_in, p0
        torch.cuda.empty_cache()
    dst = torch.empty_like(plane)
    out["copy_ms"] = best_ms(lambda: dst.copy_(plane))
    for key, v in out.items():
        log(f" {key} = {v!r}  [V={nv} T={BI_NT} P=4; {card}]")
    return ok, out


# ---------------------------------------------------------------------------
# AR(1) noise (phases 3f, 4p, 5f)
# ---------------------------------------------------------------------------

AR_ALPHA, AR_SD = 0.4, 0.1   # the volumes' AR coefficient, innovation sd


def ar_plane(nq, nv, gen, device, sd_range=None):
    """[T,V] float32 poly degree 2 signal (c0 ~ U(0.5, 1.5), c1 ~
    U(-0.05, 0.05), c2 ~ U(-5e-4, 5e-4)) plus AR(1) noise of coefficient
    AR_ALPHA per echo (nq interleaved echoes), made on the card. The
    innovation sd is AR_SD, or log-uniform over sd_range per voxel (so
    detector lanes stop apart). Returns (plane, c0 truth [V])."""
    import torch
    d = torch.as_tensor(poly_design(3), dtype=torch.float32, device=device)
    lo = torch.tensor([0.5, -0.05, -5e-4], device=device)[:, None]
    hi = torch.tensor([1.5, 0.05, 5e-4], device=device)[:, None]
    truth = lo + (hi - lo) * torch.rand((3, nv), generator=gen,
                                        device=device)
    plane = torch.randn((NT, nv), generator=gen, device=device)
    if sd_range is None:
        plane.mul_(AR_SD)
    else:
        a, b = (float(np.log10(x)) for x in sd_range)
        plane.mul_(10.0 ** (a + (b - a) * torch.rand(
            nv, generator=gen, device=device)))
    for t in range(nq, NT):   # e_t += alpha e_{t-nq}, echo by echo
        plane[t].add_(plane[t - nq], alpha=AR_ALPHA)
    plane.addmm_(d, truth)
    return plane, truth[0]


def ar_kernel_inputs(plane, nq, device):
    """Kernel 9's inputs for the poly priors (mean 0, precision 1e-12)
    from make_design_stats in plain torch: (args, noise model)."""
    import torch
    from fabber_core_tpu_torch.noise.ar1 import Ar1NoiseModel
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    from fabber_core_tpu_torch.options import RunOptions
    nm = Ar1NoiseModel(RunOptions({"num-echoes": str(nq)}), NT)
    d = torch.as_tensor(poly_design(3), dtype=torch.float32, device=device)
    st = nm.make_design_stats(d, plane)
    prior, post = nm.initial_state(1, torch.float32)
    consts = fa.pack_ar_consts(
        st.dmd, prior.alpha_prec, prior.b, prior.c, nm.ntimes,
        post.b[:, 0], post.c[:, 0],
        [post.alpha_cov[n, n, 0] for n in range(nq)],
        [post.alpha_prec[n, n, 0] for n in range(nq)], nq)
    nv = plane.shape[1]
    pm = torch.zeros((3, nv), dtype=torch.float32, device=device)
    pp = torch.full((3, nv), 1e-12, dtype=torch.float32, device=device)
    return (st.m0.contiguous(), st.rmr.contiguous(), st.dmr.contiguous(),
            consts, pm, pp), nm


def ar_detector(kind, nq, nm):
    """Kernel 9's detector dict (the engine's host ELBO constants at the
    model-default noise prior) and the engine's loop cap."""
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    det = make_detector(kind)
    f_const, lb = fa.ar_elbo_consts(3, nq, float(nm.ntimes), 1e6, 1e-6)
    return ({"det": det, "f_const": f_const, "lb_coeff": lb},
            int(det.max_iterations) + 2)


def check_ar_kernels(device, nvs=(1_048_576, 1_000_003), seed=SEED + 17):
    """Phase 3f: kernel 9 against its plain version at the main path's
    poly shapes (P=3, T=106, the raw degree-2 design), nq = 1 and 2, in
    maxits and under pointzeroone and freduce at the engine's loop cap,
    each held by near_f64 (detector modes by decision share: iteration
    count and engine-initial tag), on AR(1) data whose innovation sd is
    log-uniform over 1e-2..1 per voxel. Built without multiply-add
    contraction, the kernel should match the plain float32 version bit
    for bit (logged, not required)."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    worst = {k: [0.0, 0.0] for k in ("fused_ar_loop",
                                     "fused_ar_loop:detector")}
    ok_all = True

    def note(kname, res):
        nonlocal ok_all
        ok, abs_err, ratio = res
        ok_all &= ok
        worst[kname][0] = max(worst[kname][0], abs_err)
        worst[kname][1] = max(worst[kname][1], ratio)

    def dec(o):
        return torch.stack([o[9][0].double(), (o[6][0] < 0).double()])

    def tidy(o):
        return o[:6] + (o[6].abs(),) + o[7:]

    for nv in nvs:
        for nq in (1, 2):
            plane, _ = ar_plane(nq, nv, gen, device, sd_range=(1e-2, 1.0))
            args, nm = ar_kernel_inputs(plane, nq, device)
            del plane
            k = fa.fused_ar_loop(*args, ITERS)
            r32 = fa.fused_ar_loop_plain(*args, ITERS)
            r64 = fa.fused_ar_loop_plain(*to64(args), ITERS)
            torch.cuda.synchronize()
            log(f"  kernel and plain float32 bit for bit: "
                f"{all(torch.equal(a, b) for a, b in zip(k, r32))}")
            note("fused_ar_loop", near_f64(f"fused_ar_loop Q={nq} V={nv}", k,
                                           r32, r64))
            del k, r32, r64
            for kind in ("pointzeroone", "freduce"):
                det, cap = ar_detector(kind, nq, nm)
                k = fa.fused_ar_loop(*args, cap, det)
                r32 = fa.fused_ar_loop_plain(*args, cap, det)
                r64 = fa.fused_ar_loop_plain(*to64(args), cap, det)
                torch.cuda.synchronize()
                log(f"  tags (engine-initial) kernel {int((k[6] < 0).sum())}"
                    f", plain float32 {int((r32[6] < 0).sum())}, float64 "
                    f"{int((r64[6] < 0).sum())}; its "
                    f"{its_histogram(k[9][0].cpu().numpy())}")
                note("fused_ar_loop:detector", near_f64(
                    f"fused_ar_loop {kind} Q={nq} V={nv}", tidy(k),
                    tidy(r32), tidy(r64), dec(k), dec(r32), dec(r64)))
                del k, r32, r64
            del args
            torch.cuda.empty_cache()
    return ok_all, worst


AR_OPTIONS = {**MAIN_OPTIONS, "noise": "ar"}


def ar_volume(nq, shape, seed, device):
    """Phase 4p input: ar_plane's data (innovation sd AR_SD) made on the
    card from the seed, as a [nx,ny,nz,T] float32 host volume, and the
    c0 truth volume."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    plane, c0 = ar_plane(nq, int(np.prod(shape)), gen, device)
    vol = plane.t().cpu().numpy().reshape(shape + (NT,), order="F")
    return vol, c0.cpu().numpy().reshape(shape, order="F")


def ar_against_f64(name, res, ref, na, bound=1e-2):
    """Phase 4p: the float32 run against the float64 run ('xla'): the
    iteration counts at most 1 apart on < 2% of voxels (near-threshold
    F decisions, tests/test_fused_loop_ar.py); on the other voxels every
    std within bound relative and every phi noise mean within bound
    relative. Reports the means (in float64 posterior sd) and the alpha
    means (absolute) beside them."""
    diff = np.abs(res.iterations - ref.iterations)
    keep = diff == 0
    sd = np.sqrt(np.diagonal(ref.cov, axis1=1, axis2=2))
    sd_res = np.sqrt(np.diagonal(res.cov, axis1=1, axis2=2))
    e_m = np.max(np.abs(res.means - ref.means) / sd, axis=1)[keep]
    e_s = np.max(np.abs(sd_res / sd - 1), axis=1)[keep]
    e_n = np.max(np.abs(res.noise_means[:, na:] / ref.noise_means[:, na:]
                        - 1), axis=1)[keep]
    e_a = np.max(np.abs(res.noise_means[:, :na] - ref.noise_means[:, :na]),
                 axis=1)[keep]
    good = (diff.max() <= 1 and float((diff != 0).mean()) < 0.02
            and max(e_s.max(), e_n.max()) <= bound
            and not res.bad_voxels.any())
    log(f" {name} against float64: iterations differ (by <= "
        f"{int(diff.max())}) in {float((diff != 0).mean()):.5f} of voxels "
        f"(bound < 0.02, <= 1); on the rest std within {e_s.max():.3g} and "
        f"phi within {e_n.max():.3g} relative (bound {bound:g} each); means "
        f"within {e_m.max():.4g} posterior sd (p99.9 "
        f"{np.quantile(e_m, 0.999):.3g}), alpha means within {e_a.max():.3g}"
        f" (p99.9 {np.quantile(e_a, 0.999):.3g}) {'ok' if good else 'FAIL'}")
    return good


def run_ar_paths(device, shape=(128, 128, 64)):
    """Phase 4p: run_with_data with noise=ar, dtype=single (the
    pallas-loop-ar route: make_design_stats in plain torch, then kernel
    9 launched once) on a 128x128x64 x 106 poly degree 2 volume with
    AR(1) noise (alpha 0.4, innovation sd 0.1; ar_volume), for
    num-echoes 1 and 2 in maxits, and num-echoes 1 under pointzeroone
    (kernel 9's detector mode, launched once); each beside the float64
    run (the 'xla' route in plain torch on the card, no kernel;
    ar_against_f64); c0 within 3 posterior sd of the truth in >= 99% of
    voxels, or, where the model itself covers less at float64 (two
    echoes; the float64 route is the JAX package's within 1e-9 in the
    CPU tests), in at least the float64 run's share less 1e-3; mean
    alpha_1 within 0.15 of 0.4. Returns (ok, launches)."""
    import torch
    ok, launches = True, {}
    for nq, kind in ((1, "maxits"), (2, "maxits"), (1, "pointzeroone")):
        vol, c0 = ar_volume(nq, shape, SEED + 18 + nq, device)
        torch.cuda.empty_cache()
        opts = {**AR_OPTIONS, "num-echoes": str(nq), "convergence": kind}
        log(f"phase 4p: run_with_data, noise=ar, num-echoes={nq}, {kind}, "
            f"volume {shape + (NT,)}")
        run, res, eng, n32, _ = api_run(device, opts, vol)
        want = {"fused_ar_loop": 1}
        if kind != "maxits":
            want["fused_ar_loop:detector"] = 1
        for key in want:
            launches[key] = launches.get(key, 0) + n32.get(key, 0)
        ok &= eng.route == "pallas-loop-ar" and n32 == want
        run64, r64, eng64, n64, _ = api_run(
            device, {**opts, "dtype": "double"}, vol)
        ok &= eng64.route == "xla" and not n64
        ok &= ar_against_f64(f"num-echoes={nq} {kind}", res, r64, 2)

        def cover(d):
            return float((np.abs(d["mean_c0"] - c0)
                          <= 3 * d["std_c0"]).mean())
        frac, frac64 = cover(run.data), cover(run64.data)
        nm = run.data["noise_means"]
        alpha1 = float(nm[..., 0].mean())
        phi_sd = np.median(1 / np.sqrt(nm[..., 2:].reshape(-1, nq)), axis=0)
        good = (frac >= min(0.99, frac64) - 1e-3
                and abs(alpha1 - AR_ALPHA) <= 0.15
                and all(np.isfinite(a).all() for a in run.data.values()))
        log(f" c0 within 3 posterior sd of truth in {frac:.5f} of voxels "
            f"(float64 {frac64:.5f}; bound >= min(0.99, float64's) - 1e-3);"
            f" mean alpha_1 {alpha1:.4f} (truth {AR_ALPHA}, bound 0.15); "
            f"median innovation sd per echo "
            f"{[round(float(x), 5) for x in phi_sd]} (truth {AR_SD}) "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
        del vol, run, res, run64, r64
    return ok, launches


def ar_ops(p, nq, det=False):
    """float32 operations per voxel of csrc/fused_ar_loop.cu, counted
    from its source and vb_device.cuh's (a division, logf and sqrtf one
    each; the rare jitter refactorization left out): (setup, step) with
    setup the iteration-invariant D'M_sy (and, in MODE 1, the ELBO's
    base) and step one iteration (ar_step, and in MODE 1 F and the
    detector's test)."""
    s = 3 * nq
    ntri = p * (p + 1) // 2
    setup = s * p * (2 * p + 1) + (3 * nq + 3 * p if det else 0)
    step = (5 * nq + ntri * 2 * s + p + chol_ops(p) + inverse_ops(p)
            + p * (2 * s + 2) + 2 * p * p + p + 2 * ntri
            + s * (2 * p + 2 + 2 * p * p) + 15 * nq)
    if det:
        step += 8 * p + 5 + 18 * nq + 10
    return setup, step


def time_ar(device, card, nv=16_777_216):
    """Phase 5f at 16,777,216 voxels, T=106, P=3, nq = 1 and 2, on
    ar_plane's data made on the card (innovation sd log-uniform over
    1e-2..1): kernel 9 in maxits and under pointzeroone (CUDA events,
    best of 3 after a warm-up), its plain version once (maxits),
    make_design_stats (best of 3), VBInference.run() on the host clock
    with its stages. Bounds: bytes = each input read once and each
    output written once; operations = ar_ops' counts, times ITERS
    (maxits) or the lane iterations the plain version needed
    (pointzeroone, TripCounter)."""
    import torch
    import fabber_core_tpu_torch.inference.vb as vbm
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    from fabber_core_tpu_torch.options import RunOptions

    out = {}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 21)
    p = 3
    for nq in (1, 2):
        plane, _ = ar_plane(nq, nv, gen, device, sd_range=(1e-2, 1.0))
        args, nm = ar_kernel_inputs(plane, nq, device)
        s = 3 * nq
        in_b = 4 * (p + s + s * p + 2 * p) * nv
        out_b = 4 * (p + 2 * p * p + 5 * nq) * nv
        out[f"ar_q{nq}_bytes_per_voxel"] = (in_b + out_b) // nv
        out[f"ar_q{nq}_ms"] = best_ms(lambda: fa.fused_ar_loop(*args, ITERS))
        out[f"ar_q{nq}_plain_ms"], _ = once_ms(
            lambda: fa.fused_ar_loop_plain(*args, ITERS))
        torch.cuda.empty_cache()
        setup, step = ar_ops(p, nq)
        out[f"ar_q{nq}_bound"] = bound(in_b + out_b, (setup + ITERS * step)
                                       * nv)
        det, cap = ar_detector("pointzeroone", nq, nm)
        out[f"ar_det_q{nq}_ms"], k = best_ms(
            lambda: fa.fused_ar_loop(*args, cap, det), keep=True)
        out[f"ar_det_q{nq}_its"] = its_histogram(k[9][0].cpu().numpy())
        del k
        torch.cuda.empty_cache()
        counter = trip_counter(det["det"])
        out[f"ar_det_q{nq}_plain_ms"], _ = once_ms(
            lambda: fa.fused_ar_loop_plain(*args, cap,
                                           {**det, "det": counter}))
        setup, step = ar_ops(p, nq, det=True)
        out[f"ar_det_q{nq}_bound"] = bound(
            in_b + out_b + 8 * nv, setup * nv + step * counter.trips)
        del args
        torch.cuda.empty_cache()
        d = torch.as_tensor(poly_design(3), dtype=torch.float32,
                            device=device)
        out[f"ar_stats_q{nq}_ms"] = best_ms(
            lambda: nm.make_design_stats(d, plane))
        torch.cuda.empty_cache()
        # the engine's run() with its stages
        opts = RunOptions({**{k: v for k, v in AR_OPTIONS.items()
                              if not k.startswith("save")},
                           "num-echoes": str(nq)})
        eng = VBInference(get_model_class("poly")(opts), opts, None,
                          data_plane=plane, device=device)
        if eng.route != "pallas-loop-ar":
            raise RuntimeError(f"AR run took {eng.route}")
        eng.run()                                   # warm-up
        stages = {}

        def timed(name, fn):
            def wrapped(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                torch.cuda.synchronize()
                stages[name] = stages.get(name, 0.0) \
                    + (time.perf_counter() - t0) * 1e3
                return r
            return wrapped
        eng.initial_state = timed("initial_state_ms", eng.initial_state)
        eng.ar_loop_args = timed("statistics_ms", eng.ar_loop_args)
        eng._to_result = timed("to_result_ms", eng._to_result)
        orig = vbm.fused_ar_loop
        vbm.fused_ar_loop = timed("kernel_ms", orig)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.run()
            out[f"run_ar_q{nq}_s"] = time.perf_counter() - t0
        finally:
            vbm.fused_ar_loop = orig
        out[f"run_ar_q{nq}_stages"] = stages
        out[f"run_ar_q{nq}_voxels_per_s"] = nv / out[f"run_ar_q{nq}_s"]
        if res.bad_voxels.any():
            raise RuntimeError("AR run: bad voxels")
        del eng, res, plane
        torch.cuda.empty_cache()
    for key, v in out.items():
        log(f" {key} = {v!r}  [V={nv} T={NT} P={p}; {card}]")
    return out


# ---------------------------------------------------------------------------
# The whole-loop kernel's generic mode: functors generated from a model
# (phases 3g, 4q, 5g)
# ---------------------------------------------------------------------------

GA_NT, GA_DT, GA_SD = 30, 0.1, 0.02   # the Gaussian bump: T, dt, noise sd
PLUGIN = "fabber_core_tpu_torch/examples/fwdmodel_exp.py"
_GENERIC_MODELS = []


def generic_models():
    """(GaussAct, SuppGauss, StrippedBiexp), registered by name:
    GaussAct an evaluate-only Gaussian bump (the JAX package's test
    plugin GaussianActModel), SuppGauss the same scaled and offset by two
    suppdata values per voxel, StrippedBiexp the port's biexp with its
    time_signal (and so its hand-written functor's route) taken away."""
    if _GENERIC_MODELS:
        return _GENERIC_MODELS
    import torch
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.models.base import (DistParams, Model,
                                                   ParamSpec, register_model)

    @register_model
    class GaussAct(Model):
        name = "gaussact-smoke"

        def __init__(self, options=None):
            pass

        def param_defaults(self):
            return [ParamSpec(i, n, DistParams(m, 10), DistParams(m, 5))
                    for i, (n, m) in enumerate(
                        [("off", 0.0), ("amp", 1.0), ("mu", 1.2),
                         ("width", 0.6)])]

        def evaluate(self, params, ctx, key=""):
            t = torch.arange(ctx.nt, dtype=params.dtype,
                             device=params.device) * GA_DT
            z = (t - params[2]) / params[3]
            return params[0] + params[1] * torch.exp(-0.5 * z * z)

    @register_model
    class SuppGauss(GaussAct):
        name = "suppgauss-smoke"

        def evaluate(self, params, ctx, key=""):
            return (ctx.suppdata[0] * super().evaluate(params, ctx)
                    + ctx.suppdata[1])

    @register_model
    class StrippedBiexp(get_model_class("biexp")):
        name = "biexp-evaluate-smoke"

        @property
        def time_signal(self):
            raise AttributeError("evaluate only")

    _GENERIC_MODELS.extend([GaussAct, SuppGauss, StrippedBiexp])
    return _GENERIC_MODELS


def generic_functors():
    """The generated functors the run builds, as (name, TimeLocalEval,
    P, Q): the Gaussian bump (T=30), with two suppdata values, and
    biexp's evaluate (T=100; the myexp plugin's time_signal and evaluate
    generate the same source)."""
    from fabber_core_tpu_torch.models.kernelgen import \
        derive_time_local_eval
    from fabber_core_tpu_torch.options import RunOptions
    ga, sg, sb = generic_models()
    bi = sb(RunOptions({"model": "biexp", "dt": str(BI_DT)}))
    return [("gaussact", derive_time_local_eval(ga(), GA_NT, 4), 4, 1),
            ("suppgauss", derive_time_local_eval(sg(), GA_NT, 4, 2), 4, 1),
            ("biexp", derive_time_local_eval(bi, BI_NT, 4), 4, 1)]


def gauss_plane(nv, gen, device, supp=False):
    """The Gaussian bump's data made on the card: off ~ U(-0.2, 0.2),
    amp ~ U(0.8, 1.5), mu ~ U(0.9, 1.5), width ~ U(0.4, 0.8), noise sd
    0.02 (tests/test_fused_loop_generic.py's); with supp, scaled by
    U(0.8, 1.2) and offset by U(-0.1, 0.1) per voxel -> (data [T,V],
    suppdata [2,V] or None)."""
    import torch

    def u(lo, hi):
        return torch.rand((1, nv), generator=gen, device=device) \
            * (hi - lo) + lo
    t = torch.arange(GA_NT, dtype=torch.float32, device=device)[:, None] \
        * GA_DT
    z = (t - u(0.9, 1.5)) / u(0.4, 0.8)
    clean = u(-0.2, 0.2) + u(0.8, 1.5) * torch.exp(-0.5 * z * z)
    sv = None
    if supp:
        sv = torch.cat([u(0.8, 1.2), u(-0.1, 0.1)])
        clean = sv[0:1] * clean + sv[1:2]
    data = torch.randn((GA_NT, nv), generator=gen, device=device)
    return data.mul_(GA_SD).add_(clean), sv


def generic_engine(name, plane, device, extra=None, supp=None):
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.options import RunOptions
    ga, sg, sb = generic_models()
    base = {"noise": "white", "max-iterations": str(ITERS),
            "dtype": "single", **(extra or {})}
    if name == "biexp":
        opts = RunOptions({**base, "model": "biexp", "dt": str(BI_DT)})
        model = sb(opts)
    else:
        opts = RunOptions({**base, "model": "gaussact-smoke"})
        model = ga() if supp is None else sg()
    return VBInference(model, opts, None, data_plane=plane, device=device,
                       suppdata=None if supp is None
                       else supp.t().cpu().numpy())


def check_generic_kernels(device, nvs=(1_048_576, 1_000_003),
                          seed=SEED + 23):
    """Phase 3g: the whole-loop kernel with functors generated from a
    model's evaluate against the generic plain version (full_eval), held
    to float64 by near_f64 as phases 3b/3c hold kernel 6: the Gaussian
    bump (T=30, P=4) at 10 iterations under maxits and trialmode
    (max-trials 10), on the engine's own start and priors; biexp's
    evaluate (T=100) at 2 iterations (maxits) and 3 (trialmode,
    max-trials 2), the short horizons of phases 3b/3c (its float32 fixed
    point is chaotic further out: ROADMAP Queue 3 item 7)."""
    import torch
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_vb as fv

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    worst = {"fused_nl_loop:generic": [0.0, 0.0]}
    ok_all = True

    def note(res):
        nonlocal ok_all
        ok, abs_err, ratio = res
        ok_all &= ok
        w = worst["fused_nl_loop:generic"]
        w[0], w[1] = max(w[0], abs_err), max(w[1], ratio)

    for name in ("gaussact", "biexp"):
        for nv in nvs:
            if name == "gaussact":
                plane, _ = gauss_plane(nv, gen, device)
                its = (ITERS, {})
            else:
                plane, _, _ = biexp_plane(nv, gen, device)
                its = (2, {"max-iterations": "3", "max-trials": "2"})
            for kind in ("maxits", "trialmode"):
                eng = generic_engine(name, plane, device,
                                     {"convergence": kind, **its[1]})
                if eng.route != "pallas-loop-nl" or eng.generic is None:
                    log(f"  FAIL {name}: route {eng.route_description()}")
                    return False, worst
                tr = eng._transforms()
                args = eng.nl_loop_args(eng.initial_state())
                ev = fv.full_eval(eng.generic.fn, tr)
                det = None if kind == "maxits" else eng._nl_fdet_consts()
                n_it = its[0] if kind == "maxits" \
                    else int(eng.detector.max_iterations)
                k = fl.fused_nl_loop(eng.model, tr, *args, n_it, True,
                                     detector=det, functor=eng.functor)
                r32 = fl.fused_nl_loop_plain(None, tr, *args, n_it, True,
                                             detector=det, evaluator=ev)
                r64 = fl.fused_nl_loop_plain(None, tr, *to64(args), n_it,
                                             True, detector=det,
                                             evaluator=ev)
                torch.cuda.synchronize()
                label = f"generic {name} {kind} {n_it} its V={nv}"
                if det is None:
                    note(near_f64(label, k, r32, r64))
                else:
                    def dec(o):
                        return torch.stack([o[6][0].double(),
                                            0 * o[6][0].double()])
                    note(near_f64(label, k, r32, r64, dec(k), dec(r32),
                                  dec(r64)))
                del k, r32, r64, args, eng
                torch.cuda.empty_cache()
            del plane
    return ok_all, worst


def run_plugin_paths(device, shape=(128, 128, 64), supp_shape=(32, 32, 16)):
    """Phase 4q: run_with_data with --loadmodels on the torch myexp
    plugin (num-exps 2) on phase 4c's biexp volume: through the functor
    generated from its time_signal, then with its time_signal taken away
    (the generic full-time mode, the functor generated from evaluate).
    Each: the route line says which mode, fused_nl_loop launched once
    (in the generic mode, generic_launches, only in the second), and
    phase 4c's checks of the outputs. Then a suppdata run (the Gaussian bump scaled
    and offset per voxel, NS=2) on a 32x32x16 x 30 volume against the
    float64 run on the card (xla-generic, no kernel): the share of voxels
    whose means lie beyond 1e-2 posterior sd, or std or noise beyond
    1e-2 relative, of float64 at most 1e-3. Returns (ok, launches)."""
    import torch
    from fabber_core_tpu_torch.models import (get_model_class,
                                              load_models_from_file)
    from fabber_core_tpu_torch.models.base import register_model

    vol, clean = make_biexp_volume(shape)
    names = ["amp1", "r1", "amp2", "r2"]
    opts = {**BIEXP_OPTIONS, "model": "myexp", "num-exps": "2",
            "loadmodels": PLUGIN}
    log(f"phase 4q: run_with_data --loadmodels={PLUGIN} --model=myexp, "
        f"volume {shape + (BI_NT,)}")
    run, res, eng, n, _ = api_run(device, opts, vol)
    ok = (eng.route == "pallas-loop-nl" and eng.generic is None
          and eng.functor is not None
          and "time_signal mode" in eng.route_description()
          and n == {"fused_nl_loop": 1, "fused_nl_loop:staged": 1})
    want = {"fused_nl_loop": 1, "fused_nl_loop:generic": 1,
            "fused_nl_loop:staged": 1}
    ok &= check_biexp_outputs(run, vol, clean, shape, names)
    del run, res, eng

    load_models_from_file(PLUGIN)

    @register_model
    class MyExpEvaluateOnly(get_model_class("myexp")):
        name = "myexp-evaluate-only"

        @property
        def time_signal(self):
            raise AttributeError("evaluate only")

    log(" the same plugin with its time_signal taken away")
    run, res, eng, n, _ = api_run(device, {**opts,
                                           "model": "myexp-evaluate-only"},
                                  vol)
    ok &= (eng.route == "pallas-loop-nl" and eng.generic is not None
           and "generic full-time mode" in eng.route_description()
           and n == want)
    ok &= check_biexp_outputs(run, vol, clean, shape, names)
    launches = {"fused_nl_loop:generic": n.get("fused_nl_loop:generic", 0)}
    del run, res, eng, vol

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 24)
    nv = int(np.prod(supp_shape))
    plane, sv = gauss_plane(nv, gen, device, supp=True)
    vols = plane.t().cpu().numpy().reshape(supp_shape + (GA_NT,))
    svol = sv.t().cpu().numpy().reshape(supp_shape + (2,))
    generic_models()
    sopts = {"model": "suppgauss-smoke", "noise": "white", "method": "vb",
             "max-iterations": str(ITERS), "dtype": "single",
             "save-mean": True}
    log(f" suppdata: the Gaussian bump scaled per voxel, volume "
        f"{supp_shape + (GA_NT,)}")
    _, res, eng, n, _ = api_run(device, sopts, vols, {"suppdata": svol})
    ok &= (eng.route == "pallas-loop-nl" and eng.generic is not None
           and eng.generic.nsupp == 2 and n == want)
    _, r64, eng64, n64, _ = api_run(device, {**sopts, "dtype": "double"},
                                    vols, {"suppdata": svol})
    ok &= eng64.route == "xla-generic" and not n64
    e_m, e_s, e_n = voxel_errors(res, r64)
    off = (e_m > 1e-2) | (e_s > 1e-2) | (e_n > 1e-2)
    good = float(off.mean()) <= 1e-3 and not res.bad_voxels.any()
    log(f" suppdata float32 (generated functor, NS=2) against float64 "
        f"(xla-generic): {int(off.sum())} voxels off ({off.mean():.3g}; "
        f"bound 1e-3); means within {np.quantile(e_m, 0.999):.3g} sd at "
        f"p99.9 {'ok' if good else 'FAIL'}")
    return ok and good, launches


def gen_pass_ops(tle, nq, kind):
    """nl_pass_ops with the operations a generated functor does per
    sample (value and all P tangents, models/kernelgen.py) and the chain
    factors in place of the hand-written model's: a diagnostic of the
    generated code, not the function's bound."""
    p = tle.nparams
    own = nl_pass_ops(p, nq, 0, kind) - p
    return own + tle.value_ops + tle.tangent_ops + p


def time_generic(device, card, nv=4_000_000):
    """Phase 5g at bench.py's biexp size (4,000,000 voxels, T=100, P=4,
    maxits 10, phase 5b's plane): the kernel with the functor generated
    from biexp's evaluate beside kernel 6's hand-written ExpSum<2> on
    the same inputs, each in its staged and streamed forms (time_forms;
    CUDA events, best of 3 after a warm-up each), the generic plain
    version once, the generated forms' plan, occupancy and registers in
    MODE 0, 1 and 2, the generated build's seconds and ptxas lines.
    Bound: kernel 6's for biexp (phase 5b's), since the function is the
    same; the generated code's own operations (gen_pass_ops) are logged
    beside it as gen_code_ops_ms."""
    import torch
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as fl
    from fabber_core_tpu_torch.ops import fused_vb as fv

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    plane, _, _ = biexp_plane(nv, gen, device)
    eng = generic_engine("biexp", plane, device)
    ref = nl_engine("biexp", "1", plane, device)
    tr = eng._transforms()
    args = eng.nl_loop_args(eng.initial_state())
    tle = eng.functor

    def gen_run(vb):
        return fl.fused_nl_loop(eng.model, tr, *args, ITERS, True,
                                functor=tle, _vb=vb)

    def ref_run(vb):
        return fl.fused_nl_loop(ref.model, tr, *args, ITERS, True, _vb=vb)
    out = {}
    out["gen_ms"], out["gen_streamed_ms"], _, _ = time_forms(gen_run)
    out["expsum_ms"], out["expsum_streamed_ms"], _, _ = time_forms(ref_run)
    out["gen_over_expsum"] = out["gen_ms"] / out["expsum_ms"]
    out["gen_over_expsum_streamed"] = (out["gen_streamed_ms"]
                                       / out["expsum_streamed_ms"])
    lib = tle.libs[1]
    gen_log = _cuda.gen_build_log.get(_cuda.generated_key(
        tle.source, 4, 1), (float("nan"), ""))[1]
    for mode in (0, 1, 2):
        out[f"gen_mode{mode}_forms"] = log_forms(
            f"fused_nl_loop generated biexp Q=1 MODE {mode}", BI_NT, 1,
            lambda vb, m=mode: _cuda.gen_occupancy(lib, m, vb, BI_NT),
            lambda st, m=mode: ptxas_entry(gen_log, "fused_nl_loop_kernel",
                                           f"Li1ELi{m}ELb{int(st)}E"))
    ev = fv.full_eval(eng.generic.fn, tr)
    out["gen_plain_ms"], _ = once_ms(lambda: fl.fused_nl_loop_plain(
        None, tr, *args, ITERS, True, evaluator=ev))
    torch.cuda.empty_cache()
    nl_bytes = 4 * BI_NT * nv + 4 * (3 * 4 + 4 + 2 * 16 + 4) * nv
    a_ops = nl_pass_ops(4, 1, 2, "A") * BI_NT
    f_ops = nl_pass_ops(4, 1, 2, "F") * BI_NT
    out["gen_bound"] = bound(nl_bytes, (ITERS * a_ops + f_ops + 200 * ITERS)
                             * nv)
    code_ops = (ITERS * gen_pass_ops(tle, 1, "A")
                + gen_pass_ops(tle, 1, "F")) * BI_NT + 200 * ITERS
    out["gen_code_ops_ms"] = code_ops * nv / PEAK_F32_PER_S * 1e3
    out["gen_ops_per_sample"] = (tle.value_ops, tle.tangent_ops)
    secs, text = _cuda.gen_build_log.get(_cuda.generated_key(
        tle.source, 4, 1), (float("nan"), ""))
    out["gen_build_s"] = secs
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas (generated biexp): {line.strip()}")
    for k, v in out.items():
        log(f" {k} = {v!r}  [V={nv} T={BI_NT} P=4; {card}]")
    return out


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        import fabber_core_tpu_torch  # noqa: F401
        from fabber_core_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"run from the repository root ({e})", file=sys.stderr)
        return 2
    device = "cuda"

    # phase 1: the card
    card = card_line()
    log(card)
    log(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # phase 2: build the kernels from csrc/ (one nvcc per source, in
    # parallel, then one link)
    # and the functors generated from models (phases 3g, 4q, 5g), each
    # its own nvcc, all started together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    functors = generic_functors()
    with ThreadPoolExecutor(len(functors) + 1) as pool:
        lib = pool.submit(_cuda.build)
        gens = [pool.submit(_cuda.build_generated, tle.source, p, q)
                for _, tle, p, q in functors]
        path = lib.result()
        for g in gens:
            g.result()
    _cuda.load()
    log(f"phase 2: {len(_cuda.SOURCES)} kernel sources and "
        f"{len(functors)} generated functors built in "
        f"{time.perf_counter() - t0:.1f} s -> {path}")
    for line in _cuda.build_log.splitlines():
        if ("registers" in line or "spill" in line or "stack frame" in line
                or "Compiling entry" in line):
            log(f"  ptxas: {line.strip()}")
    for name, tle, p, q in functors:
        # no entry: the library was on disk already (an earlier process)
        secs, text = _cuda.gen_build_log.get(
            _cuda.generated_key(tle.source, p, q), (float("nan"), ""))
        log(f"  generated {name} (P={p}, Q={q}, {tle.value_ops} value + "
            f"{tle.tangent_ops} tangent operations per sample): nvcc "
            f"{secs:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas ({name}): {line.strip()}")

    # phase 3: kernel against plain
    log("phase 3: spectral kernels against their plain versions")
    ok3, worst = check_kernels(device)
    log("phase 3b: nonlinear kernels against their plain versions")
    ok3b, worst_nl = check_nl_kernels(device)
    worst.update(worst_nl)
    log("phase 3c: the detector modes against their plain versions")
    ok3c, worst_det = check_detector_kernels(device)
    worst.update(worst_det)
    log("phase 3d: the fixed-design kernels against their plain versions")
    ok3d, worst_fd = check_fixed_design_kernels(device)
    worst.update(worst_fd)
    log("phase 3e: the NLLS kernel against its plain version")
    ok3e, worst_nlls = check_nlls_kernels(device)
    worst.update(worst_nlls)
    log("phase 3f: the AR(1) kernel against its plain version")
    ok3f, worst_ar = check_ar_kernels(device)
    worst.update(worst_ar)
    log("phase 3g: the generated functors' kernel against its plain "
        "version")
    ok3g, worst_gen = check_generic_kernels(device)
    worst.update(worst_gen)

    # phase 4: the main paths through the API; each path's launch
    # counters are zeroed just before it and read just after it
    log("phase 4: run_with_data, 128x128x64 x 106, poly degree 2")
    ok4, launches, _ = run_main_path(device)
    ok4b = check_engine_vs_f64(device)
    log("phase 4c: run_with_data, 128x128x64 x 100, biexp")
    ok4c, nl_launches, _ = run_biexp_path(device)
    launches.update(nl_launches)
    log("phase 4d: exp engine on the card against float64")
    ok4d = check_exp_engine_vs_f64(device)
    log("phase 4e: the per-iteration route (engine-kernel=pallas)")
    ok4e, iter_launches = check_per_iteration_route(device)
    launches["fused_vb_iter"] = iter_launches
    log("phase 4f: run_with_data, 128x128x64 x 100, biexp, trialmode")
    ok4f, det_launches, _, _ = run_biexp_trialmode_path(device)
    launches.update(det_launches)
    log("phase 4g: run_with_data, 128x128x64 x 106, poly, trialmode")
    ok4g, det_launches, _ = run_poly_trialmode_path(device)
    launches["spectral_core:detector"] = \
        det_launches["spectral_core:detector"]
    ok4g &= det_launches["spectral_stats"] == 1
    log("phase 4h: the per-iteration route under lm")
    ok4h, lm_launches = check_per_iteration_lm(device)
    launches["fused_vb_iter:lm"] = lm_launches
    ok4i, fd_launches = run_pattern_paths(device)
    launches.update(fd_launches)
    log("phase 4k: run_with_data, 128x128x32 x 106, linear, "
        "spectral-impl=fused")
    ok4k, lin_launches = run_linear_path(device)
    launches.update(lin_launches)
    log("phase 4m: run_with_data, method=nlls, 128x128x64 x 100, biexp")
    ok4m, nlls_launches = run_nlls_path(device)
    launches.update(nlls_launches)
    log("phase 4n: the NLLS->VB workflow, 32x32x16 x 100, biexp")
    ok4n, _ = run_nlls_vb_flow(device)
    log("phase 4o: run_with_data, method=nlls, 128x128x32 x 106, linear")
    ok4o = run_nlls_linear_path(device)
    ok4p, ar_launches = run_ar_paths(device)
    launches.update(ar_launches)
    ok4q, gen_launches = run_plugin_paths(device)
    launches.update(gen_launches)

    # phase 5: timing at the headline sizes
    log("phase 5: timing at 16,777,216 voxels")
    fig = time_headline(device, card)
    log("phase 5b: biexp timing at 4,000,000 voxels")
    fig_nl = time_biexp(device, card)
    log("phase 5c: the detector modes at the headline sizes")
    ok5c, fig_det = time_detectors(device, card, fig, fig_nl)
    log("phase 5d: the fixed-design kernels at 16,777,216 voxels")
    fig_fd = time_fixed_design(device, card, fig)
    log("phase 5e: the NLLS kernel at 4,000,000 biexp voxels")
    ok5e, fig_nlls = time_nlls(device, card)
    log("phase 5f: the AR(1) kernel and route at 16,777,216 voxels")
    fig_ar = time_ar(device, card)
    log("phase 5g: the generated functors' kernel at 4,000,000 biexp "
        "voxels")
    fig_gen = time_generic(device, card)

    phases = {"kernels": ok3, "nl_kernels": ok3b, "detector_kernels": ok3c,
              "main_path": ok4, "engine_vs_f64": ok4b, "biexp_path": ok4c,
              "exp_engine_vs_f64": ok4d, "per_iteration_route": ok4e,
              "biexp_trialmode_path": ok4f, "poly_trialmode_path": ok4g,
              "per_iteration_lm": ok4h, "detector_lanes_at_4M": ok5c,
              "fixed_design_kernels": ok3d, "pattern_paths": ok4i,
              "linear_path": ok4k, "nlls_kernels": ok3e, "nlls_path": ok4m,
              "nlls_vb_flow": ok4n, "nlls_linear_path": ok4o,
              "ar_kernels": ok3f, "ar_paths": ok4p, "generic_kernels": ok3g,
              "plugin_paths": ok4q, "nlls_forms_bit_identical": ok5e}
    if not all(phases.values()):
        log(f"FAILED phases: {[k for k, v in phases.items() if not v]}")
        return 1
    src = "fabber_core_tpu_torch/csrc/"

    def entry(name, source, replaces, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": worst[name][0],
                "err_over_bound": worst[name][1], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}

    core_at = "fabber_core_tpu/ops/fused_spectral.py:760"
    whole_at = "fabber_core_tpu/ops/fused_whole.py:298"
    nl_at = "fabber_core_tpu/ops/fused_loop_nl.py:162"
    it_at = "fabber_core_tpu/ops/fused_vb.py:184"
    nlls_at = "fabber_core_tpu/ops/fused_nlls.py:72"
    ar_at = "fabber_core_tpu/ops/fused_loop_ar.py:50"
    kernels = [
        entry("spectral_stats", "spectral_stats.cu",
              "fabber_core_tpu/ops/fused_spectral.py:632", fig["stats_ms"],
              fig["stats_plain_ms"], fig_det["stats_bound"]),
        entry("spectral_core", "spectral_core.cu", core_at, fig["core_ms"],
              fig["core_plain_ms"], fig_det["core_maxits_bound"]),
        entry("spectral_core:detector", "spectral_core.cu", core_at,
              fig_det["core_det_ms"], fig_det["core_det_plain_ms"],
              fig_det["core_det_bound"]),
        entry("fused_nl_loop", "fused_nl_loop.cu", nl_at,
              fig_nl["nl_loop_ms"], fig_nl["nl_loop_plain_ms"],
              fig_det["nl_maxits_bound"]),
        entry("fused_nl_loop:detector", "fused_nl_loop.cu", nl_at,
              fig_det["nl_trialmode_ms"], fig_det["nl_trialmode_plain_ms"],
              fig_det["nl_trialmode_bound"]),
        entry("fused_vb_iter", "fused_vb_iter.cu", it_at,
              fig_nl["vb_iter_ms"], fig_nl["vb_iter_plain_ms"],
              fig_det["vb_iter_bound"]),
        entry("fused_vb_iter:lm", "fused_vb_iter.cu", it_at,
              fig_det["vb_iter_lm_ms"], fig_det["vb_iter_lm_plain_ms"],
              fig_det["vb_iter_lm_bound"]),
        entry("spectral_fused", "spectral_fused.cu",
              "fabber_core_tpu/ops/fused_spectral.py:376", fig_fd["fused_ms"],
              fig_fd["fused_plain_ms"], fig_fd["fused_bound"]),
        entry("fused_whole", "fused_whole.cu", whole_at,
              fig_fd["whole_q2_ms"], fig_fd["whole_q2_plain_ms"],
              fig_fd["whole_q2_bound"]),
        entry("fused_whole:detector", "fused_whole.cu", whole_at,
              fig_fd["whole_trialmode_ms"],
              fig_fd["whole_trialmode_plain_ms"],
              fig_fd["whole_trialmode_bound"]),
        entry("fused_whole:lm", "fused_whole.cu", whole_at,
              fig_fd["whole_lm_ms"], fig_fd["whole_lm_plain_ms"],
              fig_fd["whole_lm_bound"]),
        entry("fused_vb_loop", "fused_whole.cu",
              "fabber_core_tpu/ops/fused_loop.py:200", fig_fd["loop_q2_ms"],
              fig_fd["loop_q2_plain_ms"], fig_fd["loop_q2_bound"]),
        entry("fused_nlls", "fused_nlls.cu", nlls_at, fig_nlls["fresh_l_ms"],
              fig_nlls["fresh_l_plain_ms"], fig_nlls["fresh_l_bound"]),
        entry("fused_nlls:resume", "fused_nlls.cu", nlls_at,
              fig_nlls["resume_l_ms"], fig_nlls["resume_l_plain_ms"],
              fig_nlls["resume_l_bound"]),
        entry("fused_nlls:marquardt", "fused_nlls.cu", nlls_at,
              fig_nlls["fresh_lm_ms"], fig_nlls["fresh_lm_plain_ms"],
              fig_nlls["fresh_lm_bound"]),
        entry("fused_ar_loop", "fused_ar_loop.cu", ar_at, fig_ar["ar_q1_ms"],
              fig_ar["ar_q1_plain_ms"], fig_ar["ar_q1_bound"]),
        entry("fused_ar_loop:detector", "fused_ar_loop.cu", ar_at,
              fig_ar["ar_det_q1_ms"], fig_ar["ar_det_q1_plain_ms"],
              fig_ar["ar_det_q1_bound"]),
        entry("fused_nl_loop:generic", "fused_nl_loop.cuh", nl_at,
              fig_gen["gen_ms"], fig_gen["gen_plain_ms"],
              fig_gen["gen_bound"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
