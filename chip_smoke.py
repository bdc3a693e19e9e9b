#!/usr/bin/env python3
"""Smoke test of fabber_core_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from fabber_core_tpu_torch/csrc/ (nvcc, into
build/kernels/), holds each kernel against its plain-torch version on
the card, drives the port's main path end to end through the public
API (poly degree 2, T=106, white noise, maxits 10, single precision, on
a 128x128x64 volume), checks that the path went through both kernels
and that the result is right, then times the kernels, their plain
versions, a device-to-device copy and the whole engine run at
16,777,216 voxels. Every phase passes or the script exits non-zero
without printing the result line. The last line of standard output is
the JSON result object; the line before it lists the kernels.

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


def best_ms(fn, reps=3):
    """Best of `reps` CUDA-event timings of fn(), after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


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

    # phase 2: build the kernels from csrc/
    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.load()
    log(f"phase 2: kernels built in {time.perf_counter() - t0:.1f} s "
        f"-> {path}")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            log(f"  ptxas: {line.strip()}")

    # phase 3: kernel against plain
    log("phase 3: kernels against their plain versions")
    ok3, worst = check_kernels(device)

    # phase 4: the main path through the API
    log("phase 4: run_with_data, 128x128x64 x 106, poly degree 2")
    ok4, launches, _ = run_main_path(device)
    ok4b = check_engine_vs_f64(device)

    # phase 5: timing at the headline size
    log("phase 5: timing at 16,777,216 voxels")
    fig = time_headline(device, card)

    phases = {"kernels": ok3, "main_path": ok4, "engine_vs_f64": ok4b}
    if not all(phases.values()):
        log(f"FAILED phases: {[k for k, v in phases.items() if not v]}")
        return 1
    src = "fabber_core_tpu_torch/csrc/"
    kernels = [
        {"name": "spectral_stats", "route": "cuda",
         "source": src + "spectral_stats.cu",
         "replaces": "fabber_core_tpu/ops/fused_spectral.py:632",
         "launches": launches["spectral_stats"],
         "max_abs_err": worst["spectral_stats"][0],
         "err_over_bound": worst["spectral_stats"][1],
         "ms": fig["stats_ms"], "plain_ms": fig["stats_plain_ms"]},
        {"name": "spectral_core", "route": "cuda",
         "source": src + "spectral_core.cu",
         "replaces": "fabber_core_tpu/ops/fused_spectral.py:760",
         "launches": launches["spectral_core"],
         "max_abs_err": worst["spectral_core"][0],
         "err_over_bound": worst["spectral_core"][1],
         "ms": fig["core_ms"], "plain_ms": fig["core_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
