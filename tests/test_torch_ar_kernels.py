"""The plain version of the port's AR(1) whole-loop kernel (kernel 9,
ops/fused_loop_ar.py fused_ar_loop_plain) against the JAX package's
Pallas kernel (make_fused_ar_loop) run in interpret mode, as the JAX
tests run it on the CPU. The same statistics (the JAX noise model's
make_design_stats of one numpy seed's data) and constants go to both.

  float64: every output to 1e-9 of its max, iteration counts and
    engine-initial tags equal, for nq 1 and 2 x P 2 and 3 x maxits /
    pointzeroone / freduce at V of 64 and 200 (ten interpreted runs);
  float32: the engine's pallas-loop-ar route against the JAX engine's
    engine-kernel=pallas-loop at tests/test_fused_loop_ar.py:37-55's
    tolerances;
  pack_ar_consts against the JAX constant column, the constants and
    the AR state and statistics through convert.py, and the wrapper on
    CPU tensors (the plain version, no launch);
  the kernel itself (csrc/fused_ar_loop.cu) compiled as host C++
    (tests/torch_hostcc.py, skipped
    without g++) on the raw degree-2 poly design at T=106 (chip_smoke.py
    phase 3f's), nq 1 and 2, maxits and pointzeroone: at double against
    the plain version at float64, at float32 held to it as the card
    tests hold the kernel (near_f64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.inference.convergence import \
    get_detector_class as jdetector
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.noise.ar1 import Ar1NoiseModel as JAr1
from fabber_core_tpu.ops import fused_loop_ar as jfa
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.convert import (ar_consts_from_numpy,
                                           design_stats_from_numpy,
                                           noise_state_from_numpy, to_numpy)
from fabber_core_tpu_torch.inference.convergence import \
    get_detector_class as tdetector
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.noise.ar1 import Ar1DesignStats, Ar1NoiseState
from fabber_core_tpu_torch.ops import fused_loop_ar as tfa
from fabber_core_tpu_torch.noise.ar1 import Ar1NoiseModel
from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc
from test_torch_cuda import (assert_detector_near_f64, assert_near_f64,
                             decisions)

torch.set_num_threads(1)


def cosine_design(p, nt):
    """[T,P] cosine columns (a constant, then cos(pi k (t + 1/2) / T)):
    the P = 5..8 cases' design, where a poly design of degree >= 5 is
    beyond float32."""
    t = (np.arange(nt) + 0.5) / nt
    return np.cos(np.pi * t[:, None] * np.arange(p)[None])


def make_case(p, nq, nv, dtype, seed=0):
    """The JAX noise model's statistics of a scaled poly design (P > 4:
    cosine_design) and AR(1) data whose noise sd varies per voxel (so
    detector lanes stop apart), the model-default initial values, and
    weak priors."""
    nt = 30 * nq
    rng = np.random.default_rng(seed + 10 * p + nq)
    d = (np.arange(1, nt + 1.0)[:, None] / nt) ** np.arange(p)[None] \
        if p <= 4 else cosine_design(p, nt)
    e = rng.standard_normal((nt, nv))
    for k in range(nq, nt):
        e[k] += 0.4 * e[k - nq]
    y = d @ rng.uniform(-1, 1, (p, nv)) + 10.0 ** rng.uniform(-2, 0, nv) * e
    jm = JAr1(JOptions({"num-echoes": str(nq)}), nt)
    stats = jm.make_design_stats(jnp.asarray(d, dtype), jnp.asarray(y, dtype))
    prior, post = jm.initial_state(1, dtype)
    init = [[float(x[n, 0]) for n in range(nq)] for x in (post.b, post.c)] \
        + [[float(x[n, n, 0]) for n in range(nq)]
           for x in (post.alpha_cov, post.alpha_prec)]
    pm = rng.uniform(-0.2, 0.2, (p, nv)).astype(dtype)
    pp = np.full((p, nv), 1e-6, dtype)
    return jm, stats, prior, init, pm, pp


def detectors(kind, p, nq, ntimes, dtype):
    """(JAX detector, its det_consts, the port's detector dict) with the
    engine's ELBO constants, max-iterations 10."""
    opts = {"max-iterations": "10"}
    jd = jdetector(kind)(JOptions(dict(opts)))
    f_const, lb = tfa.ar_elbo_consts(p, nq, float(ntimes), 1e6, 1e-6)
    c1 = jd.init_state(1, dtype)
    jconsts = {"f_const": f_const, "lb_coeff": lb,
               "sentinel": float(np.asarray(c1.prev_f)[0]),
               "init_save": bool(np.asarray(c1.save)[0])}
    return jd, jconsts, {"det": tdetector(kind)(RunOptions(dict(opts))),
                         "f_const": f_const, "lb_coeff": lb}


def jax_kernel(jm, stats, prior, init, pm, pp, n_iters, dtype, nq,
               det=None):
    """make_fused_ar_loop interpreted, one block, the voxels edge-padded
    to a multiple of 8 (the engine's padding)."""
    nv = pm.shape[1]
    pad = (-nv) % 8
    consts = jfa.pack_ar_consts(stats.dmd, prior.alpha_prec, prior.b,
                                prior.c, jm.ntimes, *init, dtype, nq=nq)
    fn = jfa.make_fused_ar_loop(
        pm.shape[0], n_iters, nv + pad, dtype, block=nv + pad,
        interpret=True, detector=None if det is None else det[0],
        det_consts=None if det is None else det[1], nq=nq)

    def padv(x):
        x = np.asarray(x)
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], mode="edge")

    outs = fn(padv(stats.m0), padv(stats.rmr), padv(stats.dmr), consts,
              padv(pm), padv(pp))
    return [np.asarray(o)[..., :nv] for o in outs], consts


KERNEL_CASES = [(1, 2, None, 64), (1, 3, None, 200), (2, 2, None, 200),
                (2, 3, None, 64), (1, 2, "pointzeroone", 200),
                (2, 3, "pointzeroone", 64), (1, 3, "pointzeroone", 64),
                (1, 3, "freduce", 64), (2, 2, "freduce", 200),
                (2, 3, "freduce", 200),
                # the P = 5..8 instances
                (1, 6, None, 64), (2, 8, None, 64),
                (1, 8, "pointzeroone", 200), (2, 6, "pointzeroone", 200)]


@pytest.mark.parametrize("nq,p,kind,nv", KERNEL_CASES,
                         ids=[f"Q{c[0]}-P{c[1]}-{c[2] or 'maxits'}-V{c[3]}"
                              for c in KERNEL_CASES])
def test_plain_matches_pallas_kernel_f64(nq, p, kind, nv):
    dtype = np.float64
    jm, stats, prior, init, pm, pp = make_case(p, nq, nv, dtype)
    det, n_iters = None, 10
    if kind is not None:
        det = detectors(kind, p, nq, jm.ntimes, dtype)
        n_iters = 12     # the engine's loop cap: max-iterations + 2
    jout, jconsts = jax_kernel(jm, stats, prior, init, pm, pp, n_iters,
                               dtype, nq, det)
    ts = design_stats_from_numpy(stats)
    consts = tfa.pack_ar_consts(ts.dmd, to_numpy(prior.alpha_prec), prior.b,
                                prior.c, jm.ntimes, *init, nq=nq)
    tout = tfa.fused_ar_loop_plain(
        ts.m0, ts.rmr, ts.dmr, consts, torch.from_numpy(pm),
        torch.from_numpy(pp), n_iters, None if det is None else det[2])
    assert len(tout) == len(jout) == (10 if det else 8)
    for t, j in zip(tout, jout):
        assert t.shape == j.shape
        assert np.abs(t.numpy() - j).max() <= 1e-9 * max(np.abs(j).max(),
                                                         1e-300)
    if det is not None:
        np.testing.assert_array_equal(tout[9].numpy(), jout[9])
        np.testing.assert_array_equal(tout[6].numpy() < 0, jout[6] < 0)
        assert len(np.unique(jout[9])) > 1          # lanes stop apart


def test_pack_consts_match_jax_column():
    """pack_ar_consts is the JAX column without its ROWS replication;
    convert.ar_consts_from_numpy takes one to the other."""
    jm, stats, prior, init, _, _ = make_case(3, 2, 16, np.float64)
    jcol = jfa.pack_ar_consts(stats.dmd, prior.alpha_prec, prior.b,
                              prior.c, jm.ntimes, *init, jnp.float64, nq=2)
    tvec = tfa.pack_ar_consts(torch.from_numpy(np.array(stats.dmd)),
                              np.asarray(prior.alpha_prec),
                              np.asarray(prior.b), np.asarray(prior.c),
                              jm.ntimes, *init, nq=2)
    assert tvec.dtype == torch.float64
    assert tvec.numel() == tfa.n_consts(3, 2) == np.asarray(jcol).size // 8
    np.testing.assert_allclose(tvec.numpy(), np.asarray(jcol)[::8, 0],
                               rtol=1e-15, atol=0)
    assert torch.equal(ar_consts_from_numpy(jcol), tvec)


def test_ar_state_and_statistics_convert_from_jax():
    """convert.py carries the JAX Ar1NoiseState (posterior and [.,1]
    prior) and Ar1DesignStats across, and to_numpy back, bit for bit."""
    jm, stats, prior, _, _, _ = make_case(2, 2, 16, np.float64)
    _, post = jm.initial_state(16, jnp.float64)
    for state in (prior, post):
        t = noise_state_from_numpy(state)
        assert isinstance(t, Ar1NoiseState)
        for a, b in zip(to_numpy(t), state):
            np.testing.assert_array_equal(a, np.asarray(b))
    ts = design_stats_from_numpy(stats)
    assert isinstance(ts, Ar1DesignStats)
    for a, b in zip(to_numpy(ts), stats):
        np.testing.assert_array_equal(a, np.asarray(b))


def engine_data(nv, nt=30, seed=0):
    """tests/test_fused_loop_ar.py make_engine's data: a linear trend
    plus AR(1)-correlated noise of sd 0.1 (alpha 0.4)."""
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1)
    c0 = rng.uniform(-1, 1, (nv, 1))
    c1 = rng.uniform(-0.05, 0.05, (nv, 1))
    e = rng.standard_normal((nv, nt))
    for k in range(1, nt):
        e[:, k] += 0.4 * e[:, k - 1]
    return (c0 + c1 * t[None, :] + 0.1 * e).astype(np.float32)


def assert_match(rx, rp):
    """tests/test_fused_loop_ar.py:37-55's bounds."""
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < 5e-3
    np.testing.assert_allclose(rx.cov, rp.cov, rtol=8e-4, atol=1e-7)
    np.testing.assert_allclose(rx.noise_means, rp.noise_means, rtol=5e-4,
                               atol=5e-6)
    np.testing.assert_allclose(rx.noise_cov, rp.noise_cov, rtol=5e-4,
                               atol=5e-6)
    np.testing.assert_allclose(rx.free_energy, rp.free_energy, rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_array_equal(rx.iterations, rp.iterations)
    np.testing.assert_array_equal(rx.bad_voxels, rp.bad_voxels)


def test_engine_f32_matches_jax_kernel_route():
    """The port's pallas-loop-ar route (float32, the plain version here)
    against the JAX engine's engine-kernel=pallas-loop (its AR(1) kernel
    interpreted), two echoes."""
    data = engine_data(200)
    opts = {"model": "poly", "degree": "1", "noise": "ar",
            "num-echoes": "2", "max-iterations": "10", "dtype": "single",
            "print-free-energy": True}
    jopts = JOptions({**opts, "engine-kernel": "pallas-loop"})
    coords = np.stack([np.arange(200), np.zeros(200), np.zeros(200)], 1)
    jeng = JVB(jmodel("poly")(jopts), jopts, data, coords)
    assert jeng.use_loop_kernel
    topts = RunOptions(opts)
    eng = VBInference(get_model_class("poly")(topts), topts, data,
                      device="cpu")
    assert eng.route == "pallas-loop-ar"
    assert_match(jeng.run(), eng.run())


def test_wrapper_on_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper is the plain version and counts no
    launch; it refuses what the kernel does not run."""
    jm, stats, prior, init, pm, pp = make_case(3, 1, 40, np.float32)
    ts = design_stats_from_numpy(stats)
    consts = tfa.pack_ar_consts(ts.dmd, np.asarray(prior.alpha_prec),
                                np.asarray(prior.b), np.asarray(prior.c),
                                jm.ntimes, *init)
    args = (ts.m0, ts.rmr, ts.dmr, consts, torch.from_numpy(pm),
            torch.from_numpy(pp))
    _, _, det = detectors("freduce", 3, 1, jm.ntimes, np.float32)
    tfa.fused_ar_loop.launches = tfa.fused_ar_loop.det_launches = 0
    for d in (None, det):
        for a, b in zip(tfa.fused_ar_loop(*args, 12, d),
                        tfa.fused_ar_loop_plain(*args, 12, d)):
            assert torch.equal(a, b)
    assert tfa.fused_ar_loop.launches == tfa.fused_ar_loop.det_launches == 0
    trial = {**det, "det": tdetector("trialmode")(RunOptions({}))}
    with pytest.raises(ValueError, match="pointzeroone and freduce"):
        tfa.fused_ar_loop(*args, 12, trial)
    with pytest.raises(ValueError, match="n_iters"):
        tfa.fused_ar_loop(*args, 0)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.fused_ar_loop(*(a.to("meta") if i != 3 else a
                            for i, a in enumerate(args)), 3)


# -- kernel 9 compiled as host C++ (tests/torch_hostcc.py) ------------------

@pytest.fixture(scope="module")
def ar_host(tmp_path_factory):
    """(nq, double[, P]) -> kernel 9 at P (default 3) on the host (built
    once per module; skipped without g++)."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    libs = {}

    def get(nq, double, p=3):
        if (p, nq, double) not in libs:
            libs[p, nq, double] = torch_hostcc.ar_kernel_fn(
                p, nq, tmp_path_factory.mktemp(f"ar{p}{nq}{int(double)}"),
                double)
        return libs[p, nq, double]
    return get


def raw_poly_inputs(nq, nv, seed=0):
    """Kernel 9's float32 inputs on chip_smoke.py phase 3f's case: the
    raw degree-2 poly design at T=106 (t^2 to 11,236: D'M_sD ~ 1e10),
    c0 ~ U(0.5, 1.5), c1 ~ U(-0.05, 0.05), c2 ~ U(-5e-4, 5e-4), AR(1)
    noise (alpha 0.4 per echo) of sd log-uniform over 1e-2..1, the
    port's make_design_stats, the poly priors (mean 0, precision
    1e-12). Returns (args, noise model)."""
    nt = 106
    rng = np.random.default_rng(seed + nq)
    d = np.arange(1, nt + 1.0)[:, None] ** np.arange(3)[None]
    lo, hi = np.array([0.5, -0.05, -5e-4]), np.array([1.5, 0.05, 5e-4])
    truth = lo[:, None] + (hi - lo)[:, None] * rng.uniform(size=(3, nv))
    e = rng.standard_normal((nt, nv))
    for k in range(nq, nt):
        e[k] += 0.4 * e[k - nq]
    y = d @ truth + 10.0 ** rng.uniform(-2, 0, nv) * e
    nm = Ar1NoiseModel(RunOptions({"num-echoes": str(nq)}), nt)

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)
    st = nm.make_design_stats(f32(d), f32(y))
    prior, post = nm.initial_state(1, torch.float32)
    consts = tfa.pack_ar_consts(
        st.dmd, prior.alpha_prec, prior.b, prior.c, nm.ntimes,
        post.b[:, 0], post.c[:, 0],
        [post.alpha_cov[n, n, 0] for n in range(nq)],
        [post.alpha_prec[n, n, 0] for n in range(nq)], nq)
    return (st.m0.contiguous(), st.rmr.contiguous(), st.dmr.contiguous(),
            consts, torch.zeros((3, nv)), torch.full((3, nv), 1e-12)), nm


def wide_inputs(p, nq, nv, seed=0):
    """raw_poly_inputs' case on cosine_design(p, 106) (truth: c0 ~ U(0.5,
    1.5), the other columns ~ U(-0.5, 0.5)) and the priors of P
    parameters."""
    nt = 106
    rng = np.random.default_rng(seed + 10 * p + nq)
    d = cosine_design(p, nt)
    truth = rng.uniform(-0.5, 0.5, (p, nv))
    truth[0] += 1.0
    e = rng.standard_normal((nt, nv))
    for k in range(nq, nt):
        e[k] += 0.4 * e[k - nq]
    y = d @ truth + 10.0 ** rng.uniform(-2, 0, nv) * e
    nm = Ar1NoiseModel(RunOptions({"num-echoes": str(nq)}), nt)

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)
    st = nm.make_design_stats(f32(d), f32(y))
    prior, post = nm.initial_state(1, torch.float32)
    consts = tfa.pack_ar_consts(
        st.dmd, prior.alpha_prec, prior.b, prior.c, nm.ntimes,
        post.b[:, 0], post.c[:, 0],
        [post.alpha_cov[n, n, 0] for n in range(nq)],
        [post.alpha_prec[n, n, 0] for n in range(nq)], nq)
    return (st.m0.contiguous(), st.rmr.contiguous(), st.dmr.contiguous(),
            consts, torch.zeros((p, nv)), torch.full((p, nv), 1e-12)), nm


def host_ar_case(nq, kind, nv, p=3):
    """(args, the plain version's detector dict or None, the loop
    count, the host launch's detector tuple and ELBO constants); P > 3:
    wide_inputs."""
    args, nm = raw_poly_inputs(nq, nv) if p == 3 else \
        wide_inputs(p, nq, nv)
    if kind == "maxits":
        return args, None, 10, (0, 0.0, 0, 0, 0), (0.0, 0.0)
    _, _, det = detectors(kind, p, nq, nm.ntimes, np.float32)
    return (args, det, int(det["det"].max_iterations) + 2,
            _cuda.detector_args(det["det"]),
            (det["f_const"], det["lb_coeff"]))


def host_ar_run(fn, args, n_iters, dargs, elbo, dtype):
    m0, rmr, dmr, consts, pm, pp = args
    return [torch.from_numpy(o) for o in fn(
        n_iters, consts.numpy(), dargs, elbo,
        *(x.to(dtype).numpy() for x in (m0, rmr, dmr, pm, pp)))]


HOST_AR_CASES = [(nq, kind) for nq in (1, 2)
                 for kind in ("maxits", "pointzeroone")]


@pytest.mark.parametrize("nq,kind", HOST_AR_CASES,
                         ids=[f"Q{q}-{k}" for q, k in HOST_AR_CASES])
def test_ar_kernel_on_host_f64_matches_plain(nq, kind, ar_host):
    """At double the kernel (the plain version's operations) against the
    plain version at float64 on the same inputs: F within 1e-12 of its
    max and every
    other output within 1e-11, iteration counts and engine-initial tags
    equal. The two round a few operations apart (torch's CPU square root
    is not always correctly rounded: in float32 one ulp off at
    13,005,776), and the noise quadratics op_s, which cancel ~1e4-fold in
    float64 too, amplify that: up to 2.3e-12 in the alpha planes at
    nq=2, 3.3e-13 in prec, 1e-13 in the means."""
    check_host_f64(nq, kind, ar_host, 3)


# the P = 5..8 instances on the host: (P, nq, mode)
WIDE_HOST_AR_CASES = [(6, 1, "maxits"), (8, 2, "pointzeroone")]


@pytest.mark.parametrize("p,nq,kind", WIDE_HOST_AR_CASES,
                         ids=[f"P{p}-Q{q}-{k}"
                              for p, q, k in WIDE_HOST_AR_CASES])
def test_ar_kernel_on_host_wide_f64_matches_plain(p, nq, kind, ar_host):
    """test_ar_kernel_on_host_f64_matches_plain at P = 6 and 8, on
    cosine designs (wide_inputs)."""
    check_host_f64(nq, kind, ar_host, p)


@pytest.mark.parametrize("p,nq,kind", WIDE_HOST_AR_CASES,
                         ids=[f"P{p}-Q{q}-{k}"
                              for p, q, k in WIDE_HOST_AR_CASES])
def test_ar_kernel_on_host_wide_f32_near_f64(p, nq, kind, ar_host):
    """test_ar_kernel_on_host_f32_near_f64 at P = 6 and 8."""
    check_host_f32(nq, kind, ar_host, p)


def check_host_f64(nq, kind, ar_host, p):
    """test_ar_kernel_on_host_f64_matches_plain's comparison at P."""
    args, det, n_iters, dargs, elbo = host_ar_case(nq, kind, 256, p)
    k = host_ar_run(ar_host(nq, True, p), args, n_iters, dargs, elbo,
                    torch.float64)
    a64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    ref = tfa.fused_ar_loop_plain(*a64, n_iters, det)
    assert len(k) == len(ref) == (8 if det is None else 10)
    for i, (a, r) in enumerate(zip(k, ref)):
        bound = 1e-12 if i == 8 else 1e-11
        assert float((a - r).abs().max() / r.abs().max()) <= bound, i
    if det is not None:
        assert torch.equal(k[9], ref[9])
        assert torch.equal(k[6] < 0, ref[6] < 0)


@pytest.mark.parametrize("nq,kind", HOST_AR_CASES,
                         ids=[f"Q{q}-{k}" for q, k in HOST_AR_CASES])
def test_ar_kernel_on_host_f32_near_f64(nq, kind, ar_host):
    """At float32 (the card's rounding, every product and sum rounded
    apart) the kernel is held to the plain version at float64 as the
    card tests hold it (tests/
    test_torch_cuda.py assert_near_f64: within twice the plain float32
    version's distance, lane by lane; pointzeroone by the share of lanes
    whose iteration count or engine-initial tag differ), at the card
    tests' 20,001 lanes: the rule compares worst lanes, and over a few
    hundred lanes the plain float32 version's worst is too few draws to
    bound another rounding's (one case of 512 lanes landed at 1.21x;
    0.37-0.75x over four seeds here)."""
    check_host_f32(nq, kind, ar_host, 3)


def check_host_f32(nq, kind, ar_host, p):
    """test_ar_kernel_on_host_f32_near_f64's comparison at P."""
    args, det, n_iters, dargs, elbo = host_ar_case(nq, kind, 20_001, p)
    k = host_ar_run(ar_host(nq, False, p), args, n_iters, dargs, elbo,
                    torch.float32)
    a64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    r32 = tfa.fused_ar_loop_plain(*args, n_iters, det)
    r64 = tfa.fused_ar_loop_plain(*a64, n_iters, det)
    if det is None:
        assert_near_f64(k, r32, r64)
        return

    def dec(o):
        return decisions(o[9][0], o[6][0] < 0)

    def tidy(o):
        return tuple(o[:6]) + (o[6].abs(),) + tuple(o[7:])
    assert_detector_near_f64(tidy(k), tidy(r32), tidy(r64), dec(k),
                             dec(r32), dec(r64))
