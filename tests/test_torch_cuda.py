"""CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc: without them every test here
skips (the `cuda` fixture decides at run time). On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

No jax here: the GPU machine runs the port alone. Bounds are those of
chip_smoke.py (errors over the max |plain| of each quantity).
"""

import numpy as np
import pytest
import torch

from fabber_core_tpu_torch.ops import fused_spectral as fs

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from fabber_core_tpu_torch.ops import _cuda
    _cuda.load()
    return torch.device("cuda", torch.cuda.current_device())


def design(p, nt):
    t = np.arange(1, nt + 1, dtype=np.float64) / nt
    cols = [np.ones(nt)] + [np.cos(np.pi * k * t) for k in range(1, p)]
    return np.stack(cols, axis=1)


def rel(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nt", [30, 106])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
def test_kernels_match_plain_every_p(cuda, p, nt, masked):
    """Every template instantiation (P = 1..8), ragged voxel count."""
    nv = 70_001
    gen = torch.Generator(device=cuda)
    gen.manual_seed(p * 1000 + nt)
    d = design(p, nt)
    q = np.ones(nt)
    if masked:
        q[[1, nt // 3]] = 0.0
    truth = torch.rand((p, nv), generator=gen, device=cuda) * 4 - 2
    data = torch.as_tensor(d, dtype=torch.float32, device=cuda) @ truth
    data += torch.randn((nt, nv), generator=gen, device=cuda)
    tc = fs.pack_mxu_consts(d, q, nt, torch.float32, cuda)
    ac = fs.pack_solve_consts(d, q, nt, torch.float32)
    before = fs.spectral_stats.launches
    ks = fs.spectral_stats(data, tc, ac)
    assert fs.spectral_stats.launches == before + 1
    ps = fs.spectral_stats_plain(data, tc, ac)
    a = ac.reshape(p, p).to(cuda).double()
    assert rel(ks[0], ps[0]) <= 1e-3
    assert rel(ks[1], ps[1]) <= 1e-4
    assert rel(ks[2].double() + a @ ks[0].double(),
               ps[2].double() + a @ ps[0].double()) <= 1e-5

    c_post = (q.sum() - 1) * 0.5 + 1e-6
    sc = fs.pack_spectral_consts(d, q, nt, np.full(p, 0.1), 1e-6, c_post,
                                 1e-8, 50.0, torch.float32,
                                 (-10.0, c_post + 0.5))
    pm = torch.rand((p, nv), generator=gen, device=cuda) - 0.5
    before = fs.spectral_core.launches
    kc = fs.spectral_core(*ps, pm, sc, 10)
    assert fs.spectral_core.launches == before + 1
    pc = fs.spectral_core_plain(*ps, pm, sc, 10)
    for k, r in zip(kc, pc):
        assert k.shape == r.shape
        assert rel(k, r) <= 1e-4


def test_wrappers_check_arguments_on_card(cuda):
    nt, nv, p = 30, 64, 3
    d = design(p, nt)
    q = np.ones(nt)
    tc = fs.pack_mxu_consts(d, q, nt, torch.float32, cuda)
    ac = fs.pack_solve_consts(d, q, nt, torch.float32)
    data = torch.zeros((nt, nv), device=cuda)
    with pytest.raises(TypeError):
        fs.spectral_stats(data.double(), tc, ac)
    with pytest.raises(ValueError, match="host"):
        fs.spectral_stats(data, tc, ac.to(cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fs.spectral_stats(torch.zeros((nv, nt), device=cuda).t(), tc, ac)
    with pytest.raises(ValueError, match="is on"):
        fs.spectral_stats(data, tc.cpu(), ac)


def test_engine_on_card_matches_cpu(cuda):
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions

    rng = np.random.default_rng(0)
    nv, nt = 3000, 30
    t = np.arange(1, nt + 1)
    data = (rng.uniform(-1, 1, (nv, 1)) + rng.uniform(-.05, .05, (nv, 1)) * t
            + 0.1 * rng.standard_normal((nv, nt))).astype(np.float32)
    res = {}
    for dev in (cuda, "cpu"):
        opts = RunOptions({"model": "poly", "degree": "2", "noise": "white",
                           "dtype": "single", "print-free-energy": True})
        res[str(dev)] = VBInference(get_model_class("poly")(opts), opts,
                                    data, device=dev).run()
    g, c = res[str(cuda)], res["cpu"]
    sd = np.sqrt(np.diagonal(c.cov, axis1=1, axis2=2))
    assert np.max(np.abs(g.means - c.means) / sd) < 5e-3
    np.testing.assert_allclose(g.cov, c.cov, rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(g.noise_means, c.noise_means, rtol=1e-3)
    np.testing.assert_allclose(g.free_energy, c.free_energy, rtol=1e-3,
                               atol=5e-3)
    np.testing.assert_array_equal(g.iterations, c.iterations)
    assert not g.bad_voxels.any()


# -- the nonlinear kernels (fused_nl_loop.cu, fused_vb_iter.cu) -------------

# The polynomials above degree 0 run on short series: their uncentred designs
# (1, t, t^2, t^3 over t = 1..T) grow ill-conditioned with T, and in
# float32 summation order alone then moves the solve.
NL_SHORT = {"poly1-S": 12, "poly2-A": 8, "poly3-F": 8}
NL_MODELS = {
    # name: (model options, true model-space parameters)
    "exp": ({"model": "exp"}, [1.5, 2.0]),
    "biexp": ({"model": "biexp"}, [1.5, 0.5, 1.5, 5.0]),
    "poly0-L": ({"model": "poly", "degree": "0", "PSP_byname1": "c0",
                 "PSP_byname1_transform": "L"}, [2.0]),
    "poly1-S": ({"model": "poly", "degree": "1", "PSP_byname1": "c0",
                 "PSP_byname1_transform": "S"}, [2.0, 0.05]),
    "poly2-A": ({"model": "poly", "degree": "2", "PSP_byname2": "c1",
                 "PSP_byname2_transform": "A"}, [2.0, 0.05, 0.001]),
    "poly3-F": ({"model": "poly", "degree": "3", "PSP_byname1": "c0",
                 "PSP_byname1_transform": "F"}, [0.4, 0.05, 0.001, 1e-5]),
}
# every instance of csrc/vb_device.cuh FABBER_NL_INSTANCES: the exp
# family at Q = 1..4, poly at Q = 1, 2
NL_CASES = [(name, nq) for name in NL_MODELS
            for nq in ((1, 2, 3, 4) if "exp" in name else (1, 2))]
NL_IDS = [f"{name}-Q{nq}" for name, nq in NL_CASES]


def nl_inputs(name, nq, nv, device, nt=None, seed=0):
    """Kernel inputs from one numpy seed: data = model(truth) + N(0,
    0.02^2), the centre at the latent truth plus N(0, 0.05^2), weak
    priors (pm 0, pp 1e-5), nq groups alternating in time, sample T/3
    masked."""
    from fabber_core_tpu_torch.models import (get_model_class,
                                              resolve_parameters)
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.options import RunOptions
    extra, truth = NL_MODELS[name]
    nt = nt or NL_SHORT.get(name, 40)
    opts = RunOptions({"dt": "0.1", "noise": "white", **extra})
    model = get_model_class(extra["model"])(opts)
    params = resolve_parameters(model, opts)
    rng = np.random.default_rng(seed)
    p = len(truth)
    mt = np.asarray(truth)[:, None] * rng.uniform(0.8, 1.2, (p, nv))
    t = fv.time_index(nt, torch.float64, "cpu")
    sig = model.time_signal([torch.as_tensor(mt[i:i + 1]) for i in range(p)],
                            t).expand(nt, nv).numpy()
    lat = np.stack([np.asarray(pr.transform.to_latent(torch.as_tensor(
        mt[i]))) for i, pr in enumerate(params)])
    q = np.zeros((nq, nt))
    q[np.arange(nt) % nq, np.arange(nt)] = 1.0
    q[:, nt // 3] = 0.0

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=device)

    return dict(
        model=model, tr=[pr.transform for pr in params], q=q, nq=nq, p=p,
        data=dev(sig + 0.02 * rng.standard_normal((nt, nv))),
        centre=dev(lat + 0.05 * rng.standard_normal((p, nv))),
        pm=dev(np.zeros((p, nv))), pp=dev(np.full((p, nv), 1e-5)),
        phi=dev(np.full((nq, nv), 2500.0)))


def sd_err(got, ref, cov):
    p = cov.shape[0]
    sd = torch.sqrt(torch.stack([cov[i, i] for i in range(p)])).double()
    return float(((got.double() - ref.double()).abs() / sd).max())


def to_f64(args):
    return tuple(a.double() if torch.is_tensor(a) else a
                 for a in args)


def assert_near_f64(k, r32, r64):
    """The kernel (float32) against the plain version at float64 on the
    same inputs: each output no further from float64 than twice the
    plain version's own float32 result is, and within 1e-3 in any case
    (means in posterior sd, the others relative to their max).

    Why float64 and not the plain float32 result: both float32
    implementations carry a shared error from evaluating the model on
    float32 inputs, which the cubic's uncentred design amplifies (one
    iteration of poly3-F on the H100: 6.0e-2 sd from float64 for the
    plain version, 5.8e-2 for the kernel, 5.2e-2 between the two).
    Over every case here the kernel's distance from float64 measured
    at most 0.72 of this bound on the H100."""
    e_means = sd_err(k[0], r64[0], r64[2])
    assert e_means <= max(1e-3, 2 * sd_err(r32[0], r64[0], r64[2])), e_means
    for i in range(1, 7):
        assert k[i].shape == r64[i].shape
        e = rel(k[i], r64[i])
        assert e <= max(1e-3, 2 * rel(r32[i], r64[i])), (i, e)


@pytest.mark.parametrize("nv", [1000, 1024])
@pytest.mark.parametrize("name,nq", NL_CASES, ids=NL_IDS)
def test_nl_loop_kernel_matches_plain(cuda, name, nq, nv):
    """Every instance of fused_nl_loop.cu, 10 iterations with F, held
    to the plain version at float64 (assert_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    c = nl_inputs(name, nq, nv, cuda)
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                               c["q"].sum(axis=1), 1e-8, 50.0, nq)
    args = (c["centre"], c["pm"], c["pp"], c["data"], c["q"], consts, 10,
            True)
    before = nl.fused_nl_loop.launches
    k = nl.fused_nl_loop(c["model"], c["tr"], *args)
    assert nl.fused_nl_loop.launches == before + 1
    tsj = c["model"].time_signal_jac
    assert_near_f64(k, nl.fused_nl_loop_plain(tsj, c["tr"], *args),
                    nl.fused_nl_loop_plain(tsj, c["tr"], *to_f64(args)))


@pytest.mark.parametrize("name,nq", NL_CASES, ids=NL_IDS)
def test_fused_iteration_kernel_matches_plain(cuda, name, nq):
    """Every instance of fused_vb_iter.cu, one iteration with F, ragged
    voxel count, held to the plain version at float64
    (assert_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = nl_inputs(name, nq, 3001, cuda, seed=1)
    args = (c["centre"], c["pm"], c["pp"], c["phi"], c["data"], c["q"], True)
    before = fv.fused_iteration.launches
    k = fv.fused_iteration(c["model"], c["tr"], *args)
    assert fv.fused_iteration.launches == before + 1
    tsj = c["model"].time_signal_jac
    assert_near_f64(k, fv.fused_iteration_plain(tsj, c["tr"], *args),
                    fv.fused_iteration_plain(tsj, c["tr"], *to_f64(args)))


def test_nl_instances_are_the_listed_ones(cuda):
    """The route gate's instance query answers from the one list,
    csrc/vb_device.cuh FABBER_NL_INSTANCES."""
    from fabber_core_tpu_torch.models.base import (KERNEL_EXP, KERNEL_POLY,
                                                   KernelModel)
    from fabber_core_tpu_torch.ops import fused_vb as fv
    for p in (2, 4):
        for nq in (1, 2, 3, 4):
            assert fv.kernel_instantiated(KernelModel(KERNEL_EXP, p), nq)
        assert not fv.kernel_instantiated(KernelModel(KERNEL_EXP, p), 5)
    assert not fv.kernel_instantiated(KernelModel(KERNEL_EXP, 6), 1)
    for p in (1, 2, 3, 4):
        for nq in (1, 2):
            assert fv.kernel_instantiated(KernelModel(KERNEL_POLY, p), nq)
        assert not fv.kernel_instantiated(KernelModel(KERNEL_POLY, p), 3)
    assert not fv.kernel_instantiated(KernelModel(KERNEL_POLY, 5), 1)


def test_engine_on_card_refuses_runs_without_an_instance(cuda):
    """A cuda run the kernels have no instance for raises at
    construction: it never runs plain torch on the card."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions
    data = np.ones((64, 30), np.float32)
    for model, extra in (("exp", {"noise-pattern": "12345"}),
                         ("exp", {"num-exps": "3"}),
                         ("poly", {"degree": "4", "PSP_byname1": "c0",
                                   "PSP_byname1_transform": "L"})):
        opts = RunOptions({"model": model, "dt": "0.1", "noise": "white",
                           "dtype": "single", **extra})
        with pytest.raises(NotImplementedError, match="FABBER_NL_INSTANCES"):
            VBInference(get_model_class(model)(opts), opts, data,
                        device=cuda)


def test_nl_kernels_without_f_write_zeros(cuda):
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = nl_inputs("biexp", 1, 500, cuda)
    consts = nl.pack_nl_consts([1e6], [1e-6], c["q"].sum(axis=1), 1e-8,
                               50.0, 1)
    k = nl.fused_nl_loop(c["model"], c["tr"], c["centre"], c["pm"], c["pp"],
                         c["data"], c["q"], consts, 3, False)
    assert not k[5].any() and not k[6].any()
    k = fv.fused_iteration(c["model"], c["tr"], c["centre"], c["pm"],
                           c["pp"], c["phi"], c["data"], c["q"], False)
    assert not k[5].any() and not k[6].any()


def test_nl_wrappers_refuse_what_no_kernel_takes(cuda):
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = nl_inputs("exp", 1, 64, cuda)
    q5 = np.ones((5, 40)) / 5
    with pytest.raises(ValueError, match="instantiation"):
        fv.fused_iteration(c["model"], c["tr"], c["centre"], c["pm"],
                           c["pp"], torch.ones((5, 64), device=cuda),
                           c["data"], q5, True)
    with pytest.raises(TypeError):
        fv.fused_iteration(c["model"], c["tr"], c["centre"].double(),
                           c["pm"], c["pp"], c["phi"], c["data"], c["q"],
                           True)
    with pytest.raises(ValueError, match="is on"):
        fv.fused_iteration(c["model"], c["tr"], c["centre"], c["pm"].cpu(),
                           c["pp"], c["phi"], c["data"], c["q"], True)


@pytest.mark.parametrize("extra,route", [
    ({}, "pallas-loop-nl"), ({"engine-kernel": "pallas"}, "pallas"),
    ({"noise-pattern": "12"}, "pallas-loop-nl")],
    ids=["pallas-loop-nl", "pallas", "pattern-12"])
def test_exp_engine_on_card_matches_cpu(cuda, extra, route):
    """The exp engine on the card (the kernels) against the CPU engine
    (their plain versions): tests/test_fused_loop_nl.py's tolerances."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.options import RunOptions

    rng = np.random.default_rng(0)
    nv, nt = 3000, 24
    t = np.arange(nt) * 0.05
    data = (rng.uniform(0.5, 2.0, (nv, 1)) * np.exp(-t)[None]
            + rng.normal(0, 0.05, (nv, nt))).astype(np.float32)
    res = {}
    for dev in (cuda, "cpu"):
        opts = RunOptions({"model": "exp", "dt": "0.05", "noise": "white",
                           "dtype": "single", "save-free-energy": True,
                           **extra})
        eng = VBInference(get_model_class("exp")(opts), opts, data,
                          device=dev)
        assert eng.route == route
        n0 = nl.fused_nl_loop.launches + fv.fused_iteration.launches
        res[str(dev)] = eng.run()
        n1 = nl.fused_nl_loop.launches + fv.fused_iteration.launches
        assert (n1 - n0) == (0 if dev == "cpu" else
                             (1 if route == "pallas-loop-nl" else 10))
    g, c = res[str(cuda)], res["cpu"]
    sd = np.sqrt(np.diagonal(c.cov, axis1=1, axis2=2))
    assert np.max(np.abs(g.means - c.means) / sd) < 5e-3
    np.testing.assert_allclose(g.means, c.means, rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(g.noise_means, c.noise_means, rtol=2e-3)
    np.testing.assert_allclose(g.free_energy, c.free_energy, rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_array_equal(g.iterations, c.iterations)
    np.testing.assert_array_equal(g.bad_voxels, c.bad_voxels)


# -- the detector modes (spectral_core.cu 2d, fused_nl_loop.cu 6d,
#    fused_vb_iter.cu 7l) ---------------------------------------------------
#
# A detector's decisions are discontinuous (|dF| < 0.01 on an F of a few
# hundred flips on the last float32 bits), so the kernel is held to the
# plain version at float64 lane by lane on its decisions: the share of
# lanes whose (iteration count, revert) differs from float64 may be at
# most twice the plain float32 version's own share, plus 1e-3. On the
# lanes whose decisions match float64 the outputs are held as
# assert_near_f64 holds them.

def decisions(its, rev):
    return torch.stack([its.double(), rev.double()])


def assert_detector_near_f64(k, r32, r64, dk, d32, d64):
    """k/r32/r64: the outputs of the kernel, the plain version at
    float32 and at float64; dk/d32/d64: their decisions [2,V]."""
    miss_k = (dk != d64).any(dim=0)
    miss_32 = (d32 != d64).any(dim=0)
    share_k = float(miss_k.double().mean())
    share_32 = float(miss_32.double().mean())
    assert share_k <= 2 * share_32 + 1e-3, (share_k, share_32)
    keep = ~(miss_k | miss_32)
    sub = [tuple(x[..., keep] for x in o) for o in (k, r32, r64)]
    assert_near_f64(*sub)


def poly_stats(nv, device, seed=0, p=3, nt=30):
    """The spectral kernels' inputs for a poly-like fixed design: the
    plain statistics of noisy data, and the core's constants."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = design(p, nt)
    q = np.ones(nt)
    truth = torch.rand((p, nv), generator=gen, device=device) * 4 - 2
    data = torch.as_tensor(d, dtype=torch.float32, device=device) @ truth
    data += 0.3 * torch.randn((nt, nv), generator=gen, device=device)
    tc = fs.pack_mxu_consts(d, q, nt, torch.float32, device)
    ac = fs.pack_solve_consts(d, q, nt, torch.float32)
    c_post = (nt - 1) * 0.5 + 1e-6
    from fabber_core_tpu_torch.ops.spectral import eigen_elbo_const
    sc = fs.pack_spectral_consts(
        d, q, nt, np.full(p, 1e-6), 1e-6, c_post, 1e-8, 50.0,
        torch.float32, (eigen_elbo_const(q, c_post, 1e-6, 1e6, p),
                        c_post + 0.5))
    stats = fs.spectral_stats_plain(data, tc, ac)
    pm = torch.zeros((p, nv), device=device)
    return stats, pm, sc


def detector(kind, extra=None):
    from fabber_core_tpu_torch.inference.convergence import (
        get_detector_class)
    from fabber_core_tpu_torch.options import RunOptions
    return get_detector_class(kind)(RunOptions(
        {"max-iterations": "10", **(extra or {})}))


@pytest.mark.parametrize("nv", [70_001, 65_536])
@pytest.mark.parametrize("kind", ["pointzeroone", "freduce", "trialmode"])
def test_spectral_core_detector_matches_plain(cuda, kind, nv):
    """2d: the core kernel's detector mode against its plain version at
    float64 (assert_detector_near_f64), at the engine's loop bound."""
    stats, pm, sc = poly_stats(nv, cuda)
    det = detector(kind, {"max-trials": "3"})
    cap = int(det.max_iterations) + 2
    before = fs.spectral_core.det_launches
    k = fs.spectral_core(*stats, pm, sc, cap, det)
    assert fs.spectral_core.det_launches == before + 1
    r32 = fs.spectral_core_plain(*stats, pm, sc, cap, det)
    r64 = fs.spectral_core_plain(*to_f64(stats), pm.double(), sc.double(),
                                 cap, det)

    def dec(o):
        return decisions(o[6][0], o[3][0] < 0)

    def tidy(o):
        return (o[0], o[1], o[2], o[3].abs(), o[4], o[5], o[6])

    assert_detector_near_f64(tidy(k), tidy(r32), tidy(r64), dec(k),
                             dec(r32), dec(r64))


def nl_detector(kind, nq, nt, model):
    """The whole-loop kernel's detector dict, from an engine on the CPU
    (its host ELBO constants)."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.options import RunOptions
    opts = RunOptions({"model": model, "dt": "0.1", "noise": "white",
                       "dtype": "single", "convergence": kind,
                       "max-iterations": "6", "max-trials": "3",
                       "noise-pattern": "1234"[:nq]})
    from fabber_core_tpu_torch.models import get_model_class
    eng = VBInference(get_model_class(model)(opts), opts,
                      np.ones((4, nt), np.float32), device="cpu")
    return eng._nl_fdet_consts()


@pytest.mark.parametrize("kind", ["pointzeroone", "freduce", "trialmode",
                                  "lm"])
@pytest.mark.parametrize("name,nq,iters", [
    ("exp", 1, 6), ("exp", 2, 6), ("biexp", 1, 3), ("biexp", 4, 3)],
    ids=["exp-Q1", "exp-Q2", "biexp-Q1", "biexp-Q4"])
def test_nl_loop_detector_kernel_matches_plain(cuda, name, nq, iters,
                                               kind):
    """6d: the whole-loop kernel's detector modes against the plain
    version at float64 (assert_detector_near_f64); biexp at a short
    horizon (its float32 fixed point is chaotic further out)."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    c = nl_inputs(name, nq, 3001, cuda, seed=2)
    nt = c["data"].shape[0]
    det = nl_detector(kind, nq, nt, name)
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                               c["q"].sum(axis=1), 1e-8, 50.0, nq)
    pd0 = torch.full_like(c["centre"], 0.5)
    args = (c["centre"], c["pm"], c["pp"], c["data"], c["q"], consts,
            iters, True)
    before = nl.fused_nl_loop.det_launches
    k = nl.fused_nl_loop(c["model"], c["tr"], *args, detector=det,
                         post_var0=pd0)
    assert nl.fused_nl_loop.det_launches == before + 1
    tsj = c["model"].time_signal_jac
    r32 = nl.fused_nl_loop_plain(tsj, c["tr"], *args, detector=det,
                                 post_var0=pd0)
    r64 = nl.fused_nl_loop_plain(tsj, c["tr"], *to_f64(args), detector=det,
                                 post_var0=pd0.double())

    def dec(o):
        rev = o[5][1] if kind == "freduce" else torch.zeros_like(o[6][0])
        return decisions(o[6][0], rev)

    assert_detector_near_f64(k, r32, r64, dec(k), dec(r32), dec(r64))


@pytest.mark.parametrize("name,nq", NL_CASES, ids=NL_IDS)
def test_fused_iteration_lm_kernel_matches_plain(cuda, name, nq):
    """7l: every instance of fused_vb_iter.cu with its LM branch, alpha
    0 (the plain step) in a quarter of the voxels and 1e-6..1e2
    elsewhere, held to the plain version at float64
    (assert_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = nl_inputs(name, nq, 3001, cuda, seed=3)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    alpha = 10.0 ** (torch.rand(3001, generator=gen, device=cuda) * 8 - 6)
    alpha[::4] = 0.0
    args = (c["centre"], c["pm"], c["pp"], c["phi"], c["data"], c["q"], True)
    before = fv.fused_iteration.lm_launches
    k = fv.fused_iteration(c["model"], c["tr"], *args, alpha)
    assert fv.fused_iteration.lm_launches == before + 1
    tsj = c["model"].time_signal_jac
    assert_near_f64(
        k, fv.fused_iteration_plain(tsj, c["tr"], *args, alpha),
        fv.fused_iteration_plain(tsj, c["tr"], *to_f64(args),
                                 alpha.double()))
