"""CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc: without them every test here
skips (the `cuda` fixture decides at run time). On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

No jax here: the GPU machine runs the port alone. Bounds are those of
chip_smoke.py: errors over the max |plain| of each quantity, except
where a kernel is held to float64 (assert_near_f64: each lane in its
own scale, lane_rel).
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


def lane_errors(got, ref):
    """[V]: per lane, the largest error of one output in the lane's own
    scale (chip_smoke.py lane_rel): a [P,P,V] matrix element by element
    over sqrt(|ref_ii ref_jj|); a row over |ref|, or over max(|ref|, 1)
    where it changes sign across lanes (F, in nats)."""
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


def lane_rel(got, ref):
    """The largest of lane_errors over the lanes."""
    return float(lane_errors(got, ref).max())


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
# models past the prebuilt list (per-shape instances, ops/_cuda.py
# build_instance "nl"): exp num-exps 5, P = 10
WIDE_NL_MODELS = {"exp5": ({"model": "exp", "num-exps": "5"},
                           [1.5, 0.2, 1.0, 0.8, 0.75, 2.5, 0.5, 6.0, 0.4,
                            15.0]),
                  # P = 18: past ops/_cuda.py ROLL_P, its loops rolled
                  "exp9": ({"model": "exp", "num-exps": "9"},
                           [v for i in range(9)
                            for v in (0.3, 0.2 * 1.6 ** i)]),
                  # P = 44: kernel 7's cooperative form
                  "exp22": ({"model": "exp", "num-exps": "22"},
                            [v for i in range(22)
                             for v in (0.1, 0.2 * 1.25 ** i)])}
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
    extra, truth = {**NL_MODELS, **WIDE_NL_MODELS}[name]
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


def assert_near_f64(k, r32, r64, per_lane=True):
    """The kernel (float32) against the plain version at float64 on the
    same inputs: each output no further from float64 than twice the
    plain version's own float32 result is, and within 1e-3 in any case
    (means in posterior sd, the others relative to their max; with
    per_lane, also each output's worst lane in the lane's own scale:
    lane_rel).

    Why float64 and not the plain float32 result: both float32
    implementations carry a shared error from evaluating the model on
    float32 inputs, which the cubic's uncentred design amplifies (one
    iteration of poly3-F on the H100: 6.0e-2 sd from float64 for the
    plain version, 5.8e-2 for the kernel, 5.2e-2 between the two).
    Over every case here the kernel's distance from float64 measured
    at most 0.72 of the bound relative to the max on the H100."""
    e_means = sd_err(k[0], r64[0], r64[2])
    assert e_means <= max(1e-3, 2 * sd_err(r32[0], r64[0], r64[2])), e_means
    for i in range(1, len(k)):
        assert k[i].shape == r64[i].shape
        e = rel(k[i], r64[i])
        assert e <= max(1e-3, 2 * rel(r32[i], r64[i])), (i, e)
        if per_lane:
            e = lane_rel(k[i], r64[i])
            assert e <= max(1e-3, 2 * lane_rel(r32[i], r64[i])), (i, e)


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
    for p in (6, 8):
        for nq in (1, 2):
            assert fv.kernel_instantiated(KernelModel(KERNEL_EXP, p), nq)
        assert not fv.kernel_instantiated(KernelModel(KERNEL_EXP, p), 3)
    assert not fv.kernel_instantiated(KernelModel(KERNEL_EXP, 10), 1)
    for p in (1, 2, 3, 4):
        for nq in (1, 2):
            assert fv.kernel_instantiated(KernelModel(KERNEL_POLY, p), nq)
        assert not fv.kernel_instantiated(KernelModel(KERNEL_POLY, p), 3)
    assert not fv.kernel_instantiated(KernelModel(KERNEL_POLY, 5), 1)
    # past the list, per-shape instances (none built here)
    for kernel in ("nl_loop", "vb_iter"):
        assert fv.nl_instantiated(KernelModel(KERNEL_EXP, 10), 1, kernel)
        assert fv.nl_instantiated(KernelModel(KERNEL_EXP, 4), 35, kernel)
        assert fv.nl_instantiated(KernelModel(KERNEL_POLY, 5), 3, kernel)
        assert not fv.nl_instantiated(KernelModel(KERNEL_EXP, 5), 1, kernel)
        assert not fv.nl_instantiated(None, 1, kernel)
    # kernel 7's cooperative form to kCoopMaxP, kernel 6 to kWideMaxP
    assert not fv.nl_instantiated(KernelModel(KERNEL_EXP, 44), 1, "nl_loop")
    assert fv.nl_instantiated(KernelModel(KERNEL_EXP, 44), 1, "vb_iter")
    assert not fv.nl_instantiated(KernelModel(KERNEL_EXP, 144), 1, "vb_iter")


def test_engine_on_card_refuses_runs_without_an_instance(cuda):
    """A cuda run the kernels cannot serve raises at construction, before
    any launch: it never runs plain torch on the card. Past the prebuilt
    list a per-shape instance serves kernels 6-8 (five noise groups:
    built at the route's first launch, not at construction), kernel 7
    past P = 16 in its cooperative form (exp num-exps 22, P = 44, where
    the JAX picker admits no kernel 6), so only kernel 7 past its
    shared-memory bound raises (exp num-exps 72, P = 144); exp at
    num-exps 3 runs its hand-written ExpSum<3>, and poly degree 4 with a
    log transform (P = 5, no hand-written PolyModel<5>) a per-shape
    PolyModel<5> instance."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions
    data = np.ones((64, 30), np.float32)
    opts = RunOptions({"model": "exp", "dt": "0.1", "noise": "white",
                       "dtype": "single", "noise-pattern": "12345"})
    eng = VBInference(get_model_class("exp")(opts), opts, data, device=cuda)
    assert eng.route == "pallas-loop-nl" and eng.functor is None
    opts = RunOptions({"model": "exp", "dt": "0.1", "noise": "white",
                       "dtype": "single", "num-exps": "22"})
    eng = VBInference(get_model_class("exp")(opts), opts, data, device=cuda)
    assert eng.route == "pallas" and eng.functor is None
    opts = RunOptions({"model": "exp", "dt": "0.1", "noise": "white",
                       "dtype": "single", "num-exps": "72"})
    with pytest.raises(NotImplementedError,
                       match="shared memory.*bounds P at 143.*kCoopMaxP"):
        VBInference(get_model_class("exp")(opts), opts, data, device=cuda)
    for model, extra, generated in (
            ("exp", {"num-exps": "3"}, False),
            ("poly", {"degree": "4", "PSP_byname1": "c0",
                      "PSP_byname1_transform": "L"}, False)):
        opts = RunOptions({"model": model, "dt": "0.1", "noise": "white",
                           "dtype": "single", **extra})
        eng = VBInference(get_model_class(model)(opts), opts, data,
                          device=cuda)
        assert eng.route == "pallas-loop-nl"
        assert (eng.functor is not None) == generated


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
    """No kernel takes 36 noise groups (a pattern has at most 35, csrc/
    vb_device.cuh kWideMaxQ; fewer past the prebuilt list are per-shape
    instances), a float64 plane, or a plane off the card."""
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = nl_inputs("exp", 1, 64, cuda)
    q36 = np.ones((36, 40)) / 36
    with pytest.raises(ValueError, match="instantiation"):
        fv.fused_iteration(c["model"], c["tr"], c["centre"], c["pm"],
                           c["pp"], torch.ones((36, 64), device=cuda),
                           c["data"], q36, True)
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


def assert_detector_near_f64(k, r32, r64, dk, d32, d64, tol=1e-2):
    """k/r32/r64: the outputs of the kernel, the plain version at
    float32 and at float64; dk/d32/d64: their decisions [2,V]. The
    kernel's share of lanes whose decisions differ from float64 at most
    twice the plain float32 version's + 1e-3; on the lanes where both
    agree, assert_near_f64 relative to each output's max, and in each
    lane's own scale a lane is off where an output lies beyond tol of
    float64 (an lm step taken or refused, or a revert that is no
    output, moves a lane's state without a decision to show it): the
    kernel's share of lanes off at most twice the plain float32
    version's + 1e-3 (chip_smoke.py near_f64)."""
    miss_k = (dk != d64).any(dim=0)
    miss_32 = (d32 != d64).any(dim=0)
    share_k = float(miss_k.double().mean())
    share_32 = float(miss_32.double().mean())
    assert share_k <= 2 * share_32 + 1e-3, (share_k, share_32)
    keep = ~(miss_k | miss_32)
    sub = [tuple(x[..., keep] for x in o) for o in (k, r32, r64)]
    assert_near_f64(*sub, per_lane=False)
    ref = sub[2]
    p = ref[0].shape[0]
    sd = torch.sqrt(torch.stack([ref[2][i, i] for i in range(p)])).double()

    def share_off(o):
        e = ((o[0].double() - ref[0].double()).abs() / sd).amax(dim=0)
        for i in range(1, len(o)):
            e = torch.maximum(e, lane_errors(o[i], ref[i]))
        return float((~(e <= tol)).double().mean())
    off_k, off_32 = share_off(sub[0]), share_off(sub[1])
    assert off_k <= 2 * off_32 + 1e-3, (off_k, off_32)


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


# -- the fixed-design kernels (fused_whole.cu kernel 4, fused_loop.cu
#    kernel 5, spectral_fused.cu kernel 3) ----------------------------------

WHOLE_INSTANCES = [(p, nq) for p in (1, 2, 3, 4) for nq in (1, 2, 3)]
WHOLE_IDS = [f"P{p}-Q{nq}" for p, nq in WHOLE_INSTANCES]


def whole_inputs(p, nq, nv, device, nt=40, seed=0):
    """Kernel 4's inputs from one numpy seed: a cosine design, nq
    groups alternating in time with sample 3 masked, noise sd per group
    and per voxel (log-uniform, so detector lanes stop apart), weak
    priors around random means."""
    from fabber_core_tpu_torch.ops import fused_whole as fw
    rng = np.random.default_rng(seed + 10 * p + nq)
    d = design(p, nt)
    q = np.zeros((nq, nt))
    q[np.arange(nt) % nq, np.arange(nt)] = 1.0
    q[:, 3] = 0.0
    sd = 10.0 ** rng.uniform(-2, 0.5, nv)
    gsd = 1.0 + np.arange(nq)[np.arange(nt) % nq]
    data = d @ rng.uniform(-2, 2, (p, nv)) \
        + gsd[:, None] * sd * rng.standard_normal((nt, nv))

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=device)

    consts = fw.pack_whole_consts(d, q, nt, np.full(nq, 1e6),
                                  np.full(nq, 1e-6), q.sum(axis=1), 1e-8,
                                  50.0)
    return (dev(data), fw.pack_whole_time_consts(d, q, nt, torch.float32,
                                                 device), consts,
            dev(rng.uniform(-0.5, 0.5, (p, nv))), dev(np.full((p, nv), 1e-3)))


def whole_detector(kind, p, nq, nt=40):
    """Kernel 4's detector dict (host ELBO constants of an engine on the
    CPU with the same groups) and the engine's loop cap."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions
    opts = RunOptions({"model": "poly", "degree": str(p - 1),
                       "noise": "white", "dtype": "single",
                       "convergence": kind, "max-iterations": "8",
                       "max-trials": "3", "noise-pattern": "123"[:nq],
                       "mt1": "4"})
    eng = VBInference(get_model_class("poly")(opts), opts,
                      np.ones((4, nt), np.float32), device="cpu")
    return eng._nl_fdet_consts(), eng.max_iter_cap


@pytest.mark.parametrize("locked", [-1.0, 0.3], ids=["free", "locked"])
@pytest.mark.parametrize("p,nq", WHOLE_INSTANCES, ids=WHOLE_IDS)
def test_whole_kernel_matches_plain(cuda, p, nq, locked):
    """Every (P, Q) instance of kernel 4 in maxits, 10 iterations,
    ragged voxel count, held to the plain version at float64
    (assert_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_whole as fw
    args = whole_inputs(p, nq, 20_001, cuda)
    before = fw.fused_whole.launches
    k = fw.fused_whole(*args, 10, locked)
    assert fw.fused_whole.launches == before + 1
    assert_near_f64(k, fw.fused_whole_plain(*args, 10, locked),
                    fw.fused_whole_plain(*to_f64(args), 10, locked))


@pytest.mark.parametrize("kind", ["pointzeroone", "trialmode", "lm"])
@pytest.mark.parametrize("p,nq", WHOLE_INSTANCES, ids=WHOLE_IDS)
def test_whole_kernel_detector_matches_plain(cuda, p, nq, kind):
    """Every (P, Q) instance of kernel 4's detector modes (MODE 1:
    pointzeroone; MODE 2: trialmode, lm) at the engine's loop cap,
    held to the plain version at float64 by decision share
    (assert_detector_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_whole as fw
    args = whole_inputs(p, nq, 20_001, cuda, seed=1)
    det, cap = whole_detector(kind, p, nq)
    before = (fw.fused_whole.det_launches, fw.fused_whole.lm_launches)
    k = fw.fused_whole(*args, cap, -1.0, det)
    assert fw.fused_whole.det_launches == before[0] + 1
    assert fw.fused_whole.lm_launches == before[1] + (kind == "lm")
    r32 = fw.fused_whole_plain(*args, cap, -1.0, det)
    r64 = fw.fused_whole_plain(*to_f64(args), cap, -1.0, det)

    def dec(o):
        return decisions(o[6][0], torch.zeros_like(o[6][0]))

    assert_detector_near_f64(k, r32, r64, dec(k), dec(r32), dec(r64))


@pytest.mark.parametrize("p,nq", WHOLE_INSTANCES, ids=WHOLE_IDS)
def test_vb_loop_kernel_matches_plain(cuda, p, nq):
    """Every (P, Q) instance of kernel 5, from the plain statistics,
    held to the plain version at float64 on the same statistics."""
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.ops import fused_whole as fw
    data, tc, consts, pm, pp = whole_inputs(p, nq, 20_001, cuda, seed=2)
    stats = fw.whole_stats_plain(data, tc, consts, p, nq)
    stats = tuple(x.contiguous() for x in stats)
    before = fl.fused_vb_loop.launches
    k = fl.fused_vb_loop(*stats, consts, pm, pp, 10)
    assert fl.fused_vb_loop.launches == before + 1
    r32 = fl.fused_vb_loop_plain(*stats, consts, pm, pp, 10)
    r64 = fl.fused_vb_loop_plain(*to_f64(stats), consts, pm.double(),
                                 pp.double(), 10)
    e = sd_err(k[0], r64[0], r64[2])
    assert e <= max(1e-3, 2 * sd_err(r32[0], r64[0], r64[2])), e
    for i in range(1, 5):
        e = lane_rel(k[i], r64[i])
        assert e <= max(1e-3, 2 * lane_rel(r32[i], r64[i])), (i, e)


def fused_inputs(p, nt, nv, cuda, seed=None):
    """Kernel 3's inputs: data [T,V] of design(p, nt) at random truths
    plus noise (two samples masked: 1 and 50, or nt // 2 on a shorter
    series), its constants and prior means."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(p if seed is None else seed)
    d = design(p, nt)
    q = np.ones(nt)
    q[[1, min(50, nt // 2)]] = 0.0
    data = torch.as_tensor(d, dtype=torch.float32, device=cuda) @ (
        torch.rand((p, nv), generator=gen, device=cuda) * 4 - 2)
    data += 0.3 * torch.randn((nt, nv), generator=gen, device=cuda)
    tc = fs.pack_mxu_consts(d, q, nt, torch.float32, cuda)
    ac = fs.pack_solve_consts(d, q, nt, torch.float32)
    c_post = (q.sum() - 1) * 0.5 + 1e-6
    sc = fs.pack_spectral_consts(d, q, nt, np.full(p, 1e-6), 1e-6, c_post,
                                 1e-8, 50.0, torch.float32,
                                 (-10.0, c_post + 0.5))
    pm = torch.rand((p, nv), generator=gen, device=cuda) - 0.5
    return data, tc, ac, pm, sc


def fused_detector(kind):
    """(detector or None, loop bound) of kernel 3's mode."""
    det = None if kind is None else detector(kind)
    return det, 10 if det is None else int(det.max_iterations) + 2


FUSED_FORMS = [0, 128, 64, 32]


@pytest.mark.parametrize("vb", FUSED_FORMS,
                         ids=["streamed", "vb128", "vb64", "vb32"])
@pytest.mark.parametrize("kind", [None, "pointzeroone", "freduce",
                                  "trialmode"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
def test_spectral_fused_matches_split_pair(cuda, p, kind, vb):
    """Kernel 3 runs the statistics and core kernels' device code in one
    thread: its outputs are the split pair's (kernels 1 + 2) bit for
    bit, in maxits and in each detector mode, streamed and staged at
    each of STATS_WIDTHS (on a ragged V: the last block part empty)."""
    from fabber_core_tpu_torch.ops import _cuda
    assert tuple(FUSED_FORMS[1:]) == _cuda.STATS_WIDTHS
    data, tc, ac, pm, sc = fused_inputs(p, 106, 30_001, cuda)
    det, n_iters = fused_detector(kind)
    before = (fs.spectral_fused.launches, fs.spectral_fused.det_launches,
              fs.spectral_fused.staged_launches)
    k = fs.spectral_fused(data, tc, ac, pm, sc, n_iters, det, _vb=vb)
    assert fs.spectral_fused.launches == before[0] + 1
    assert fs.spectral_fused.det_launches == before[1] + (det is not None)
    assert fs.spectral_fused.staged_launches == before[2] + (vb > 0)
    split = fs.spectral_core(*fs.spectral_stats(data, tc, ac), pm, sc,
                             n_iters, det)
    assert bits_equal(k, split)


@pytest.mark.parametrize("kind", [None, "trialmode"])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_spectral_fused_plan_edges_match_split_pair(cuda, p, kind):
    """Kernel 3 at every T on tile_plan's edges for its 2P + 1 design
    rows per sample (kernel 1's plan, STATS_WIDTHS; the last T
    streamed), in the form its plan picks (fused_spectral.fused_vb)
    and streamed: both equal the split pair bit for bit."""
    from fabber_core_tpu_torch.ops import _cuda
    det, n_iters = fused_detector(kind)
    for nt in plan_edges(2 * p + 1, _cuda.STATS_WIDTHS):
        data, tc, ac, pm, sc = fused_inputs(p, nt, 4000, cuda, seed=nt)
        st = fs.spectral_fused.staged_launches
        k = fs.spectral_fused(data, tc, ac, pm, sc, n_iters, det)
        assert fs.spectral_fused.staged_launches - st == int(
            fs.fused_vb(nt, p) > 0)
        split = fs.spectral_core(*fs.spectral_stats(data, tc, ac), pm, sc,
                                 n_iters, det)
        assert bits_equal(k, split), nt
        assert bits_equal(fs.spectral_fused(data, tc, ac, pm, sc, n_iters,
                                            det, _vb=0), split), nt


def test_spectral_fused_refused_tiles_raise(cuda):
    """Kernel 3 refuses a VB not a multiple of 32 or above 256 and a tile
    above 232,448 bytes (kernel 1's rule): the wrapper raises and counts
    no launch, nothing falls back to the other form."""
    from fabber_core_tpu_torch.exceptions import FabberError
    data, tc, ac, pm, sc = fused_inputs(3, 500, 256, cuda)
    for vb in (48, 288, 128):     # 128: 4 (500 x 128 + 7 x 500) B > 232,448
        n = fs.spectral_fused.launches
        with pytest.raises(FabberError, match="launch failed"):
            fs.spectral_fused(data, tc, ac, pm, sc, 10, _vb=vb)
        assert fs.spectral_fused.launches == n


def test_spectral_fused_occupancy_queries(cuda):
    """Kernel 3's plan at T=106 (P = 1, 3, 8) stages in blocks of 128
    lanes and keeps at least TILE_MIN_WARPS warps per SM in every mode;
    refused arguments give -1."""
    from fabber_core_tpu_torch.ops import _cuda
    for p in (1, 3, 8):
        for code in range(4):
            assert _cuda.fused_occupancy(p, code, 128, 106) * 4 \
                >= _cuda.TILE_MIN_WARPS
            assert _cuda.fused_occupancy(p, code, 0, 106) >= 1
    assert fs.fused_vb(106, 3) == 128
    assert _cuda.fused_occupancy(3, 0, 48, 106) == -1
    assert _cuda.fused_occupancy(3, 0, 128, 500) == -1
    assert _cuda.fused_occupancy(26, 0, 32, 106) == -1
    # P = 9: a per-shape instance, its factor and constants beside the rows
    assert _cuda.fused_occupancy(9, 0, 128, 106) * 4 \
        >= _cuda.TILE_MIN_WARPS
    assert _cuda.fused_occupancy(3, 4, 128, 106) == -1


def test_whole_instances_are_the_listed_ones(cuda):
    """The library's instance query answers from the one list,
    csrc/whole_device.cuh FABBER_WHOLE_INSTANCES; the route gate's adds
    the per-shape instances (P <= 20, Q <= 4), decided without a build."""
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops.fused_loop import whole_instantiated
    for p in range(1, 9):
        for nq in (1, 2, 3):
            assert _cuda.has_whole_instance(p, nq) == (nq < 3 or p <= 5)
        assert not _cuda.has_whole_instance(p, 4)
        assert whole_instantiated(p, 4)
    assert not _cuda.has_whole_instance(9, 1)
    assert whole_instantiated(9, 1) and whole_instantiated(20, 4)
    assert not whole_instantiated(21, 1) and not whole_instantiated(3, 5)


def wide_linear_runs(cuda, tmp_path, p, extra, nq=2, ar=False, nv=3000,
                     nt=30, seed=0):
    """linear P (the cosine design(p, nt) as a VEST basis file) on one
    data set: (the card's float32 run, its engine, its launches of kernels
    4, 5 and 9, the CPU's float32 and float64 runs). Truth U(-1, 1) per
    column, noise sd log-uniform over 1e-2..1 per voxel, x (1 + t mod nq) (white) or AR(1) of alpha 0.4 per
    echo (ar)."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.io import matfile
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    from fabber_core_tpu_torch.ops import fused_whole as fw
    from fabber_core_tpu_torch.options import RunOptions
    rng = np.random.default_rng(seed)
    d = design(p, nt)
    path = str(tmp_path / f"cosine{p}.mat")
    matfile.write_vest(d, path)
    e = rng.standard_normal((nt, nv))
    if ar:
        for k in range(nq, nt):
            e[k] += 0.4 * e[k - nq]
    else:
        e *= (1.0 + np.arange(nt) % nq)[:, None]
    data = (d @ rng.uniform(-1, 1, (p, nv))
            + 10.0 ** rng.uniform(-2, 0, nv) * e).T.astype(np.float32)
    kernels = (fw.fused_whole, fl.fused_vb_loop, fa.fused_ar_loop)

    def counts():
        return [k.launches for k in kernels]
    runs = {}
    for dev, dtype in ((cuda, "single"), ("cpu", "single"),
                       ("cpu", "double")):
        opts = RunOptions({"model": "linear", "basis": path,
                           "noise": "ar" if ar else "white",
                           "dtype": dtype, "print-free-energy": True,
                           **extra})
        eng = VBInference(get_model_class("linear")(opts), opts, data,
                          device=dev)
        before = counts()
        runs[str(dev), dtype] = (eng.run(), eng,
                                 [a - b for a, b in zip(counts(), before)])
    g, eng, launched = runs[str(cuda), "single"]
    return (g, eng, launched, runs["cpu", "single"][0],
            runs["cpu", "double"][0])


def assert_run_near_f64(g, c32, c64, na=0, max_flips=3):
    """A float32 run on the card (g) against the CPU's float64 run of the
    same configuration (c64), on the lanes whose iteration count both
    float32 runs share with it (at most max_flips others): its means
    (in float64 posterior sd), std and noise precision means (the
    columns from na: AR's alpha means, absolute, before) no further
    from float64 than twice the CPU float32 run (c32) is, and within
    1e-3 in any case, voxel by voxel."""
    flip = (g.iterations != c64.iterations) | (c32.iterations
                                               != c64.iterations)
    assert flip.sum() <= max_flips, flip.sum()
    ok = ~flip

    def errs(r):
        sd = np.sqrt(np.diagonal(c64.cov[ok], axis1=1, axis2=2))
        sdr = np.sqrt(np.diagonal(r.cov[ok], axis1=1, axis2=2))
        return (np.max(np.abs(r.means[ok] - c64.means[ok]) / sd),
                np.max(np.abs(sdr / sd - 1)),
                np.max(np.abs(r.noise_means[ok][:, na:]
                              / c64.noise_means[ok][:, na:] - 1)),
                np.max(np.abs(r.noise_means[ok][:, :na]
                              - c64.noise_means[ok][:, :na]), initial=0.0))
    for eg, e32 in zip(errs(g), errs(c32)):
        assert eg <= max(1e-3, 2 * e32), (eg, e32)
    assert not g.bad_voxels.any()


def test_engine_on_card_refuses_whole_runs_without_an_instance(cuda,
                                                               tmp_path):
    """The fixed-design kernels at P > 4 (their instances since P <= 4
    raised here): linear P = 5 with noise-pattern=12 on 'pallas-whole'
    (kernel 4) and P = 6 with engine-kernel=pallas-loop (kernel 5), each
    launched once, its P > 4 instance, and held to the CPU's float64
    run by assert_run_near_f64."""
    for p, extra, route, k in (
            (5, {"noise-pattern": "12"}, "pallas-whole", 0),
            (6, {"noise-pattern": "12", "engine-kernel": "pallas-loop"},
             "pallas-loop", 1)):
        g, eng, launched, c32, c64 = wide_linear_runs(cuda, tmp_path, p,
                                                      extra)
        assert eng.route == route and launched[k] == 1
        assert_run_near_f64(g, c32, c64)


FIXED_DESIGN_ROUTES = [
    ({"noise-pattern": "12"}, "pallas-whole"),
    ({"locked-noise-stdev": "0.2"}, "pallas-whole"),
    ({"convergence": "lm"}, "pallas-whole"),
    ({"convergence": "trialmode", "noise-pattern": "121"}, "pallas-whole"),
    ({"engine-kernel": "pallas-loop", "noise-pattern": "12"}, "pallas-loop"),
    ({"dtype": "bf16", "noise-pattern": "12"}, "pallas-loop"),
    ({"spectral-impl": "fused"}, "spectral-fused"),
    ({"spectral-impl": "fused", "convergence": "freduce"}, "spectral-fused"),
    ({"spectral-impl": "xstats"}, "spectral-xstats"),
]


@pytest.mark.parametrize("extra,route", FIXED_DESIGN_ROUTES,
                         ids=[r + ":" + "-".join(f"{k}={v}"
                                                 for k, v in e.items())
                              for e, r in FIXED_DESIGN_ROUTES])
def test_fixed_design_engine_on_card_matches_cpu(cuda, extra, route,
                                                 monkeypatch):
    """The fixed-design kernel routes on the card against the CPU engine
    (their plain versions): at most 3 lanes with another iteration
    count, means within 5e-3 posterior sd on the others, std and noise
    rtol 2e-3 per voxel. On the card no plain version of a kernel runs: each is
    replaced by one that raises for the card's run."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.ops import fused_whole as fw
    from fabber_core_tpu_torch.options import RunOptions
    rng = np.random.default_rng(0)
    nv, nt = 3000, 30
    t = np.arange(1, nt + 1)
    sd = 10.0 ** rng.uniform(-2, 0.5, (nv, 1))
    data = (rng.uniform(-1, 1, (nv, 1)) + rng.uniform(-.05, .05, (nv, 1)) * t
            + sd * rng.standard_normal((nv, nt))).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        if dev != "cpu":
            def refuse(*a, **k):
                raise AssertionError("a plain version ran on the card")
            for mod, name in ((fw, "fused_whole_plain"),
                              (fl, "fused_vb_loop_plain"),
                              (fs, "spectral_fused_plain"),
                              (fs, "spectral_core_plain"),
                              (fs, "spectral_stats_plain")):
                monkeypatch.setattr(mod, name, refuse)
        opts = RunOptions({"model": "poly", "degree": "2", "noise": "white",
                           "dtype": "single", "print-free-energy": True,
                           **extra})
        eng = VBInference(get_model_class("poly")(opts), opts, data,
                          device=dev)
        assert eng.route == route
        n0 = (fw.fused_whole.launches + fl.fused_vb_loop.launches
              + fs.spectral_fused.launches + fs.spectral_core.launches)
        res[str(dev)] = eng.run()
        n1 = (fw.fused_whole.launches + fl.fused_vb_loop.launches
              + fs.spectral_fused.launches + fs.spectral_core.launches)
        assert n1 - n0 == (0 if dev == "cpu" else 1)
    g, c = res[str(cuda)], res["cpu"]
    flip = g.iterations != c.iterations
    assert flip.sum() <= 3
    ok = ~flip
    sdp = np.sqrt(np.diagonal(c.cov[ok], axis1=1, axis2=2))
    assert np.max(np.abs(g.means[ok] - c.means[ok]) / sdp) < 5e-3
    np.testing.assert_allclose(
        np.sqrt(np.diagonal(g.cov[ok], axis1=1, axis2=2)), sdp, rtol=2e-3)
    np.testing.assert_allclose(g.noise_means[ok], c.noise_means[ok],
                               rtol=2e-3)
    np.testing.assert_array_equal(g.bad_voxels, c.bad_voxels)


# -- the NLLS kernel (fused_nlls.cu) -------------------------------------------
#
# A step's accept decision is discontinuous and float32 biexp is chaotic
# near its exchange symmetry, so the kernel is held to the plain version
# at float64 by shares of lanes "off" float64, each at most twice the
# plain float32 version's + 1e-3: lanes whose cost lies beyond 1e-3 of
# float64's or whose fit (the model at the params) lies beyond 1e-3 of
# float64's largest sample, and lanes with another iteration count too.
# The second share is large (40-60% of lanes for the plain float32
# version on the CPU): near the optimum a Gauss-Newton step's cost gain
# drops from above CFTOL to below float32's resolution in one step, so
# whether it is accepted, or rejected until the plateau exit, turns on
# rounding; fits and costs agree to ~1e-5 all the same.

# every (kind, P) of csrc/vb_device.cuh FABBER_NL_INSTANCES
NLLS_CASES = ["exp", "biexp", "poly0-L", "poly1-S", "poly2-A", "poly3-F"]


def nlls_inputs(name, nv, device, seed=0):
    """nl_inputs' data and start (latent truth + N(0, 0.05^2)), one group
    with its masked sample as the NLLS weights."""
    c = nl_inputs(name, 1, nv, device, seed=seed)
    c["tmask"] = c["q"].sum(axis=0)
    return c


def nlls_off(o, r64, c):
    """([V] bool, [V] bool): the lanes of the outputs o whose fit or
    cost is off float64 r64, and those off it in any of fit, cost and
    iteration count."""
    from fabber_core_tpu_torch.ops import fused_vb as fv
    t = fv.time_index(c["data"].shape[0], torch.float64, r64[0].device)
    tsj = c["model"].time_signal_jac

    def fit(params):
        return fv.block_eval(tsj, c["tr"], params.double(), t)[0]
    f64 = fit(r64[0])
    fit_off = (fit(o[0]) - f64).abs().amax(dim=0) > 1e-3 * f64.abs().max()
    cost_off = (o[1].double() - r64[1]).abs() > 1e-3 * r64[1].abs()
    its_off = o[2].double() != r64[2]
    fit_cost = ~(~fit_off & ~cost_off)             # NaN counts as off
    return fit_cost, fit_cost | its_off


def nlls_post_err(o, r64):
    """[V]: the larger of prec's and cov's errors against float64 in the
    lane's own scale (lane_errors)."""
    return torch.maximum(lane_errors(o[3], r64[3]), lane_errors(o[4], r64[4]))


@pytest.mark.parametrize("marquardt", [False, True], ids=["L", "LM"])
@pytest.mark.parametrize("name", NLLS_CASES)
def test_nlls_kernel_matches_plain(cuda, name, marquardt):
    """Every instance of fused_nlls.cu, fresh mode, ragged voxel count,
    held to the plain version at float64 by the module's share rule;
    the posterior (prec, cov) on the lanes where the kernel and plain
    float32 agree with float64 in fit and cost and plain float32's
    posterior is finite: the kernel's worst lane within max(1e-3, 2x
    plain float32's worst), as assert_near_f64 (poly3-F's plain float32
    reaches 8e-4 there); no lane past the budget."""
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    c = nlls_inputs(name, 3001, cuda)
    args = (c["centre"], c["data"], c["tmask"], 40, marquardt)
    before = fn.fused_nlls_loop.launches
    k = fn.fused_nlls_loop(c["model"], c["tr"], *args)
    assert fn.fused_nlls_loop.launches == before + 1
    assert_nlls_near_f64(c, k, args)


def assert_nlls_near_f64(c, k, args):
    """test_nlls_kernel_matches_plain's bounds on the kernel's outputs k
    for the plain version's arguments args (budget args[3])."""
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    tsj = c["model"].time_signal_jac
    r32 = fn.fused_nlls_loop_plain(tsj, c["tr"], *args)
    r64 = fn.fused_nlls_loop_plain(tsj, c["tr"], c["centre"].double(),
                                   c["data"].double(), *args[2:])
    offs = [nlls_off(o, r64, c) for o in (k, r32)]
    for off_k, off_32 in zip(*offs):
        share_k = float(off_k.double().mean())
        share_32 = float(off_32.double().mean())
        assert share_k <= 2 * share_32 + 1e-3, (share_k, share_32)
    e_k, e_32 = nlls_post_err(k, r64), nlls_post_err(r32, r64)
    keep = ~(offs[0][0] | offs[1][0]) & torch.isfinite(e_32)
    assert bool(keep.any())
    worst_k, worst_32 = float(e_k[keep].max()), float(e_32[keep].max())
    assert worst_k <= max(1e-3, 2 * worst_32), (worst_k, worst_32)
    assert float(k[2].max()) <= args[3] and float(k[2].min()) >= 1


@pytest.mark.parametrize("marquardt", [False, True], ids=["L", "LM"])
def test_nlls_two_phase_bit_identical_on_card(cuda, marquardt):
    """The engine's compaction (NLLSInference._solve_kernel: phase 1
    capped at 3, the lanes sorted by done, the resumed launch, the
    inverse permutation) gives the fresh launch's outputs bit for bit
    (csrc/fused_nlls.cu: one summation order, no contraction)."""
    from fabber_core_tpu_torch.inference.nlls import NLLSInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.options import RunOptions
    c = nlls_inputs("biexp", 20_001, cuda, seed=2)
    nt = c["data"].shape[0]
    opts = RunOptions({"model": "biexp", "dt": "0.1", "dtype": "single",
                       "mt1": str(nt // 3 + 1),
                       "nlls-phase1-iterations": "3",
                       "nlls-max-iterations": "60",
                       **({"lm": True} if marquardt else {})})
    eng = NLLSInference(get_model_class("biexp")(opts), opts, None,
                        data_plane=c["data"], device=cuda)
    np.testing.assert_array_equal(eng.tmask_host, c["tmask"])
    p0 = c["centre"]
    fresh = fn.fused_nlls_loop(c["model"], c["tr"], p0, c["data"],
                               c["tmask"], 60, marquardt)
    before = fn.fused_nlls_loop.resume_launches
    s, prec, cov = eng._solve_kernel(p0)
    assert fn.fused_nlls_loop.resume_launches == before + 1
    # a lane that made at most 3 steps was done in phase 1
    assert 0.0 < float((s.its <= 3).double().mean()) < 1.0
    for a, b in zip((s.params, s.cost, prec, cov),
                    (fresh[0], fresh[1], fresh[3], fresh[4])):
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    assert torch.equal(s.its, fresh[2].to(torch.int32))


def test_nlls_instances_are_the_listed_ones(cuda):
    from fabber_core_tpu_torch.models.base import (KERNEL_EXP, KERNEL_POLY,
                                                   KernelModel)
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    for p in (2, 4, 6, 8):
        assert fn.nlls_instantiated(KernelModel(KERNEL_EXP, p))
    assert not fn.nlls_instantiated(KernelModel(KERNEL_EXP, 10))
    for p in (1, 2, 3, 4):
        assert fn.nlls_instantiated(KernelModel(KERNEL_POLY, p))
    assert not fn.nlls_instantiated(KernelModel(KERNEL_POLY, 5))
    assert not fn.nlls_instantiated(None)
    # past the list, per-shape instances (none built here)
    from fabber_core_tpu_torch.ops import fused_vb as fv
    assert fv.nl_instantiated(KernelModel(KERNEL_EXP, 10), None, "nlls")
    assert fv.nl_instantiated(KernelModel(KERNEL_POLY, 5), None, "nlls")
    assert not fv.nl_instantiated(KernelModel(KERNEL_EXP, 44), None, "nlls")


def test_nlls_engine_on_card_matches_cpu(cuda):
    """The exp NLLS engine on the card (the kernel, phase 1 + resume:
    two launches) against the CPU engine (the plain version):
    tests/test_nlls_stats.py's kernel bounds; and past the prebuilt
    list (P = 10) the kernel route on a per-shape instance, past the JAX
    picker (P = 44) the generic route, neither raising."""
    from fabber_core_tpu_torch.inference.nlls import NLLSInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.options import RunOptions
    rng = np.random.default_rng(0)
    nv, nt = 3000, 40
    t = np.arange(nt) * 0.05
    data = (rng.uniform(0.6, 1.4, (nv, 1)) * np.exp(-t)[None]
            + rng.normal(0, 0.05, (nv, nt))).astype(np.float32)
    opts = RunOptions({"model": "exp", "dt": "0.05", "dtype": "single",
                       "nlls-phase1-iterations": "3"})
    res = {}
    for dev in (cuda, "cpu"):
        eng = NLLSInference(get_model_class("exp")(opts), opts, data,
                            device=dev)
        assert eng.route == "nlls-kernel"
        n0 = fn.fused_nlls_loop.launches
        res[str(dev)] = eng.run()
        assert fn.fused_nlls_loop.launches - n0 == (0 if dev == "cpu"
                                                    else 2)
    g, c = res[str(cuda)], res["cpu"]
    np.testing.assert_allclose(g.means, c.means, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(g.cov, c.cov, rtol=5e-3, atol=1e-5)
    diff = np.abs(g.iterations - c.iterations)
    assert diff.max() <= 30 and np.median(diff) <= 4
    np.testing.assert_array_equal(g.bad_voxels, c.bad_voxels)
    # past the prebuilt list a per-shape instance (P = 10); past the JAX
    # picker (P = 44) the generic route, no kernel
    for num, route in (("5", "nlls-kernel"), ("22", "nlls-generic")):
        opts = RunOptions({"model": "exp", "dt": "0.05", "dtype": "single",
                           "num-exps": num})
        eng = NLLSInference(get_model_class("exp")(opts), opts, data,
                            device=cuda)
        assert eng.route == route and eng.functor is None


def test_nlls_wrapper_refuses_what_no_kernel_takes(cuda):
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    c = nlls_inputs("exp", 64, cuda)
    with pytest.raises(TypeError):
        fn.fused_nlls_loop(c["model"], c["tr"], c["centre"].double(),
                           c["data"], c["tmask"], 5)
    with pytest.raises(ValueError, match="is on"):
        fn.fused_nlls_loop(c["model"], c["tr"], c["centre"],
                           c["data"].cpu(), c["tmask"], 5)
    with pytest.raises(ValueError, match="state"):
        fn.fused_nlls_loop(c["model"], c["tr"], c["centre"], c["data"],
                           c["tmask"], 5, state=torch.zeros(3, 64,
                                                            device=cuda))


# -- kernels 6 and 8 staged and streamed (csrc/tile.cuh) --------------------

def plan_edges(nq, widths=None):
    """For tile_plan at nq weights per sample (and its widths): the
    longest T of each VB it stages with and the T just past it (the last
    one streams)."""
    from fabber_core_tpu_torch.ops import _cuda
    widths = widths or (_cuda.TILE_VB,)
    edges, last = [], _cuda.tile_plan(1, nq, widths)[1]
    for nt in range(2, 4000):
        staged, vb, _ = _cuda.tile_plan(nt, nq, widths)
        if vb != last or not staged:
            edges += [nt - 1, nt]
            last = vb
        if not staged:
            return edges
    raise AssertionError("no T streams")


def expect_staged(nt, nq, vb=None, widths=None):
    from fabber_core_tpu_torch.ops import _cuda
    widths = widths or (_cuda.TILE_VB,)
    return 1 if _cuda.launch_vb(nt, nq, vb, widths) > 0 else 0


@pytest.mark.parametrize("marquardt", [False, True], ids=["L", "LM"])
def test_nlls_staged_bit_identical_to_streamed(cuda, marquardt):
    """Kernel 8 at V = 1,000,003: the fresh launch, phase 1 (3 steps)
    and the resumed launch from its state, in the plan's staged form
    (VB 32 at T=40), staged at VB 128 and 64, and streamed: every output
    of every form equal bit for bit."""
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    c = nlls_inputs("biexp", 1_000_003, cuda, seed=4)
    base = (c["centre"], c["data"], c["tmask"])
    outs = {}
    for vb in (None, 128, 64, 0):
        st = fn.fused_nlls_loop.staged_launches
        fresh = fn.fused_nlls_loop(c["model"], c["tr"], *base, 40,
                                   marquardt, _vb=vb)
        p1 = fn.fused_nlls_loop(c["model"], c["tr"], *base, 3, marquardt,
                                posterior=False, _vb=vb)
        res = fn.fused_nlls_loop(c["model"], c["tr"], p1[0], c["data"],
                                 c["tmask"], 37, marquardt, state=p1[1],
                                 _vb=vb)
        assert fn.fused_nlls_loop.staged_launches - st == (
            0 if vb == 0 else 3)
        outs[vb] = list(fresh) + list(p1) + list(res)
    for vb in (128, 64, 0):
        for a, b in zip(outs[None], outs[vb]):
            assert torch.equal(a.contiguous().view(torch.int32),
                               b.contiguous().view(torch.int32)), vb


@pytest.mark.parametrize("nt", plan_edges(1))
def test_nlls_plan_edges_match_plain(cuda, nt):
    """Kernel 8 (exp, Levenberg) at T on tile_plan's edges, the last
    too long for any tile (streamed): held to float64 as
    test_nlls_kernel_matches_plain, in the form the plan picks."""
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    c = nl_inputs("exp", 1, 2001, cuda, nt=nt, seed=5)
    c["tmask"] = c["q"].sum(axis=0)
    args = (c["centre"], c["data"], c["tmask"], 30, False)
    st = fn.fused_nlls_loop.staged_launches
    k = fn.fused_nlls_loop(c["model"], c["tr"], *args)
    assert fn.fused_nlls_loop.staged_launches - st == expect_staged(nt, 1)
    assert_nlls_near_f64(c, k, args)


@pytest.mark.parametrize("vb", [None, 128, 64, 0],
                         ids=["plan", "vb128", "vb64", "streamed"])
@pytest.mark.parametrize("name,nq", [("biexp", 1), ("exp", 4),
                                     ("poly3-F", 2)],
                         ids=["biexp-Q1", "exp-Q4", "poly3-F-Q2"])
def test_nl_loop_forms_match_plain(cuda, name, nq, vb):
    """Kernel 6 MODE 0 in each form on a ragged V, held to the plain
    version at float64 (assert_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    c = nl_inputs(name, nq, 1001, cuda)
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                               c["q"].sum(axis=1), 1e-8, 50.0, nq)
    args = (c["centre"], c["pm"], c["pp"], c["data"], c["q"], consts, 10,
            True)
    st = nl.fused_nl_loop.staged_launches
    k = nl.fused_nl_loop(c["model"], c["tr"], *args, _vb=vb)
    assert nl.fused_nl_loop.staged_launches - st == (0 if vb == 0 else 1)
    tsj = c["model"].time_signal_jac
    assert_near_f64(k, nl.fused_nl_loop_plain(tsj, c["tr"], *args),
                    nl.fused_nl_loop_plain(tsj, c["tr"], *to_f64(args)))


@pytest.mark.parametrize("kind", ["pointzeroone", "freduce", "trialmode",
                                  "lm"])
def test_nl_loop_detector_streamed_matches_plain(cuda, kind):
    """Kernel 6's detector modes (MODE 1, 2) in the streamed form, held
    as test_nl_loop_detector_kernel_matches_plain holds the plan's
    staged form."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    c = nl_inputs("exp", 2, 3001, cuda, seed=2)
    nt = c["data"].shape[0]
    det = nl_detector(kind, 2, nt, "exp")
    consts = nl.pack_nl_consts(np.full(2, 1e6), np.full(2, 1e-6),
                               c["q"].sum(axis=1), 1e-8, 50.0, 2)
    pd0 = torch.full_like(c["centre"], 0.5)
    args = (c["centre"], c["pm"], c["pp"], c["data"], c["q"], consts, 6,
            True)
    st = nl.fused_nl_loop.staged_launches
    k = nl.fused_nl_loop(c["model"], c["tr"], *args, detector=det,
                         post_var0=pd0, _vb=0)
    assert nl.fused_nl_loop.staged_launches == st
    tsj = c["model"].time_signal_jac
    r32 = nl.fused_nl_loop_plain(tsj, c["tr"], *args, detector=det,
                                 post_var0=pd0)
    r64 = nl.fused_nl_loop_plain(tsj, c["tr"], *to_f64(args), detector=det,
                                 post_var0=pd0.double())

    def dec(o):
        rev = o[5][1] if kind == "freduce" else torch.zeros_like(o[6][0])
        return decisions(o[6][0], rev)

    assert_detector_near_f64(k, r32, r64, dec(k), dec(r32), dec(r64))


@pytest.mark.parametrize("nq", [1, 4])
def test_nl_loop_plan_edges_match_plain(cuda, nq):
    """Kernel 6 (exp) at every T on tile_plan's edges for nq groups, the
    last streamed: each held to float64 (assert_near_f64), in the form
    the plan picks."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    for nt in plan_edges(nq):
        c = nl_inputs("exp", nq, 2001, cuda, nt=nt, seed=6)
        consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                                   c["q"].sum(axis=1), 1e-8, 50.0, nq)
        args = (c["centre"], c["pm"], c["pp"], c["data"], c["q"], consts,
                6, True)
        st = nl.fused_nl_loop.staged_launches
        k = nl.fused_nl_loop(c["model"], c["tr"], *args)
        assert nl.fused_nl_loop.staged_launches - st == expect_staged(nt,
                                                                      nq)
        tsj = c["model"].time_signal_jac
        assert_near_f64(k, nl.fused_nl_loop_plain(tsj, c["tr"], *args),
                        nl.fused_nl_loop_plain(tsj, c["tr"], *to_f64(args)))


@pytest.mark.parametrize("nq,nsupp", [(1, 0), (2, 2)],
                         ids=["Q1-NS0", "Q2-NS2"])
def test_generated_kernel_streamed_matches_plain(cuda, nq, nsupp):
    """6g in the streamed form, held as test_generated_kernel_matches_
    plain holds the plan's staged form (maxits)."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = generic_inputs(nq, nsupp, 100_003, cuda)
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                               c["q"].sum(axis=1), 1e-8, 50.0, nq)
    args = (c["centre"], c["pm"], c["pp"], c["data"], c["q"], consts, 10,
            True)
    st = nl.fused_nl_loop.staged_launches
    k = nl.fused_nl_loop(c["model"], c["tr"], *args, functor=c["tle"],
                         supp=c["supp"], _vb=0)
    assert nl.fused_nl_loop.staged_launches == st
    r32 = nl.fused_nl_loop_plain(
        None, c["tr"], *args,
        evaluator=fv.full_eval(c["tle"].fn, c["tr"], c["supp"]))
    s64 = None if c["supp"] is None else c["supp"].double()
    r64 = nl.fused_nl_loop_plain(
        None, c["tr"], *to_f64(args),
        evaluator=fv.full_eval(c["tle"].fn, c["tr"], s64))
    assert_near_f64(k, r32, r64)


def test_refused_tiles_raise(cuda):
    """A VB or a tile the C entry points refuse (VB not a multiple of 32
    or above 128, a tile above 232,448 bytes) raises in the wrapper and
    counts no launch; nothing falls back to the other form."""
    from fabber_core_tpu_torch.exceptions import FabberError
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    c = nl_inputs("exp", 1, 256, cuda, nt=500)
    consts = nl.pack_nl_consts([1e6], [1e-6], c["q"].sum(axis=1), 1e-8,
                               50.0, 1)
    g = generic_inputs(1, 0, 256, cuda)
    gconsts = nl.pack_nl_consts([1e6], [1e-6], g["q"].sum(axis=1), 1e-8,
                                50.0, 1)
    for vb in (48, 160, 128):     # 128: 4 (500 x 128 + 500) B > 232,448
        n_nl, n_nlls = nl.fused_nl_loop.launches, fn.fused_nlls_loop.launches
        with pytest.raises(FabberError, match="launch failed"):
            nl.fused_nl_loop(c["model"], c["tr"], c["centre"], c["pm"],
                             c["pp"], c["data"], c["q"], consts, 2, True,
                             _vb=vb)
        with pytest.raises(FabberError, match="launch failed"):
            fn.fused_nlls_loop(c["model"], c["tr"], c["centre"], c["data"],
                               c["q"].sum(axis=0), 5, _vb=vb)
        if vb != 128:
            with pytest.raises(FabberError, match="launch failed"):
                nl.fused_nl_loop(g["model"], g["tr"], g["centre"], g["pm"],
                                 g["pp"], g["data"], g["q"], gconsts, 2,
                                 True, functor=g["tle"], _vb=vb)
        assert nl.fused_nl_loop.launches == n_nl
        assert fn.fused_nlls_loop.launches == n_nlls


def test_occupancy_queries(cuda):
    """The plan keeps at least TILE_MIN_WARPS staged one-warp blocks per
    SM at T=100 and at its last staged T, for kernel 6 MODE 0-2 (biexp,
    Q=1), kernel 8 and a generated functor; refused arguments give
    -1."""
    from fabber_core_tpu_torch.ops import _cuda
    least = _cuda.TILE_MIN_WARPS
    for nt in (100, plan_edges(1)[-2]):
        staged, vb, _ = _cuda.tile_plan(nt, 1)
        assert staged and vb == 32
        for mode in (0, 1, 2):
            assert _cuda.nl_occupancy(1, 4, 1, mode, vb, nt) >= least
            assert _cuda.nlls_occupancy(1, 4, mode, False, vb, nt) >= least
        assert _cuda.nl_occupancy(1, 4, 1, 0, 0, nt) >= 2
    assert _cuda.nl_occupancy(1, 4, 1, 0, 48, 100) == -1
    assert _cuda.nlls_occupancy(1, 4, 0, False, 128, 500) == -1
    g = generic_inputs(1, 0, 64, cuda)
    assert _cuda.gen_occupancy(g["tle"].libs[("nl_loop", 1)], 0, 32,
                               100) >= least


# the longest T each block width takes within the 232,448-byte limit
LARGEST_TILES = [(450, 128), (894, 64), (1760, 32)]


@pytest.mark.parametrize("nt,vb", LARGEST_TILES,
                         ids=[f"T{nt}-vb{vb}" for nt, vb in LARGEST_TILES])
def test_largest_tiles_match_plain(cuda, nt, vb):
    """Kernels 6 and 8 (exp, Q=1) forced to stage the largest tile each
    VB takes (above 48 KB: the shared-memory opt-in), held to float64 as
    test_nl_loop_kernel_matches_plain and test_nlls_kernel_matches_plain
    hold the plan's forms."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    c = nl_inputs("exp", 1, 1501, cuda, nt=nt, seed=7)
    consts = nl.pack_nl_consts([1e6], [1e-6], c["q"].sum(axis=1), 1e-8,
                               50.0, 1)
    args = (c["centre"], c["pm"], c["pp"], c["data"], c["q"], consts, 6,
            True)
    st = nl.fused_nl_loop.staged_launches
    k = nl.fused_nl_loop(c["model"], c["tr"], *args, _vb=vb)
    assert nl.fused_nl_loop.staged_launches == st + 1
    tsj = c["model"].time_signal_jac
    assert_near_f64(k, nl.fused_nl_loop_plain(tsj, c["tr"], *args),
                    nl.fused_nl_loop_plain(tsj, c["tr"], *to_f64(args)))
    c["tmask"] = c["q"].sum(axis=0)
    nargs = (c["centre"], c["data"], c["tmask"], 30, False)
    k = fn.fused_nlls_loop(c["model"], c["tr"], *nargs, _vb=vb)
    assert_nlls_near_f64(c, k, nargs)


# -- kernels 7 and 4 staged and streamed (csrc/tile.cuh) --------------------

def bits_equal(outs_a, outs_b):
    return all(torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
               for a, b in zip(outs_a, outs_b))


@pytest.mark.parametrize("lm", [False, True], ids=["plain", "LM"])
def test_vb_iter_staged_bit_identical_to_streamed(cuda, lm):
    """Kernel 7 (biexp, Q=1) at V = 1,000,003, T=40, one iteration with
    F, with and without its LM branch (alpha 0 in a quarter of the
    lanes): the plan's staged form (VB 32), staged at VB 128 and 64, and
    streamed, every output equal bit for bit."""
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = nl_inputs("biexp", 1, 1_000_003, cuda, seed=4)
    alpha = None
    if lm:
        alpha = 10.0 ** (torch.rand(1_000_003, device=cuda) * 8 - 6)
        alpha[::4] = 0.0
    args = (c["centre"], c["pm"], c["pp"], c["phi"], c["data"], c["q"], True,
            alpha)
    outs = {}
    for vb in (None, 128, 64, 0):
        st = fv.fused_iteration.staged_launches
        outs[vb] = fv.fused_iteration(c["model"], c["tr"], *args, _vb=vb)
        assert fv.fused_iteration.staged_launches - st == (
            0 if vb == 0 else 1)
    for vb in (128, 64, 0):
        assert bits_equal(outs[None], outs[vb]), vb


@pytest.mark.parametrize("vb", [None, 0], ids=["plan", "streamed"])
@pytest.mark.parametrize("name,nq", [("biexp", 1), ("exp", 4),
                                     ("poly3-F", 2)],
                         ids=["biexp-Q1", "exp-Q4", "poly3-F-Q2"])
def test_vb_iter_forms_match_plain(cuda, name, nq, vb):
    """Kernel 7 in each form on a ragged V, held to the plain version at
    float64 (assert_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = nl_inputs(name, nq, 3001, cuda, seed=3)
    args = (c["centre"], c["pm"], c["pp"], c["phi"], c["data"], c["q"], True)
    st = fv.fused_iteration.staged_launches
    k = fv.fused_iteration(c["model"], c["tr"], *args, _vb=vb)
    assert fv.fused_iteration.staged_launches - st == (0 if vb == 0 else 1)
    tsj = c["model"].time_signal_jac
    assert_near_f64(k, fv.fused_iteration_plain(tsj, c["tr"], *args),
                    fv.fused_iteration_plain(tsj, c["tr"], *to_f64(args)))


WHOLE_FORM_CASES = [(kind, nq) for kind in (None, "pointzeroone",
                                            "trialmode", "lm")
                    for nq in (1, 2, 3)]


@pytest.mark.parametrize("kind,nq", WHOLE_FORM_CASES,
                         ids=[f"{k or 'maxits'}-Q{q}"
                              for k, q in WHOLE_FORM_CASES])
def test_whole_staged_bit_identical_to_streamed(cuda, kind, nq):
    """Kernel 4 (P=3) at V = 200,003, T=106, in MODE 0 (maxits), 1
    (pointzeroone) and 2 (trialmode, lm): the plan's staged form (VB
    32), staged at VB 128 and 64, and streamed, every output equal bit
    for bit."""
    from fabber_core_tpu_torch.ops import fused_whole as fw
    args = whole_inputs(3, nq, 200_003, cuda, nt=106, seed=5)
    det, cap = (None, 10) if kind is None else whole_detector(kind, 3, nq,
                                                              nt=106)
    outs = {}
    for vb in (None, 128, 64, 0):
        st = fw.fused_whole.staged_launches
        outs[vb] = fw.fused_whole(*args, cap, -1.0, det, _vb=vb)
        assert fw.fused_whole.staged_launches - st == (0 if vb == 0 else 1)
    for vb in (128, 64, 0):
        assert bits_equal(outs[None], outs[vb]), vb


@pytest.mark.parametrize("kind", [None, "trialmode", "lm"])
def test_whole_streamed_matches_plain(cuda, kind):
    """Kernel 4 (P=3, Q=2) in the streamed form, held as
    test_whole_kernel_matches_plain and test_whole_kernel_detector_
    matches_plain hold the plan's staged form."""
    from fabber_core_tpu_torch.ops import fused_whole as fw
    args = whole_inputs(3, 2, 20_001, cuda, seed=6)
    det, cap = (None, 10) if kind is None else whole_detector(kind, 3, 2)
    st = fw.fused_whole.staged_launches
    k = fw.fused_whole(*args, cap, -1.0, det, _vb=0)
    assert fw.fused_whole.staged_launches == st
    r32 = fw.fused_whole_plain(*args, cap, -1.0, det)
    r64 = fw.fused_whole_plain(*to_f64(args), cap, -1.0, det)
    if kind is None:
        assert_near_f64(k, r32, r64)
    else:
        def dec(o):
            return decisions(o[6][0], torch.zeros_like(o[6][0]))
        assert_detector_near_f64(k, r32, r64, dec(k), dec(r32), dec(r64))


@pytest.mark.parametrize("p,nq", [(1, 1), (4, 3)], ids=["P1-Q1", "P4-Q3"])
def test_whole_plan_edges_match_plain(cuda, p, nq):
    """Kernel 4 (maxits) at every T on tile_plan's edges for its P + QP
    + Q design rows per sample, the last streamed: each held to float64
    (assert_near_f64), in the form the plan picks."""
    from fabber_core_tpu_torch.ops import fused_whole as fw
    nw = fw.tile_weights(p, nq)
    for nt in plan_edges(nw):
        args = whole_inputs(p, nq, 2001, cuda, nt=nt, seed=7)
        st = fw.fused_whole.staged_launches
        k = fw.fused_whole(*args, 10)
        assert fw.fused_whole.staged_launches - st == expect_staged(nt, nw)
        assert_near_f64(k, fw.fused_whole_plain(*args, 10),
                        fw.fused_whole_plain(*to_f64(args), 10))


def test_refused_tiles_raise_kernels_7_and_4(cuda):
    """Kernels 7 and 4 refuse a VB not a multiple of 32 or above 128 and
    a tile above 232,448 bytes: the wrapper raises and counts no launch,
    nothing falls back to the other form."""
    from fabber_core_tpu_torch.exceptions import FabberError
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import fused_whole as fw
    c = nl_inputs("exp", 1, 256, cuda, nt=500)
    it_args = (c["centre"], c["pm"], c["pp"], c["phi"], c["data"], c["q"],
               True)
    w_args = whole_inputs(3, 2, 256, cuda, nt=500)
    for vb in (48, 160, 128):     # 128: 4 (500 x 128 + 500) B > 232,448
        n7, n4 = fv.fused_iteration.launches, fw.fused_whole.launches
        with pytest.raises(FabberError, match="launch failed"):
            fv.fused_iteration(c["model"], c["tr"], *it_args, _vb=vb)
        with pytest.raises(FabberError, match="launch failed"):
            fw.fused_whole(*w_args, 10, _vb=vb)
        assert fv.fused_iteration.launches == n7
        assert fw.fused_whole.launches == n4


def test_occupancy_queries_kernels_7_and_4(cuda):
    """The plan keeps at least TILE_MIN_WARPS staged one-warp blocks per
    SM for kernel 7 (biexp, Q=1, T=100, with and without LM) and kernel
    4 (P=3, Q=1, 2, T=106, MODE 0-2); refused arguments give -1."""
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_whole as fw
    least = _cuda.TILE_MIN_WARPS
    staged, vb, _ = _cuda.tile_plan(100, 1)
    assert staged and vb == 32
    for lm in (False, True):
        assert _cuda.vb_iter_occupancy(1, 4, 1, lm, vb, 100) >= least
        assert _cuda.vb_iter_occupancy(1, 4, 1, lm, 0, 100) >= 2
    for nq in (1, 2):
        staged, vb, _ = _cuda.tile_plan(106, fw.tile_weights(3, nq))
        assert staged and vb == 32
        for mode in (0, 1, 2):
            assert _cuda.whole_occupancy(3, nq, mode, vb, 106) >= least
            assert _cuda.whole_occupancy(3, nq, mode, 0, 106) >= 1
    assert _cuda.vb_iter_occupancy(1, 4, 1, False, 48, 100) == -1
    assert _cuda.whole_occupancy(3, 2, 0, 128, 500) == -1
    assert _cuda.whole_occupancy(3, 2, 3, 32, 106) == -1


# -- kernel 1's staged tile (spectral_stats.cu, csrc/tile.cuh) -----------------

def stats_inputs(p, nt, nv, cuda, seed=0, masked=True, offset=0):
    """Kernel 1's inputs: data [T,V] of design(p, nt) at random truths
    plus unit noise, made on the card (offset floats into its buffer:
    1 leaves the plane's rows 4 bytes off 16-byte alignment), and its
    constants (two samples masked)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed + 100 * p + nt)
    d = design(p, nt)
    q = np.ones(nt)
    if masked:
        q[[1, nt // 3]] = 0.0
    truth = torch.rand((p, nv), generator=gen, device=cuda) * 4 - 2
    buf = torch.empty(nt * nv + offset, device=cuda)
    data = buf[offset:].view(nt, nv)
    torch.matmul(torch.as_tensor(d, dtype=torch.float32, device=cuda),
                 truth, out=data)
    data += torch.randn((nt, nv), generator=gen, device=cuda)
    return (data, fs.pack_mxu_consts(d, q, nt, torch.float32, cuda),
            fs.pack_solve_consts(d, q, nt, torch.float32))


STATS_FORM_CASES = [(1_000_003, 0), (1_048_576, 0), (1_048_576, 1),
                    (1_000_002, 3), (1_000_001, 2)]


@pytest.mark.parametrize("nv,offset", STATS_FORM_CASES,
                         ids=["ragged", "aligned", "misaligned",
                              "ragged2-off3", "ragged1-off2"])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_stats_staged_bit_identical_to_streamed(cuda, p, nv, offset):
    """Kernel 1 at T=106, its tile copied in 16-byte chunks with each
    row rotated by its offset from 16-byte alignment (0 throughout for
    the aligned plane; V mod 4 of 3, 2 and 1 and planes 1-3 floats into
    their buffers turn every offset up): the plan's staged form (VB 128),
    staged at VB 32, 64, 96, 160 and 256, and streamed, every output equal
    bit for bit."""
    args = stats_inputs(p, 106, nv, cuda, seed=1, offset=offset)
    outs = {}
    for vb in (None, 32, 64, 96, 160, 256, 0):
        st = fs.spectral_stats.staged_launches
        outs[vb] = fs.spectral_stats(*args, _vb=vb)
        assert fs.spectral_stats.staged_launches - st == (0 if vb == 0
                                                          else 1)
    for vb in (32, 64, 96, 160, 256, 0):
        assert bits_equal(outs[None], outs[vb]), vb


@pytest.mark.parametrize("p", [1, 3, 8])
def test_stats_plan_edges_match_plain(cuda, p):
    """Kernel 1 at every T on tile_plan's edges for its 2P + 1 design
    rows per sample and its widths (STATS_WIDTHS), the last streamed, in
    the form the plan picks: the bounds of
    test_kernels_match_plain_every_p, and the staged form at 32 lanes
    equal to the streamed one bit for bit."""
    from fabber_core_tpu_torch.ops import _cuda
    nq, widths = 2 * p + 1, _cuda.STATS_WIDTHS
    for nt in plan_edges(nq, widths):
        args = stats_inputs(p, nt, 4000, cuda, seed=2)
        st = fs.spectral_stats.staged_launches
        ks = fs.spectral_stats(*args)
        assert fs.spectral_stats.staged_launches - st == expect_staged(
            nt, nq, None, widths)
        ps = fs.spectral_stats_plain(*args)
        a = args[2].reshape(p, p).to(cuda).double()
        assert rel(ks[0], ps[0]) <= 1e-3
        assert rel(ks[1], ps[1]) <= 1e-4
        assert rel(ks[2].double() + a @ ks[0].double(),
                   ps[2].double() + a @ ps[0].double()) <= 1e-5
        assert bits_equal(fs.spectral_stats(*args, _vb=0),
                          fs.spectral_stats(*args, _vb=32))


def test_stats_refused_tiles_raise(cuda):
    """Kernel 1 refuses a VB not a multiple of 32 or above 256 and a
    tile above 232,448 bytes: the wrapper raises and counts no launch,
    nothing falls back to the other form."""
    from fabber_core_tpu_torch.exceptions import FabberError
    args = stats_inputs(3, 500, 256, cuda)
    for vb in (48, 288, 128):     # 128: 4 (500 x 128 + 7 x 500) B > 232,448
        n = fs.spectral_stats.launches
        with pytest.raises(FabberError, match="launch failed"):
            fs.spectral_stats(*args, _vb=vb)
        assert fs.spectral_stats.launches == n


def test_stats_occupancy_queries(cuda):
    """The plan keeps at least TILE_MIN_WARPS warps of kernel 1 per SM
    at T=106 (P = 1, 3, 8) in blocks of 128 lanes; refused arguments
    give -1."""
    from fabber_core_tpu_torch.ops import _cuda
    for p in (1, 3, 8):
        staged, vb, _ = _cuda.tile_plan(106, 2 * p + 1, _cuda.STATS_WIDTHS)
        assert staged and vb == 128
        assert _cuda.stats_occupancy(p, vb, 106) * 4 >= _cuda.TILE_MIN_WARPS
        assert _cuda.stats_occupancy(p, 0, 106) >= 1
    assert _cuda.stats_occupancy(3, 48, 106) == -1
    assert _cuda.stats_occupancy(3, 128, 500) == -1
    assert _cuda.stats_occupancy(26, 32, 106) == -1
    assert _cuda.stats_occupancy(9, 128, 106) * 4 >= _cuda.TILE_MIN_WARPS


# -- the AR(1) whole-loop kernel (fused_ar_loop.cu, kernel 9) ------------------

AR_INSTANCES = [(p, nq) for p in (1, 2, 3, 4) for nq in (1, 2)]
AR_IDS = [f"P{p}-Q{nq}" for p, nq in AR_INSTANCES]


def ar_inputs(p, nq, nv, device, seed=0, cosine=False):
    """Kernel 9's inputs: the plain statistics (float32, on the card) of
    a poly design scaled to [0, 1] (cosine: design(p, nt), where powers
    of t past degree 4 are beyond float32) and AR(1) data (alpha 0.4 per
    echo, noise sd log-uniform over 1e-2..1 per voxel), the constants of
    the model-default noise, weak priors around random means."""
    from fabber_core_tpu_torch.noise.ar1 import Ar1NoiseModel
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    from fabber_core_tpu_torch.options import RunOptions
    rng = np.random.default_rng(seed + 10 * p + nq)
    nt = 30 * nq
    d = design(p, nt) if cosine else \
        (np.arange(1, nt + 1.0)[:, None] / nt) ** np.arange(p)[None]
    e = rng.standard_normal((nt, nv))
    for k in range(nq, nt):
        e[k] += 0.4 * e[k - nq]
    y = d @ rng.uniform(-1, 1, (p, nv)) + 10.0 ** rng.uniform(-2, 0, nv) * e
    nm = Ar1NoiseModel(RunOptions({"num-echoes": str(nq)}), nt)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=device)
    st = nm.make_design_stats(dev(d), dev(y))
    prior, post = nm.initial_state(1, torch.float32)
    consts = fa.pack_ar_consts(
        st.dmd, prior.alpha_prec, prior.b, prior.c, nm.ntimes,
        post.b[:, 0], post.c[:, 0],
        [post.alpha_cov[n, n, 0] for n in range(nq)],
        [post.alpha_prec[n, n, 0] for n in range(nq)], nq)
    return (st.m0.contiguous(), st.rmr.contiguous(), st.dmr.contiguous(),
            consts, dev(rng.uniform(-0.5, 0.5, (p, nv))),
            dev(np.full((p, nv), 1e-6))), nm


def ar_detector(kind, p, nq, ntimes):
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    f_const, lb = fa.ar_elbo_consts(p, nq, float(ntimes), 1e6, 1e-6)
    return {"det": detector(kind), "f_const": f_const, "lb_coeff": lb}


@pytest.mark.parametrize("p,nq", AR_INSTANCES, ids=AR_IDS)
def test_ar_kernel_matches_plain(cuda, p, nq):
    """Every (P, nq) instance of kernel 9 in maxits, 10 iterations,
    ragged voxel count, held to the plain version at float64
    (assert_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    args, _ = ar_inputs(p, nq, 20_001, cuda)
    before = fa.fused_ar_loop.launches
    k = fa.fused_ar_loop(*args, 10)
    assert fa.fused_ar_loop.launches == before + 1
    assert_near_f64(k, fa.fused_ar_loop_plain(*args, 10),
                    fa.fused_ar_loop_plain(*to_f64(args), 10))


@pytest.mark.parametrize("kind", ["pointzeroone", "freduce"])
@pytest.mark.parametrize("p,nq", AR_INSTANCES, ids=AR_IDS)
def test_ar_kernel_detector_matches_plain(cuda, p, nq, kind):
    """Every (P, nq) instance of kernel 9's detector mode at the engine's
    loop cap, held to the plain version at float64 by decision share
    (iteration count, engine-initial tag; assert_detector_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    args, nm = ar_inputs(p, nq, 20_001, cuda, seed=1)
    det = ar_detector(kind, p, nq, nm.ntimes)
    cap = int(det["det"].max_iterations) + 2
    before = (fa.fused_ar_loop.launches, fa.fused_ar_loop.det_launches)
    k = fa.fused_ar_loop(*args, cap, det)
    assert (fa.fused_ar_loop.launches, fa.fused_ar_loop.det_launches) == \
        (before[0] + 1, before[1] + 1)
    r32 = fa.fused_ar_loop_plain(*args, cap, det)
    r64 = fa.fused_ar_loop_plain(*to_f64(args), cap, det)

    def dec(o):
        return decisions(o[9][0], o[6][0] < 0)

    def tidy(o):
        return o[:6] + (o[6].abs(),) + o[7:]

    assert_detector_near_f64(tidy(k), tidy(r32), tidy(r64), dec(k),
                             dec(r32), dec(r64))


def test_ar_instances_are_the_listed_ones(cuda):
    """The library's instance query answers from the one list,
    csrc/fused_ar_loop.cu FABBER_AR_INSTANCES; the route gate's adds the
    per-shape instances (P 9-16), decided without a build."""
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops.fused_loop_ar import ar_instantiated
    for p in range(1, 9):
        assert _cuda.has_ar_instance(p, 1) and _cuda.has_ar_instance(p, 2)
        assert not ar_instantiated(p, 3)
    assert not _cuda.has_ar_instance(9, 1)
    assert ar_instantiated(9, 1) and ar_instantiated(16, 2)
    assert not ar_instantiated(17, 1)


def test_engine_on_card_refuses_ar_runs_without_an_instance(cuda,
                                                            tmp_path):
    """AR(1) noise at P > 4 on kernel 9 (its instances since P <= 4
    raised here): linear P = 5 at one echo and P = 8 at two, each
    launched once (its P > 4 instance) and held to the CPU's float64
    run by assert_run_near_f64 (the alpha means absolutely)."""
    for p, nq in ((5, 1), (8, 2)):
        g, eng, launched, c32, c64 = wide_linear_runs(
            cuda, tmp_path, p, {"num-echoes": str(nq)}, nq=nq, ar=True,
            nt=60)
        assert eng.route == "pallas-loop-ar" and launched[2] == 1
        assert_run_near_f64(g, c32, c64, na=2)


@pytest.mark.parametrize("p,extra", [
    (3, {"noise-pattern": "1234"}), (9, {"noise-pattern": "12"}),
    (6, {"noise-pattern": "123"})],
    ids=["pattern-1234", "P9", "P6-pattern-123"])
def test_fixed_design_on_card_refuses_shapes_without_an_instance(
        cuda, tmp_path, p, extra):
    """Where kernels 4 and 5 have no prebuilt (P, Q) instance (Q = 4;
    P = 9; Q = 3 past P = 5) the card builds the per-shape one at the
    route's first launch and runs kernel 4 there, as the JAX engine runs
    its kernel: 'pallas-whole', one launch, a per-shape one, held to the
    CPU's float64 run by assert_run_near_f64."""
    from fabber_core_tpu_torch.ops import fused_whole as fw
    nq = len(extra["noise-pattern"])
    before = fw.fused_whole.instance_launches
    g, eng, launched, c32, c64 = wide_linear_runs(cuda, tmp_path, p, extra,
                                                  nq=nq)
    assert eng.route == "pallas-whole" and launched == [1, 0, 0]
    assert fw.fused_whole.instance_launches == before + 1
    assert_run_near_f64(g, c32, c64)


@pytest.mark.parametrize("extra", [
    {}, {"num-echoes": "2"}, {"convergence": "pointzeroone"},
    {"convergence": "freduce", "num-echoes": "2"}],
    ids=["maxits", "maxits-echoes2", "pointzeroone", "freduce-echoes2"])
def test_ar_engine_on_card_matches_cpu(cuda, extra, monkeypatch):
    """pallas-loop-ar on the card (kernel 9, launched once) against the
    CPU engine (its plain version): iteration counts at most 1 apart on
    < 2% of lanes, the other lanes' means within 5e-3 posterior sd, std
    and noise rtol 2e-3 per voxel (alpha means: atol 5e-4). On the card
    the plain version is replaced by one that raises."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    from fabber_core_tpu_torch.options import RunOptions
    rng = np.random.default_rng(0)
    nv, nt = 3000, 30
    t = np.arange(1, nt + 1)
    e = rng.standard_normal((nv, nt))
    for k in range(1, nt):
        e[:, k] += 0.4 * e[:, k - 1]
    data = (rng.uniform(-1, 1, (nv, 1)) + rng.uniform(-.05, .05, (nv, 1)) * t
            + 0.1 * e).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        if dev != "cpu":
            def refuse(*a, **k):
                raise AssertionError("a plain version ran on the card")
            monkeypatch.setattr(fa, "fused_ar_loop_plain", refuse)
        opts = RunOptions({"model": "poly", "degree": "1", "noise": "ar",
                           "dtype": "single", "print-free-energy": True,
                           "max-iterations": "10", **extra})
        eng = VBInference(get_model_class("poly")(opts), opts, data,
                          device=dev)
        assert eng.route == "pallas-loop-ar"
        n0 = fa.fused_ar_loop.launches
        res[str(dev)] = eng.run()
        assert fa.fused_ar_loop.launches - n0 == (0 if dev == "cpu" else 1)
    g, c = res[str(cuda)], res["cpu"]
    diff = np.abs(g.iterations - c.iterations)
    assert diff.max() <= 1 and (diff != 0).mean() < 0.02
    ok = diff == 0
    sdp = np.sqrt(np.diagonal(c.cov[ok], axis1=1, axis2=2))
    assert np.max(np.abs(g.means[ok] - c.means[ok]) / sdp) < 5e-3
    np.testing.assert_allclose(
        np.sqrt(np.diagonal(g.cov[ok], axis1=1, axis2=2)), sdp, rtol=2e-3)
    a = 2   # the noise block: the two alphas, then the phis
    np.testing.assert_allclose(g.noise_means[ok][:, :a],
                               c.noise_means[ok][:, :a], atol=5e-4)
    np.testing.assert_allclose(g.noise_means[ok][:, a:],
                               c.noise_means[ok][:, a:], rtol=2e-3)
    np.testing.assert_array_equal(g.bad_voxels, c.bad_voxels)


# -- the whole-loop kernel's generic mode (kernel 6g: a functor generated
#    from a model's evaluate, ops/_cuda.py build_generated) ------------------

def generic_inputs(nq, nsupp, nv, device, seed=0, nt=30):
    """The GaussianAct (nsupp 0) or SuppScaled (nsupp 2) twin's inputs
    from one numpy seed: data = model(truth) + N(0, 0.02^2) (truths
    within 0.2 of the prior means), the centre 0.05 off the truth, the
    models' priors N(default, 10), nq groups alternating in time, one
    sample masked, suppdata scale 0.8..1.2 and offset +-0.1."""
    from fabber_core_tpu_torch.models.kernelgen import \
        derive_time_local_eval
    from torch_generic_models import GaussianAct, SuppScaled
    model = SuppScaled() if nsupp else GaussianAct()
    tle = derive_time_local_eval(model, nt, 4, nsupp)
    if torch.device(device).type == "cuda":
        from fabber_core_tpu_torch.ops import _cuda
        tle.libs[("nl_loop", nq)] = _cuda.build_generated(tle.source, 4, nq)
    rng = np.random.default_rng(seed)
    truth = np.array([0.0, 1.0, 1.2, 0.6])
    mt = truth[:, None] + rng.uniform(-0.2, 0.2, (4, nv)) \
        * np.array([1, 1, 0.5, 0.3])[:, None]
    supp = np.stack([rng.uniform(0.8, 1.2, nv),
                     rng.uniform(-0.1, 0.1, nv)]) if nsupp else None
    t = np.arange(nt)[:, None] * 0.1
    z = (t - mt[2]) / mt[3]
    sig = mt[0] + mt[1] * np.exp(-0.5 * z * z)
    if nsupp:
        sig = supp[0] * sig + supp[1]
    q = np.zeros((nq, nt))
    q[np.arange(nt) % nq, np.arange(nt)] = 1.0
    q[:, 4] = 0.0

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=device)

    from fabber_core_tpu_torch.core.transforms import TRANSFORM_IDENTITY
    return dict(
        model=model, tle=tle, tr=[TRANSFORM_IDENTITY] * 4, q=q, nq=nq,
        data=dev(sig + 0.02 * rng.standard_normal((nt, nv))),
        centre=dev(mt + 0.05 * rng.standard_normal((4, nv))),
        pm=dev(np.repeat(truth[:, None], nv, 1)),
        pp=dev(np.full((4, nv), 0.1)),
        supp=None if supp is None else dev(supp),
        pd0=dev(rng.uniform(0.5, 2.0, (4, nv))))


def generic_detector(kind, nq, nsupp, nt=30):
    if kind == "maxits":
        return None
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.options import RunOptions
    from torch_generic_models import GaussianAct, SuppScaled
    opts = RunOptions({"model": "gaussact-test", "noise": "white",
                       "dtype": "single", "convergence": kind,
                       "max-iterations": "10", "max-trials": "3",
                       "noise-pattern": "12"[:nq]})
    model = SuppScaled() if nsupp else GaussianAct()
    eng = VBInference(model, opts, np.ones((4, nt), np.float32),
                      device="cpu",
                      suppdata=np.ones((4, 2)) if nsupp else None)
    return eng._nl_fdet_consts()


@pytest.mark.parametrize("kind,nv", [
    ("maxits", 1024), ("maxits", 1_000_003), ("pointzeroone", 100_003),
    ("freduce", 100_003), ("trialmode", 100_003), ("lm", 100_003)])
@pytest.mark.parametrize("nq,nsupp", [(1, 0), (2, 2)],
                         ids=["Q1-NS0", "Q2-NS2"])
def test_generated_kernel_matches_plain(cuda, nq, nsupp, kind, nv):
    """6g: the whole-loop kernel with the functor generated from
    GaussianAct's (SuppScaled's) evaluate, 10 iterations with F, held to
    the generic plain version at float64: maxits by assert_near_f64,
    the detector modes by assert_detector_near_f64."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = generic_inputs(nq, nsupp, nv, cuda)
    det = generic_detector(kind, nq, nsupp)
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                               c["q"].sum(axis=1), 1e-8, 50.0, nq)
    args = (c["centre"], c["pm"], c["pp"], c["data"], c["q"], consts, 10,
            True)
    kw = dict(detector=det, post_var0=c["pd0"], functor=c["tle"],
              supp=c["supp"])
    before = nl.fused_nl_loop.generic_launches
    k = nl.fused_nl_loop(c["model"], c["tr"], *args, **kw)
    assert nl.fused_nl_loop.generic_launches == before + 1
    r32 = nl.fused_nl_loop_plain(
        None, c["tr"], *args, detector=det, post_var0=c["pd0"],
        evaluator=fv.full_eval(c["tle"].fn, c["tr"], c["supp"]))
    s64 = None if c["supp"] is None else c["supp"].double()
    r64 = nl.fused_nl_loop_plain(
        None, c["tr"], *to_f64(args), detector=det,
        post_var0=c["pd0"].double(),
        evaluator=fv.full_eval(c["tle"].fn, c["tr"], s64))
    if kind == "maxits":
        assert_near_f64(k, r32, r64)
        return

    def dec(o):
        rev = o[5][1] if kind == "freduce" else torch.zeros_like(o[6][0])
        return decisions(o[6][0], rev)

    assert_detector_near_f64(k, r32, r64, dec(k), dec(r32), dec(r64))


def test_generated_build_failure_raises(cuda):
    from fabber_core_tpu_torch.exceptions import FabberError
    from fabber_core_tpu_torch.ops import _cuda
    with pytest.raises(FabberError, match="nvcc failed"):
        _cuda.build_generated("struct GenModel { this is no C++ };", 2, 1)


def test_generated_kernel_not_built_raises(cuda):
    """The wrapper only launches: a functor with no library built at the
    run's Q raises rather than build on the launch path."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    c = generic_inputs(1, 0, 256, cuda)
    c["tle"].libs.clear()
    consts = nl.pack_nl_consts([1e6], [1e-6], c["q"].sum(axis=1), 1e-8,
                               50.0, 1)
    before = nl.fused_nl_loop.launches
    with pytest.raises(ValueError, match="no kernel built"):
        nl.fused_nl_loop(c["model"], c["tr"], c["centre"], c["pm"], c["pp"],
                         c["data"], c["q"], consts, 2, True,
                         functor=c["tle"])
    assert nl.fused_nl_loop.launches == before


def test_generic_engine_on_card_matches_cpu(cuda):
    """GaussianAct through the engine on the card (the generated
    functor) against the CPU engine (the generic plain version):
    tests/test_fused_loop_generic.py's tolerances."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.options import RunOptions
    from torch_generic_models import GaussianAct
    c = generic_inputs(1, 0, 2048, "cpu", seed=4)
    data = c["data"].t().numpy()
    opts = RunOptions({"model": "gaussact-test", "noise": "white",
                       "dtype": "single", "max-iterations": "10",
                       "save-free-energy": True})
    rc = VBInference(GaussianAct(), opts, data, device="cpu").run()
    eng = VBInference(GaussianAct(), opts, data, device=cuda)
    assert eng.route == "pallas-loop-nl" and eng.generic is not None
    before = nl.fused_nl_loop.generic_launches
    rk = eng.run()
    assert nl.fused_nl_loop.generic_launches == before + 1
    sd = np.sqrt(np.diagonal(rc.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rk.means - rc.means) / sd) < 5e-3
    np.testing.assert_allclose(rk.noise_means, rc.noise_means, rtol=2e-3)
    np.testing.assert_allclose(rk.free_energy, rc.free_energy, rtol=1e-4,
                               atol=2e-3)


def test_rejected_model_takes_generic_route_on_card(cuda):
    """A model the probe refuses runs plain torch on xla-generic, a
    route chosen at construction: nothing is built or launched."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.options import RunOptions
    from torch_generic_models import DataUsing
    opts = RunOptions({"model": "datause-test", "noise": "white",
                       "dtype": "single", "max-iterations": "3"})
    n = len(_cuda._gen_libs)
    eng = VBInference(DataUsing(), opts, np.ones((64, 30), np.float32),
                      device=cuda)
    assert eng.route == "xla-generic" and eng.generic is None
    assert len(_cuda._gen_libs) == n
    assert np.isfinite(eng.run().means).all()


def multiexp_data(num, nv=2000, nt=40, seed=0):
    """A sum of num exponentials (amplitudes 1.5, 1, 0.75, 0.5 and rates
    0.3, 1.5, 6, 0.1 per second, each x U(0.8, 1.2) per voxel), dt 0.05,
    noise sd 0.02, float32 [V,T]."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * 0.05
    amps, rates = (1.5, 1.0, 0.75, 0.5), (0.3, 1.5, 6.0, 0.1)
    sig = sum(a * rng.uniform(0.8, 1.2, (nv, 1))
              * np.exp(-r * rng.uniform(0.8, 1.2, (nv, 1)) * t[None])
              for a, r in zip(amps[:num], rates[:num]))
    return (sig + rng.normal(0, 0.02, (nv, nt))).astype(np.float32)


def multiexp_vb_on_card(cuda, model, num, extra, route):
    """VB on the card and on the CPU (float32, 2 iterations from the
    model's start: a sum of exponentials is chaotic at float32 over
    more, ROADMAP Queue 3 item 7): (card engine, its launches of
    kernels 6 and 7, card run, CPU run)."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.options import RunOptions
    data = multiexp_data(num)
    opts = RunOptions({"model": model, "num-exps": str(num), "dt": "0.05",
                       "noise": "white", "dtype": "single",
                       "max-iterations": "2", **extra})
    res = {}
    for dev in (cuda, "cpu"):
        eng = VBInference(get_model_class(model)(opts), opts, data,
                          device=dev)
        assert eng.route == route
        before = nl.fused_nl_loop.launches + fv.fused_iteration.launches
        res[str(dev)] = eng.run()
        wide = nl.fused_nl_loop.launches + fv.fused_iteration.launches \
            - before
        if dev != "cpu":
            card, launched = eng, wide
    return card, launched, res[str(cuda)], res["cpu"]


def assert_runs_close(g, c, frac=0.99):
    """The card's run against the CPU's on the same route: iteration
    counts and bad voxels equal; means within 5e-3 posterior sd and noise
    within 2e-3 relative in >= frac of the voxels."""
    np.testing.assert_array_equal(g.iterations, c.iterations)
    np.testing.assert_array_equal(g.bad_voxels, c.bad_voxels)
    sd = np.sqrt(np.diagonal(c.cov, axis1=1, axis2=2))
    e = np.max(np.abs(g.means - c.means) / sd, axis=1)
    n = np.max(np.abs(g.noise_means / c.noise_means - 1), axis=1)
    assert ((e < 5e-3) & (n < 2e-3)).mean() >= frac


@pytest.mark.parametrize("num", [3, 4])
@pytest.mark.parametrize("extra,route", [
    ({}, "pallas-loop-nl"), ({"engine-kernel": "pallas"}, "pallas")],
    ids=["pallas-loop-nl", "pallas"])
def test_multiexp_vb_on_card_runs_expsum(cuda, num, extra, route):
    """exp at num-exps 3 and 4 (P = 6, 8) on the card runs its
    hand-written ExpSum<3> / ExpSum<4> (no functor generated): kernel 6
    once, or kernel 7 once per iteration, every launch a P > 4 one, near
    the CPU's run (assert_runs_close)."""
    eng, launched, g, c = multiexp_vb_on_card(cuda, "exp", num, extra,
                                              route)
    assert eng.functor is None
    assert launched == (1 if route == "pallas-loop-nl" else 2)
    assert_runs_close(g, c)


@pytest.mark.parametrize("num", [3, 4])
def test_multiexp_nlls_on_card_runs_expsum(cuda, num):
    """exp at num-exps 3 and 4 with method=nlls on the card: kernel 8
    with ExpSum<3> / ExpSum<4> (phase 1 and the resume: two P > 4
    launches) against the CPU's plain version, by fit (a float32 J'J
    of several exponentials is near singular, so bad voxels and
    parameters move with rounding): bad voxels within 5 of the CPU's,
    and on the lanes both fit, the fits within 1e-3 of the data's scale
    in >= 95%."""
    from fabber_core_tpu_torch.inference.nlls import NLLSInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.options import RunOptions
    data = multiexp_data(num, seed=1)
    opts = RunOptions({"model": "exp", "num-exps": str(num), "dt": "0.05",
                       "dtype": "single", "method": "nlls"})
    res = {}
    for dev in (cuda, "cpu"):
        eng = NLLSInference(get_model_class("exp")(opts), opts, data,
                            device=dev)
        assert eng.route == "nlls-kernel" and eng.functor is None
        before = fn.fused_nlls_loop.launches
        res[str(dev)] = eng.run()
        assert fn.fused_nlls_loop.launches - before == (
            0 if dev == "cpu" else 2)
    g, c = res[str(cuda)], res["cpu"]
    assert g.bad_voxels.sum() <= c.bad_voxels.sum() + 5
    ok = ~(g.bad_voxels | c.bad_voxels)
    fits = [eng.evaluate_model(torch.as_tensor(r.means.T,
                                               dtype=torch.float64))
            .cpu().numpy()[:, ok] for r in (g, c)]
    err = np.abs(fits[0] - fits[1]).max(axis=0)
    assert (err <= 1e-3 * np.abs(data).max()).mean() >= 0.95


@pytest.fixture
def port_registry():
    """The port's model registry holds what it held before, after a test
    that loads a plugin (no jax here, so the JAX package's is not
    touched)."""
    from fabber_core_tpu_torch.models import base
    from torch_generic_models import restored
    with restored(base._MODELS):
        yield


def test_time_signal_plugin_routes_on_card(cuda, port_registry):
    """The myexp plugin (a time_signal, no kernel_model): the whole-loop
    route builds a functor generated from its time_signal for kernel 6;
    the per-iteration route (engine-kernel=pallas) builds the same
    functor for kernel 7 and launches it once per iteration, every
    launch with the generated functor, near the CPU run (kernel 7's
    plain version; float32 on both, tests/test_torch_nl_engine.py's
    bounds); an earlier engine's continued run builds kernel 7 before
    its first launch."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import (get_model_class,
                                              load_models_from_file)
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.options import RunOptions
    from pathlib import Path
    load_models_from_file(str(Path(__file__).resolve().parents[1]
                              / "fabber_core_tpu_torch" / "examples"
                              / "fwdmodel_exp.py"))
    rng = np.random.default_rng(3)
    data = (rng.uniform(0.6, 1.4, (64, 1))
            * np.exp(-np.arange(40) * 0.05)[None]
            + rng.normal(0, 0.02, (64, 40))).astype(np.float32)
    base = {"model": "myexp", "dt": "0.05", "noise": "white",
            "dtype": "single", "max-iterations": "5"}
    opts = RunOptions(base)
    eng = VBInference(get_model_class("myexp")(opts), opts, data,
                      device=cuda)
    assert eng.route == "pallas-loop-nl" and eng.generic is None
    assert eng.functor is not None and eng.functor.fn is None
    before = (nl.fused_nl_loop.launches, nl.fused_nl_loop.generic_launches)
    res = eng.run()
    assert np.isfinite(res.means).all()
    # the time_signal mode, through a generated functor: not kernel 6g
    assert (nl.fused_nl_loop.launches,
            nl.fused_nl_loop.generic_launches) == (before[0] + 1, before[1])
    # a continued run: kernel 7, built now
    n7 = fv.fused_iteration.generated_launches
    res2 = eng.run(res.means, res.cov)
    assert fv.fused_iteration.generated_launches - n7 == 5
    assert set(eng.functor.libs) == {("nl_loop", 1), ("vb_iter", 1)}
    assert np.isfinite(res2.means).all()
    opts = RunOptions({**base, "engine-kernel": "pallas"})
    res = {}
    for dev in (cuda, "cpu"):
        e = VBInference(get_model_class("myexp")(opts), opts, data,
                        device=dev)
        assert e.route == "pallas"
        n0 = (fv.fused_iteration.launches,
              fv.fused_iteration.generated_launches)
        res[str(dev)] = e.run()
        n1 = (fv.fused_iteration.launches,
              fv.fused_iteration.generated_launches)
        assert n1 == ((n0[0] + 5, n0[1] + 5) if dev != "cpu" else n0)
    g, c = res[str(cuda)], res["cpu"]
    sd = np.sqrt(np.diagonal(c.cov, axis1=1, axis2=2))
    assert np.max(np.abs(g.means - c.means) / sd) < 5e-3
    np.testing.assert_allclose(g.noise_means, c.noise_means, rtol=2e-3)


def test_time_signal_plugin_nlls_on_card(cuda, port_registry):
    """method=nlls on the myexp plugin: kernel 8 with the functor
    generated from its time_signal, phase 1 and the resume (two-phase
    compaction, bit for bit the fresh launch), near the CPU run at
    float32 (tests/test_nlls_stats.py's kernel bounds)."""
    from fabber_core_tpu_torch.inference.nlls import NLLSInference
    from fabber_core_tpu_torch.models import (get_model_class,
                                              load_models_from_file)
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.options import RunOptions
    from pathlib import Path
    load_models_from_file(str(Path(__file__).resolve().parents[1]
                              / "fabber_core_tpu_torch" / "examples"
                              / "fwdmodel_exp.py"))
    rng = np.random.default_rng(4)
    t = np.arange(40) * 0.05
    data = (rng.uniform(0.6, 1.4, (256, 1))
            * np.exp(-rng.uniform(0.7, 1.3, (256, 1)) * t[None])
            + rng.normal(0, 0.05, (256, 40))).astype(np.float32)
    opts = RunOptions({"model": "myexp", "dt": "0.05", "method": "nlls",
                       "dtype": "single", "nlls-phase1-iterations": "4"})
    res = {}
    for dev in (cuda, "cpu"):
        eng = NLLSInference(get_model_class("myexp")(opts), opts, data,
                            device=dev)
        assert eng.route == "nlls-kernel"
        assert (eng.functor is not None) == (dev != "cpu")
        n0 = fn.fused_nlls_loop.generated_launches
        res[str(dev)] = eng.run()
        assert fn.fused_nlls_loop.generated_launches - n0 == (
            0 if dev == "cpu" else 2)
        if dev != "cpu":
            p0 = eng.initial_means()
            s, prec, cov = eng._solve_kernel(p0)
            fresh = fn.fused_nlls_loop(
                eng.model, [p.transform for p in eng.params], p0,
                eng.data.contiguous(), eng.tmask_host, eng.max_its,
                functor=eng.functor)
            for a, b in zip((s.params, s.cost, prec, cov),
                            (fresh[0], fresh[1], fresh[3], fresh[4])):
                assert torch.equal(a, b)
    g, c = res[str(cuda)], res["cpu"]
    np.testing.assert_allclose(g.means, c.means, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(g.cov, c.cov, rtol=5e-3, atol=1e-5)
    np.testing.assert_array_equal(g.bad_voxels, c.bad_voxels)


def test_generated_libraries_distinct_per_kernel(cuda):
    """One functor at one Q: kernel 6's and kernel 7's generated
    libraries are two builds under two keys, each with its own entry
    points; kernel 8's a third."""
    from fabber_core_tpu_torch.models.kernelgen import \
        derive_time_local_eval
    from fabber_core_tpu_torch.ops import _cuda
    from torch_generic_models import GaussianAct
    tle = derive_time_local_eval(GaussianAct(), 30, 4)
    libs = {k: _cuda.build_generated(tle.source, 4, None if k == "nlls"
                                     else 1, k)
            for k in ("nl_loop", "vb_iter", "nlls")}
    keys = {k: _cuda.generated_key(tle.source, 4, None if k == "nlls"
                                   else 1, k) for k in libs}
    assert len(set(keys.values())) == 3
    assert len({id(lib) for lib in libs.values()}) == 3
    for k, names in (("nl_loop", ("fabber_gen_nl_loop",
                                  "fabber_gen_occupancy")),
                     ("vb_iter", ("fabber_gen_vb_iter",
                                  "fabber_gen_vb_iter_occupancy")),
                     ("nlls", ("fabber_gen_nlls",
                               "fabber_gen_nlls_occupancy"))):
        for name in names:
            assert hasattr(libs[k], name)
    assert not hasattr(libs["nl_loop"], "fabber_gen_vb_iter")
    assert not hasattr(libs["vb_iter"], "fabber_gen_nl_loop")
    assert _cuda.gen_vb_iter_occupancy(libs["vb_iter"], True, 32, 30) >= 1
    assert _cuda.gen_nlls_occupancy(libs["nlls"], 2, True, 32, 30) >= 1


# -- spatial VB and ARD on the card --------------------------------------

def spatial_grid(nx, ny, nz):
    return np.array([[x, y, z] for z in range(nz) for y in range(ny)
                     for x in range(nx)], float)


def spatial_engine(device, extra, data, coords):
    from fabber_core_tpu_torch.inference.spatial import SpatialVBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions
    opts = RunOptions({"model": "poly", "degree": "1", "noise": "white",
                       "method": "spatialvb", "max-iterations": "6",
                       "print-free-energy": True, **extra})
    return SpatialVBInference(get_model_class("poly")(opts), opts, data,
                              device=device, coords=coords)


def spatial_data(coords, nt=14, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1, dtype=float)
    truth = 1.0 + 0.1 * coords[:, 0] - 0.05 * coords[:, 1]
    return (truth[:, None] * (1.0 + 0.02 * t[None, :])
            + 0.05 * rng.standard_normal((len(coords), nt))
            ).astype(np.float32)


@pytest.mark.parametrize("stencil", ["dense", "gather"])
@pytest.mark.parametrize("priors", ["MP", "mp"])
def test_spatial_engine_on_card_matches_cpu(cuda, priors, stencil):
    """Spatial VB (plain torch) on the card against the same run on the
    CPU at float64: every output, aK and the resels within 1e-9
    relative (means in posterior sd)."""
    coords = spatial_grid(16, 12, 3)
    data = spatial_data(coords)
    extra = {"param-spatial-priors": priors, "dtype": "double",
             "spatial-stencil": stencil}
    res, engs = {}, {}
    for dev in ("cuda", "cpu"):
        engs[dev] = spatial_engine(dev, extra, data, coords)
        res[dev] = engs[dev].run()
    a, b = res["cuda"], res["cpu"]
    sd = np.sqrt(np.diagonal(b.cov, axis1=1, axis2=2))
    assert np.max(np.abs(a.means - b.means) / sd) <= 1e-9
    np.testing.assert_allclose(a.cov, b.cov, rtol=1e-9,
                               atol=1e-9 * np.abs(b.cov).max())
    np.testing.assert_allclose(a.noise_means, b.noise_means, rtol=1e-9)
    np.testing.assert_allclose(a.free_energy, b.free_energy, rtol=1e-9)
    np.testing.assert_allclose(engs["cuda"].final_ak, engs["cpu"].final_ak,
                               rtol=1e-9)
    np.testing.assert_allclose(engs["cuda"].coefficient_resels,
                               engs["cpu"].coefficient_resels, rtol=1e-9)


def test_spatial_blocked_on_card_equals_unblocked(cuda):
    """Blocked sweeps on the card (the data pinned on the host, blocks
    of 1,000 voxels shipped per sweep) against the unblocked run, float32,
    to roundoff: the JAX package's tests/test_spatial_blocked.py bounds."""
    coords = spatial_grid(32, 32, 4)
    data = spatial_data(coords, seed=3)
    extra = {"param-spatial-priors": "MN", "dtype": "single"}
    e_ref = spatial_engine("cuda", extra, data, coords)
    r_ref = e_ref.run()
    e_blk = spatial_engine("cuda", {**extra, "spatial-block-voxels": "1000"},
                           data, coords)
    assert e_blk.data.device.type == "cpu" and e_blk.data.is_pinned()
    r_blk = e_blk.run()
    np.testing.assert_allclose(r_blk.means, r_ref.means, rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(r_blk.cov, r_ref.cov, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(r_blk.noise_means, r_ref.noise_means,
                               rtol=2e-4)
    np.testing.assert_allclose(e_blk.final_ak, e_ref.final_ak, rtol=2e-4)
    np.testing.assert_array_equal(r_blk.bad_voxels, r_ref.bad_voxels)


def test_ard_kernel7_matches_plain_over_ten_iterations(cuda, monkeypatch):
    """ARD on every exp parameter takes the per-iteration route: kernel 7
    once per iteration, the prior precisions changing between launches.
    Ten iterations against the same run with kernel 7's plain version in
    its place, on the card: means within 5e-3 posterior sd, noise rtol
    2e-3, F rtol 1e-4 / atol 2e-3 (tests/test_torch_nl_engine.py's exp
    bounds)."""
    from fabber_core_tpu_torch.inference import vb as vbm
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.options import RunOptions
    rng = np.random.default_rng(31)
    t = np.arange(24) * 0.05
    data = (rng.uniform(0.5, 2.0, (20_000, 1)) * np.exp(-t)[None, :]
            + rng.normal(0, 0.05, (20_000, 24))).astype(np.float32)
    opts = RunOptions({"model": "exp", "dt": "0.05", "noise": "white",
                       "max-iterations": "10", "dtype": "single",
                       "param-spatial-priors": "A+",
                       "save-free-energy": True})

    def run():
        eng = vbm.VBInference(get_model_class("exp")(opts), opts, data,
                              device="cuda")
        assert eng.route == "pallas" and eng.prior_setup.has_ard
        return eng.run()
    before = fv.fused_iteration.launches
    rk = run()
    assert fv.fused_iteration.launches == before + 10

    def plain(model, transforms, *args, functor=None):
        return fv.fused_iteration_plain(fv.signal_jac_fn(model), transforms,
                                        *args)
    monkeypatch.setattr(vbm, "fused_iteration", plain)
    rp = run()
    sd = np.sqrt(np.diagonal(rp.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rk.means - rp.means) / sd) < 5e-3
    np.testing.assert_allclose(rk.noise_means, rp.noise_means, rtol=2e-3)
    np.testing.assert_allclose(rk.free_energy, rp.free_energy, rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_array_equal(rk.bad_voxels, rp.bad_voxels)


# the user surface: the C API, --profile-dir, model_evaluate, self_test

CAPI_OPTS = {"model": "poly", "degree": "2", "noise": "white",
             "method": "vb", "max-iterations": "10", "dtype": "single",
             "save-mean": True, "save-std": True, "save-noise-mean": True,
             "save-free-energy": True}


def poly_volume(shape, seed, nt=106):
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1, dtype=np.float64)
    design = t[:, None] ** np.arange(3)[None, :]
    nv = int(np.prod(shape))
    truth = np.stack([rng.uniform(50, 150, nv), rng.uniform(-0.5, 0.5, nv),
                      rng.uniform(-0.005, 0.005, nv)])
    data = (design @ truth).T + rng.standard_normal((nv, nt))
    return data.reshape(tuple(shape) + (nt,), order="F").astype(np.float32)


def test_capi_on_card_equals_run_with_data(cuda):
    """The port's C API by ctypes attach with no device option runs on
    the card: kernels 1 and 2 once each, every fabber_get_data output
    equal to run_with_data's on the card bit for bit."""
    import ctypes
    from fabber_core_tpu_torch import capi
    from fabber_core_tpu_torch.api import FabberTpu
    shape = (24, 16, 8)
    vol = poly_volume(shape, 3)
    ref = FabberTpu(device="cuda").run_with_data(CAPI_OPTS, {"data": vol})
    lib = capi.load()
    err = ctypes.create_string_buffer(256)
    fab = lib.fabber_new(err)
    assert fab, err.value
    assert lib.fabber_set_extent(fab, *shape, None, err) == 0
    for key, value in CAPI_OPTS.items():
        value = "" if value is True else value
        assert lib.fabber_set_opt(fab, key.encode(), value.encode(), err) == 0
    flat = np.ascontiguousarray(vol.flatten(order="F"))
    fp = ctypes.POINTER(ctypes.c_float)
    assert lib.fabber_set_data(fab, b"data", 106, flat.ctypes.data_as(fp),
                               err) == 0
    before = (fs.spectral_stats.launches, fs.spectral_core.launches)
    logbuf = ctypes.create_string_buffer(1 << 20)
    assert lib.fabber_dorun(fab, 1 << 20, logbuf, err, None) == 0, err.value
    assert (fs.spectral_stats.launches - before[0],
            fs.spectral_core.launches - before[1]) == (1, 1)
    for name, want in ref.data.items():
        buf = np.empty(int(np.prod(shape)), np.float32)
        assert lib.fabber_get_data_size(fab, name.encode(), err) == 1
        assert lib.fabber_get_data(fab, name.encode(), buf.ctypes.data_as(fp),
                                   err) == 0
        got = buf.reshape(shape, order="F")
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=name)
    lib.fabber_destroy(fab)


def test_profile_dir_trace_names_the_kernels_on_card(cuda, tmp_path):
    """--profile-dir on the card: one Chrome trace whose device events
    name kernels 1 and 2 by their __global__ names."""
    import json
    from fabber_core_tpu_torch import cli
    from fabber_core_tpu_torch.io import nifti
    nifti.save(nifti.NiftiImage(poly_volume((16, 16, 8), 4)),
               str(tmp_path / "data.nii"))
    prof = tmp_path / "prof"
    assert cli.execute(["--model=poly", "--degree=2", "--method=vb",
                        "--noise=white", "--dtype=single",
                        f"--data={tmp_path / 'data.nii'}",
                        f"--output={tmp_path / 'out'}",
                        f"--profile-dir={prof}"]) == 0
    traces = sorted(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    kernels = [e["name"] for e in json.loads(traces[0].read_text())[
        "traceEvents"] if e.get("cat") == "kernel"]
    for name in ("spectral_stats_kernel", "spectral_core_kernel"):
        assert any(name in k for k in kernels), (name, kernels[:20])
    assert f"Profiler trace written to {prof}" in \
        (tmp_path / "out" / "logfile").read_text()


@pytest.mark.parametrize("opts,values", [
    ({"model": "exp", "dt": "0.02", "num-exps": "2"},
     {"amp1": 1.0, "r1": 0.8, "amp2": 0.5, "r2": 6.0}),
    ({"model": "poly", "degree": "2"}, {"c0": 100.0, "c1": 0.5,
                                        "c2": -0.005})],
    ids=["biexp", "poly"])
def test_model_evaluate_on_card(cuda, opts, values):
    """FabberTpu().model_evaluate runs on the card by default, float64
    there, equal to the CPU's within 1e-12 of its max."""
    from fabber_core_tpu_torch.api import FabberTpu
    got = FabberTpu().model_evaluate(opts, values, 106)
    ref = FabberTpu(device="cpu").model_evaluate(opts, values, 106)
    assert got.dtype == np.float64
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_self_test_on_card(cuda):
    """The documented exp self-test (tests/test_selftest_reference.py) at
    dtype=single on the card, the harness's default device: kernel 6
    once, every ROI and the noise within 2x the documented deviations."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.selftest import self_test
    before = nl.fused_nl_loop.launches
    res, _ = self_test("exp", {"dt": "0.02", "num-exps": "1",
                               "dtype": "single"},
                       {"amp1": [1.0, 0.5], "r1": [1.0, 0.8]},
                       nt=100, patchsize=10, noise=0.1, seed=7)
    assert nl.fused_nl_loop.launches == before + 1
    for (param, truth), dev in {("amp1", 1.0): 3e-4, ("amp1", 0.5): 7e-4,
                                ("r1", 1.0): 7.3e-4,
                                ("r1", 0.8): 1.3e-3}.items():
        assert abs(res[param][truth] - truth) <= 2 * dev, (param, truth)
    (_, noise_out), = res["noise"].items()
    assert abs(noise_out - 0.1) <= 2 * 4.8e-4


def test_generated_p6_plugin_on_card(cuda, port_registry):
    """The myexp plugin at num-exps 3 (P = 6, no kernel_model): the
    whole-loop route builds kernel 6 with a functor generated from its
    time_signal (P <= 8 since kMaxP is 8) and launches it once, a P > 4
    launch, near the CPU's run (assert_runs_close)."""
    from pathlib import Path
    from fabber_core_tpu_torch.models import load_models_from_file
    load_models_from_file(str(Path(__file__).resolve().parents[1]
                              / "fabber_core_tpu_torch" / "examples"
                              / "fwdmodel_exp.py"))
    eng, launched, g, c = multiexp_vb_on_card(cuda, "myexp", 3, {},
                                              "pallas-loop-nl")
    assert eng.functor is not None and eng.functor.nparams == 6
    assert ("nl_loop", 1) in eng.functor.libs and launched == 1
    assert_runs_close(g, c)


# -- the per-shape instances past the prebuilt lists (ops/_cuda.py
# build_instance, built at their first launch) -------------------------------

WIDE_SPECTRAL = [(12, None), (12, "trialmode"), (20, None),
                 (20, "trialmode"), (25, None)]


@pytest.mark.parametrize("p,kind", WIDE_SPECTRAL,
                         ids=[f"P{p}-{k or 'maxits'}"
                              for p, k in WIDE_SPECTRAL])
def test_spectral_instances_match_plain(cuda, p, kind):
    """Kernels 1, 2 and 3 past P = 8 (per-shape instances: the block's
    factor of A and the constants in shared memory), T=106, ragged voxel
    count: kernel 1 staged equal to streamed bit for bit and within phase
    3's bounds of its plain version (m0 1e-3, rtqr 1e-4, D'Qy 1e-5);
    kernel 2 on its statistics and kernel 3 (staged and streamed) on the
    data held to their plain versions at float64 (assert_near_f64, a
    detector mode by decision share); each launch a per-shape one."""
    nt, nv = 106, 20_001
    data, tc, ac, pm, sc = fused_inputs(p, nt, nv, cuda)
    before = fs.spectral_stats.instance_launches
    ks = fs.spectral_stats(data, tc, ac)
    assert fs.spectral_stats.instance_launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(
        ks, fs.spectral_stats(data, tc, ac, _vb=0)))
    ps = fs.spectral_stats_plain(data, tc, ac)
    a64 = ac.double().reshape(p, p).to(cuda)
    assert rel(ks[0], ps[0]) <= 1e-3 and rel(ks[1], ps[1]) <= 1e-4
    assert rel(ks[2].double() + a64 @ ks[0].double(),
               ps[2].double() + a64 @ ps[0].double()) <= 1e-5
    det, cap = fused_detector(kind)

    def dec(o):
        return decisions(o[6][0], o[3][0] < 0)

    def tidy(o):
        return (o[0], o[1], o[2], o[3].abs()) + tuple(o[4:])

    def held(k, r32, r64):
        if det is None:
            assert_near_f64(k, r32, r64)
        else:
            assert_detector_near_f64(tidy(k), tidy(r32), tidy(r64), dec(k),
                                     dec(r32), dec(r64))
    before = fs.spectral_core.instance_launches
    k = fs.spectral_core(*ks, pm, sc, cap, det)
    assert fs.spectral_core.instance_launches == before + 1
    held(k, fs.spectral_core_plain(*ks, pm, sc, cap, det),
         fs.spectral_core_plain(*to_f64(ks), pm.double(), sc.double(), cap,
                                det))
    r32 = fs.spectral_fused_plain(data, tc, ac, pm, sc, cap, det)
    r64 = fs.spectral_fused_plain(data.double(), tc.double(), ac.double(),
                                  pm.double(), sc.double(), cap, det)
    for vb in (None, 0):
        before = fs.spectral_fused.instance_launches
        k = fs.spectral_fused(data, tc, ac, pm, sc, cap, det, _vb=vb)
        assert fs.spectral_fused.instance_launches == before + 1
        held(k, r32, r64)


WIDE_WHOLE = [(12, 2, None), (12, 2, "trialmode"), (12, 1, "lm"),
              (4, 4, None), (7, 3, None), (16, 1, None), (20, 1, None),
              (17, 2, "trialmode")]


@pytest.mark.parametrize("p,nq,kind", WIDE_WHOLE,
                         ids=[f"P{p}-Q{q}-{k or 'maxits'}"
                              for p, q, k in WIDE_WHOLE])
def test_whole_instances_match_plain(cuda, p, nq, kind):
    """Kernel 4's per-shape instances (D'Q_qD from a device buffer) past
    the prebuilt list, in maxits and its detector modes, held to the
    plain version at float64 (assert_near_f64; a detector mode by
    decision share); kernel 5 at the same (P, Q) under maxits where the
    route gate serves it (P <= 16 at Q > 1, 17 at Q = 1)."""
    from fabber_core_tpu_torch.ops import fused_loop as fl
    from fabber_core_tpu_torch.ops import fused_whole as fw
    args = whole_inputs(p, nq, 20_001, cuda, seed=3)
    before = fw.fused_whole.instance_launches
    if kind is None:
        k = fw.fused_whole(*args, 10)
        assert_near_f64(k, fw.fused_whole_plain(*args, 10),
                        fw.fused_whole_plain(*to_f64(args), 10))
    else:
        det, cap = whole_detector(kind, p, nq)
        k = fw.fused_whole(*args, cap, -1.0, det)

        def dec(o):
            return decisions(o[6][0], torch.zeros_like(o[6][0]))
        r32 = fw.fused_whole_plain(*args, cap, -1.0, det)
        r64 = fw.fused_whole_plain(*to_f64(args), cap, -1.0, det)
        assert_detector_near_f64(k, r32, r64, dec(k), dec(r32), dec(r64))
    assert fw.fused_whole.instance_launches == before + 1
    if kind is None and p <= (17 if nq == 1 else 16):
        data, tc, consts, pm, pp = args
        stats = tuple(x.contiguous() for x in fw.whole_stats_plain(
            data, tc, consts, p, nq))
        before = fl.fused_vb_loop.instance_launches
        k = fl.fused_vb_loop(*stats, consts, pm, pp, 10)
        assert fl.fused_vb_loop.instance_launches == before + 1
        r32 = fl.fused_vb_loop_plain(*stats, consts, pm, pp, 10)
        r64 = fl.fused_vb_loop_plain(*to_f64(stats), consts, pm.double(),
                                     pp.double(), 10)
        e = sd_err(k[0], r64[0], r64[2])
        assert e <= max(1e-3, 2 * sd_err(r32[0], r64[0], r64[2])), e
        for i in range(1, 5):
            e = lane_rel(k[i], r64[i])
            assert e <= max(1e-3, 2 * lane_rel(r32[i], r64[i])), (i, e)


WIDE_AR = [(12, 1, None), (12, 2, None), (16, 1, None),
           (12, 1, "pointzeroone")]


@pytest.mark.parametrize("p,nq,kind", WIDE_AR,
                         ids=[f"P{p}-Q{q}-{k or 'maxits'}"
                              for p, q, k in WIDE_AR])
def test_ar_instances_match_plain(cuda, p, nq, kind):
    """Kernel 9's per-shape instances (P 9-16, D'M_sD from a device
    buffer, -fmad=false) on a cosine design, held to the plain version at
    float64 (assert_near_f64; pointzeroone by decision share)."""
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    args, nm = ar_inputs(p, nq, 20_001, cuda, cosine=True)
    before = fa.fused_ar_loop.instance_launches
    if kind is None:
        k = fa.fused_ar_loop(*args, 10)
        assert_near_f64(k, fa.fused_ar_loop_plain(*args, 10),
                        fa.fused_ar_loop_plain(*to_f64(args), 10))
    else:
        det = ar_detector(kind, p, nq, nm.ntimes)
        cap = int(det["det"].max_iterations) + 2
        k = fa.fused_ar_loop(*args, cap, det)
        r32 = fa.fused_ar_loop_plain(*args, cap, det)
        r64 = fa.fused_ar_loop_plain(*to_f64(args), cap, det)

        def dec(o):
            return decisions(o[9][0], o[6][0] < 0)

        def tidy(o):
            return o[:6] + (o[6].abs(),) + o[7:]
        assert_detector_near_f64(tidy(k), tidy(r32), tidy(r64), dec(k),
                                 dec(r32), dec(r64))
    assert fa.fused_ar_loop.instance_launches == before + 1


def test_failed_instance_build_raises_and_runs_nothing(cuda, tmp_path,
                                                       monkeypatch):
    """A per-shape build nvcc refuses (here: an nvcc that fails) raises at
    the route's first launch with nvcc's output, and nothing runs in its
    place: no plain torch on the card."""
    from fabber_core_tpu_torch import FabberError
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refused today' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_cuda, "_inst_libs", {})
    args, _ = ar_inputs(11, 1, 1000, cuda, cosine=True)
    before = (fa.fused_ar_loop.launches, fa.fused_ar_loop.instance_launches)
    with pytest.raises(FabberError, match="refused today"):
        fa.fused_ar_loop(*args, 10)
    assert before == (fa.fused_ar_loop.launches,
                      fa.fused_ar_loop.instance_launches)


# -- kernels 6-8's per-shape instances (ops/_cuda.py build_instance "nl") ----

WIDE_NL_CASES = [("exp5", 1), ("biexp", 6), ("exp", 5), ("exp9", 1)]


@pytest.mark.parametrize("name,nq", WIDE_NL_CASES,
                         ids=[f"{n}-Q{q}" for n, q in WIDE_NL_CASES])
def test_nl_instances_match_plain(cuda, name, nq):
    """Shapes past the prebuilt list (exp num-exps 5 at Q = 1, biexp at Q
    = 6 and exp at Q = 5, unrolled; exp num-exps 9 at Q = 1, P = 18, kernel
    6's loops rolled and kernel 7's cooperative form, built optimized):
    kernel 6 over 3 iterations with F and kernel 7 over one, plain and LM,
    each launch a per-shape instance, held to the plain version at
    float64 (assert_near_f64; the covariance's worst lane at P = 10 too,
    as both float32 implementations carry the inverse's
    conditioning)."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = nl_inputs(name, nq, 3001, cuda, seed=3)
    pp = torch.ones_like(c["pp"])
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                               c["q"].sum(axis=1), 1e-8, 50.0, nq)
    tsj = fv.signal_jac_fn(c["model"])
    args = (c["centre"], c["pm"], pp, c["data"], c["q"], consts, 3, True)
    before = nl.fused_nl_loop.instance_launches
    k = nl.fused_nl_loop(c["model"], c["tr"], *args)
    assert nl.fused_nl_loop.instance_launches == before + 1
    assert_near_f64(k, nl.fused_nl_loop_plain(tsj, c["tr"], *args),
                    nl.fused_nl_loop_plain(tsj, c["tr"], *to_f64(args)))
    alpha = torch.full((3001,), 0.1, device=cuda)
    alpha[::4] = 0.0
    for lm in (None, alpha):
        args = (c["centre"], c["pm"], pp, c["phi"], c["data"], c["q"], True,
                lm)
        before = fv.fused_iteration.instance_launches
        k = fv.fused_iteration(c["model"], c["tr"], *args)
        assert fv.fused_iteration.instance_launches == before + 1
        assert_near_f64(k, fv.fused_iteration_plain(tsj, c["tr"], *args),
                        fv.fused_iteration_plain(tsj, c["tr"],
                                                 *to_f64(args)))


def test_nl_instance_trialmode_rolled_matches_plain(cuda):
    """Kernel 6 under trialmode (3 iterations, 2 trials) at exp num-exps 9
    (P = 18: its loops rolled, the unit built optimized, as the repair of
    csrc/vb_device.cuh inverse_from_chol allows), a per-shape launch, held
    to the plain version at float64 (assert_detector_near_f64)."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.options import RunOptions
    c = nl_inputs("exp9", 1, 3001, cuda, seed=5)
    opts = RunOptions({**WIDE_NL_MODELS["exp9"][0], "dt": "0.1",
                       "noise": "white", "dtype": "single",
                       "convergence": "trialmode", "max-iterations": "3",
                       "max-trials": "2"})
    det = VBInference(get_model_class("exp")(opts), opts,
                      np.ones((4, 40), np.float32),
                      device="cpu")._nl_fdet_consts()
    consts = nl.pack_nl_consts(np.full(1, 1e6), np.full(1, 1e-6),
                               c["q"].sum(axis=1), 1e-8, 50.0, 1)
    args = (c["centre"], c["pm"], torch.ones_like(c["pp"]), c["data"],
            c["q"], consts, 3, True)
    tsj = fv.signal_jac_fn(c["model"])
    before = nl.fused_nl_loop.instance_launches
    k = nl.fused_nl_loop(c["model"], c["tr"], *args, detector=det)
    assert nl.fused_nl_loop.instance_launches == before + 1
    r32 = nl.fused_nl_loop_plain(tsj, c["tr"], *args, detector=det)
    r64 = nl.fused_nl_loop_plain(tsj, c["tr"], *to_f64(args), detector=det)

    def dec(o):
        return decisions(o[6][0], 0 * o[6][0])
    assert_detector_near_f64(k, r32, r64, dec(k), dec(r32), dec(r64))


def test_coop_iteration_p44_matches_plain(cuda):
    """Kernel 7 at exp num-exps 22 (P = 44, the per-lane form's cap in
    earlier builds): its cooperative form (csrc/fused_vb_iter.cuh
    fused_vb_iter_coop_kernel), plain and LM, each launch counted by
    fused_iteration.coop_launches, held to the plain version at float64
    (assert_near_f64)."""
    from fabber_core_tpu_torch.ops import fused_vb as fv
    c = nl_inputs("exp22", 1, 3001, cuda, seed=6)
    tsj = fv.signal_jac_fn(c["model"])
    alpha = torch.full((3001,), 0.1, device=cuda)
    alpha[::4] = 0.0
    for lm in (None, alpha):
        args = (c["centre"], c["pm"], torch.ones_like(c["pp"]), c["phi"],
                c["data"], c["q"], True, lm)
        before = fv.fused_iteration.coop_launches
        k = fv.fused_iteration(c["model"], c["tr"], *args)
        assert fv.fused_iteration.coop_launches == before + 1
        assert_near_f64(k, fv.fused_iteration_plain(tsj, c["tr"], *args),
                        fv.fused_iteration_plain(tsj, c["tr"],
                                                 *to_f64(args)))


@pytest.mark.parametrize("name", ["exp5", "exp9"])
def test_nlls_instance_two_phase_matches_fresh(cuda, name):
    """exp num-exps 5 (P = 10, unrolled) and 9 (P = 18, rolled) on kernel
    8's per-shape instance: the engine's phase 1 + resume equal to one
    fresh launch bit for bit, each launch a per-shape one."""
    from fabber_core_tpu_torch.inference.nlls import NLLSInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.options import RunOptions
    c = nl_inputs(name, 1, 3001, cuda, seed=4)
    opts = RunOptions({**WIDE_NL_MODELS[name][0], "dt": "0.1",
                       "dtype": "single", "nlls-phase1-iterations": "3"})
    eng = NLLSInference(get_model_class("exp")(opts), opts, None,
                        data_plane=c["data"], device=cuda)
    assert eng.route == "nlls-kernel" and eng.functor is None
    before = fn.fused_nlls_loop.instance_launches
    fresh = fn.fused_nlls_loop(eng.model, c["tr"], c["centre"], c["data"],
                               eng.tmask_host, eng.max_its)
    s, prec, cov = eng._solve_kernel(c["centre"])
    assert fn.fused_nlls_loop.instance_launches == before + 3
    for a, b in zip((s.params, s.cost, prec, cov),
                    (fresh[0], fresh[1], fresh[3], fresh[4])):
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))


# -- kernel 6's full-time form: models that mix time -------------------------

def fulltime_models():
    """tests/torch_fulltime_models.py, its models' names not left in the
    registry."""
    from fabber_core_tpu_torch.models import base
    from torch_generic_models import restored
    with restored(base._MODELS):
        import torch_fulltime_models as fm
    return fm


def fulltime_engine(name, device, nv=4096, nq=1, extra=None, seed=0):
    """An engine on name's model with its data made from a numpy seed
    (the tests' model_data draws), on device."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.options import RunOptions
    fm = fulltime_models()
    cls = {c.name: c for c in (fm.CentredBiexp, fm.ToftsConv,
                               fm.Shifted)}[name]
    rng = np.random.default_rng(seed)
    if name == "biexp-centred-test":
        m = np.stack([rng.uniform(lo, hi, nv) for lo, hi in (
            (0.8, 1.2), (3.0, 5.0), (0.4, 0.6), (0.3, 0.6))])
    else:
        m = np.stack([rng.uniform(0.5, 1.5, nv), rng.uniform(0.5, 2.0, nv)])
    sig = fm.signal(name, m, 100)
    data = (sig + 0.02 * rng.standard_normal(sig.shape)).T.astype(
        np.float32)
    opts = RunOptions({"model": name, "noise": "white", "dtype": "single",
                       "max-iterations": "10", "max-trials": "2",
                       "save-free-energy": True,
                       "noise-pattern": "12"[:nq], **(extra or {})})
    return VBInference(cls(), opts, data, device=device), data, opts, cls


@pytest.mark.parametrize("kind", ["maxits", "freduce", "trialmode"])
@pytest.mark.parametrize("name", ["conv-test", "shift-test",
                                  "biexp-centred-test"])
def test_fulltime_kernel_matches_plain(cuda, name, kind):
    """6t: the full-time form against the plain version (full_eval) at
    float64, on the engine's start and priors: maxits by assert_near_f64,
    the detector modes by assert_detector_near_f64; the centred
    biexponential at 2-3 iterations (chaotic at float32 further out)."""
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.ops import smallmat as sm
    short = name == "biexp-centred-test"
    eng, _, _, _ = fulltime_engine(
        name, cuda, extra={"convergence": kind,
                           **({"max-iterations": "3"} if short else {})})
    assert eng.route == "pallas-loop-nl" and eng.generic.full_time
    tr = eng._transforms()
    s0 = eng.initial_state()
    args = eng.nl_loop_args(s0)
    det = None if kind == "maxits" else eng._nl_fdet_consts()
    pd0 = sm.diag_of(s0.post.cov).contiguous() if kind == "freduce" \
        else None
    n_it = (2 if short else 10) if kind == "maxits" \
        else int(eng.detector.max_iterations)
    ev = fv.full_eval(eng.generic.fn, tr)
    before = nl.fused_nl_loop.fulltime_launches
    k = nl.fused_nl_loop(eng.model, tr, *args, n_it, True, detector=det,
                         post_var0=pd0, functor=eng.functor)
    assert nl.fused_nl_loop.fulltime_launches == before + 1
    r32 = nl.fused_nl_loop_plain(None, tr, *args, n_it, True, detector=det,
                                 post_var0=pd0, evaluator=ev)
    r64 = nl.fused_nl_loop_plain(
        None, tr, *to_f64(args), n_it, True, detector=det,
        post_var0=None if pd0 is None else pd0.double(), evaluator=ev)
    if kind == "maxits":
        assert_near_f64(k, r32, r64)
        return

    def dec(o):
        rev = o[5][1] if kind == "freduce" else torch.zeros_like(o[6][0])
        return decisions(o[6][0], rev)

    assert_detector_near_f64(k, r32, r64, dec(k), dec(r32), dec(r64))


@pytest.mark.parametrize("nq", [1, 2])
def test_fulltime_engine_on_card_matches_cpu(cuda, nq):
    """The convolution through the engine on the card (the full-time form,
    launched once) against the CPU engine: tests/test_fused_loop_nl.py's
    tolerances. The block's bytes are ops/_cuda.py fulltime_smem's."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.ops import _cuda
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    eng, data, opts, cls = fulltime_engine("conv-test", cuda, 2048, nq)
    lib = eng.functor.libs[("nl_loop_full", nq)]
    assert lib.fabber_gen_full_smem() == _cuda.fulltime_smem(
        2, nq, 100, eng.functor.smem_floats)
    rc = VBInference(cls(), opts, data, device="cpu").run()
    before = nl.fused_nl_loop.fulltime_launches
    rk = eng.run()
    assert nl.fused_nl_loop.fulltime_launches == before + 1
    sd = np.sqrt(np.diagonal(rc.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rk.means - rc.means) / sd) < 5e-3
    np.testing.assert_allclose(rk.noise_means, rc.noise_means, rtol=2e-3)
    np.testing.assert_allclose(rk.free_energy, rc.free_energy, rtol=1e-4,
                               atol=2e-3)


# -- kernel 6's generic mode over the JAX allowlist, kernels 7 and 8 with a
#    stacked-parameter time_signal (tests/torch_generic_ops_models.py) ------

def generic_ops_models():
    """tests/torch_generic_ops_models.py, its models' names not left in
    the registry."""
    from fabber_core_tpu_torch.models import base
    from torch_generic_models import restored
    with restored(base._MODELS):
        import torch_generic_ops_models as om
    return om


def generic_ops_data(name, nv, nt=100, seed=0):
    om = generic_ops_models()
    rng = np.random.default_rng(seed)
    m = np.stack([rng.uniform(0.5, 1.5, nv), rng.uniform(0.5, 2.0, nv)])
    sig = om.signal(name, m, nt)
    return (sig + 0.02 * rng.standard_normal(sig.shape)).T.astype(
        np.float32)


@pytest.mark.parametrize("kind", ["maxits", "pointzeroone", "trialmode"])
@pytest.mark.parametrize("name", ["pairs-test", "mixed-test"])
def test_generic_ops_kernel6_matches_plain(cuda, name, kind):
    """Kernel 6 with pairs-test's full-time functor (a contraction of two
    parameter planes, two-axis extrema, values with two time axes; at
    T=64, where the JAX picker fits its 35 time planes) and mixed-test's
    per-sample one (a constant matrix times the parameters; T=100)
    against the plain version at float64, in MODEs 0-2, on the engine's
    start and priors, launched once each."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.options import RunOptions
    om = generic_ops_models()
    cls = {c.name: c for c in (om.Pairs, om.Mixed)}[name]
    opts = RunOptions({"model": name, "noise": "white", "dtype": "single",
                       "max-iterations": "10", "max-trials": "2",
                       "convergence": kind})
    nt = 64 if name == "pairs-test" else 100
    eng = VBInference(cls(), opts, generic_ops_data(name, 4096, nt),
                      device=cuda)
    assert eng.route == "pallas-loop-nl" and eng.generic is not None
    assert eng.generic.full_time == (name != "mixed-test")
    tr = eng._transforms()
    args = eng.nl_loop_args(eng.initial_state())
    det = None if kind == "maxits" else eng._nl_fdet_consts()
    n_it = 10 if kind == "maxits" else int(eng.detector.max_iterations)
    ev = fv.full_eval(eng.generic.fn, tr)
    counter = "generic_launches" if name == "mixed-test" \
        else "fulltime_launches"
    before = getattr(nl.fused_nl_loop, counter)
    k = nl.fused_nl_loop(eng.model, tr, *args, n_it, True, detector=det,
                         functor=eng.functor)
    assert getattr(nl.fused_nl_loop, counter) == before + 1
    r32 = nl.fused_nl_loop_plain(None, tr, *args, n_it, True, detector=det,
                                 evaluator=ev)
    r64 = nl.fused_nl_loop_plain(None, tr, *to_f64(args), n_it, True,
                                 detector=det, evaluator=ev)
    if kind == "maxits":
        assert_near_f64(k, r32, r64)
        return

    def dec(o):
        return decisions(o[6][0], torch.zeros_like(o[6][0]))

    assert_detector_near_f64(k, r32, r64, dec(k), dec(r32), dec(r64))


def test_stacked_time_signal_kernels_7_8_on_card(cuda, port_registry):
    """stacked-test (its time_signal stacks the parameter planes and
    contracts them with a constant matrix): kernel 7 (engine-kernel=
    pallas) and kernel 8 (method=nlls) build its generated functor, where
    require_card_instance raised before, launch it, and land near the CPU
    runs (tests/test_torch_nl_engine.py's and tests/test_nlls_stats.py's
    bounds)."""
    from fabber_core_tpu_torch.inference.nlls import NLLSInference
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.ops import fused_nlls as fn
    from fabber_core_tpu_torch.ops import fused_vb as fv
    from fabber_core_tpu_torch.options import RunOptions
    om = generic_ops_models()
    data = generic_ops_data("stacked-test", 256, nt=40, seed=5)
    opts = RunOptions({"model": "stacked-test", "noise": "white",
                       "dtype": "single", "max-iterations": "5",
                       "engine-kernel": "pallas"})
    res = {}
    for dev in (cuda, "cpu"):
        e = VBInference(om.Stacked(), opts, data, device=dev)
        assert e.route == "pallas"
        n0 = fv.fused_iteration.generated_launches
        res[str(dev)] = e.run()
        assert fv.fused_iteration.generated_launches - n0 == (
            0 if dev == "cpu" else 5)
    g, c = res[str(cuda)], res["cpu"]
    sd = np.sqrt(np.diagonal(c.cov, axis1=1, axis2=2))
    assert np.max(np.abs(g.means - c.means) / sd) < 5e-3
    nopts = RunOptions({"model": "stacked-test", "method": "nlls",
                        "dtype": "single"})
    res = {}
    for dev in (cuda, "cpu"):
        e = NLLSInference(om.Stacked(), nopts, data, device=dev)
        assert e.route == "nlls-kernel"
        n0 = fn.fused_nlls_loop.generated_launches
        res[str(dev)] = e.run()
        assert (fn.fused_nlls_loop.generated_launches - n0 > 0) == (
            dev != "cpu")
    g, c = res[str(cuda)], res["cpu"]
    np.testing.assert_allclose(g.means, c.means, rtol=2e-3, atol=2e-4)
