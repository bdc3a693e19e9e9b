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


# -- the fixed-design kernels (fused_whole.cu kernels 4 and 5,
#    spectral_fused.cu kernel 3) --------------------------------------------

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


@pytest.mark.parametrize("kind", [None, "pointzeroone", "freduce",
                                  "trialmode"])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
def test_spectral_fused_matches_split_pair(cuda, p, kind):
    """Kernel 3 runs the statistics and core kernels' device code in one
    thread: its outputs are the split pair's (kernels 1 + 2) bit for
    bit, in maxits and in each detector mode."""
    nt, nv = 106, 30_001
    gen = torch.Generator(device=cuda)
    gen.manual_seed(p)
    d = design(p, nt)
    q = np.ones(nt)
    q[[1, 50]] = 0.0
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
    det = None if kind is None else detector(kind)
    n_iters = 10 if det is None else int(det.max_iterations) + 2
    before = (fs.spectral_fused.launches, fs.spectral_fused.det_launches)
    k = fs.spectral_fused(data, tc, ac, pm, sc, n_iters, det)
    assert fs.spectral_fused.launches == before[0] + 1
    assert fs.spectral_fused.det_launches == before[1] + (det is not None)
    split = fs.spectral_core(*fs.spectral_stats(data, tc, ac), pm, sc,
                             n_iters, det)
    for a, b in zip(k, split):
        assert torch.equal(a, b)


def test_whole_instances_are_the_listed_ones(cuda):
    """The route gate's instance query answers from the one list,
    csrc/fused_whole.cu FABBER_WHOLE_INSTANCES."""
    from fabber_core_tpu_torch.ops.fused_loop import whole_instantiated
    for p in (1, 2, 3, 4):
        for nq in (1, 2, 3):
            assert whole_instantiated(p, nq)
        assert not whole_instantiated(p, 4)
    assert not whole_instantiated(5, 1)


def test_engine_on_card_refuses_whole_runs_without_an_instance(cuda):
    """A fixed-design kernel route the kernels have no (P, Q) instance
    for raises at construction on the card; the CPU runs its plain
    version."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions
    data = np.ones((64, 30), np.float32)
    for extra in ({"degree": "4", "noise-pattern": "12"},
                  {"noise-pattern": "1234"},
                  {"degree": "5", "engine-kernel": "pallas-loop",
                   "noise-pattern": "12"}):
        opts = RunOptions({"model": "poly", "degree": "2", "noise": "white",
                           "dtype": "single", **extra})
        with pytest.raises(NotImplementedError,
                           match="FABBER_WHOLE_INSTANCES"):
            VBInference(get_model_class("poly")(opts), opts, data,
                        device=cuda)
        VBInference(get_model_class("poly")(opts), opts, data,
                    device="cpu").run()


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
    for p in (2, 4):
        assert fn.nlls_instantiated(KernelModel(KERNEL_EXP, p))
    assert not fn.nlls_instantiated(KernelModel(KERNEL_EXP, 6))
    for p in (1, 2, 3, 4):
        assert fn.nlls_instantiated(KernelModel(KERNEL_POLY, p))
    assert not fn.nlls_instantiated(KernelModel(KERNEL_POLY, 5))
    assert not fn.nlls_instantiated(None)


def test_nlls_engine_on_card_matches_cpu(cuda):
    """The exp NLLS engine on the card (the kernel, phase 1 + resume:
    two launches) against the CPU engine (the plain version):
    tests/test_nlls_stats.py's kernel bounds; and a run the kernel has
    no instance for raises at construction."""
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
    opts = RunOptions({"model": "exp", "dt": "0.05", "dtype": "single",
                       "num-exps": "3"})
    with pytest.raises(NotImplementedError, match="FABBER_NL_INSTANCES"):
        NLLSInference(get_model_class("exp")(opts), opts, data, device=cuda)


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

def plan_edges(nq):
    """For tile_plan at nq weights per sample: the longest T of each VB
    it stages with and the T just past it (the last one streams)."""
    from fabber_core_tpu_torch.ops import _cuda
    edges, last = [], _cuda.tile_plan(1, nq)[1]
    for nt in range(2, 4000):
        staged, vb, _ = _cuda.tile_plan(nt, nq)
        if vb != last or not staged:
            edges += [nt - 1, nt]
            last = vb
        if not staged:
            return edges
    raise AssertionError("no T streams")


def expect_staged(nt, nq, vb=None):
    from fabber_core_tpu_torch.ops import _cuda
    return 1 if _cuda.launch_vb(nt, nq, vb) > 0 else 0


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
    assert _cuda.gen_occupancy(g["tle"].libs[1], 0, 32, 100) >= least


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


# -- the AR(1) whole-loop kernel (fused_ar_loop.cu, kernel 9) ------------------

AR_INSTANCES = [(p, nq) for p in (1, 2, 3, 4) for nq in (1, 2)]
AR_IDS = [f"P{p}-Q{nq}" for p, nq in AR_INSTANCES]


def ar_inputs(p, nq, nv, device, seed=0):
    """Kernel 9's inputs: the plain statistics (float32, on the card) of
    a poly design scaled to [0, 1] and AR(1) data (alpha 0.4 per echo,
    noise sd log-uniform over 1e-2..1 per voxel), the constants of the
    model-default noise, weak priors around random means."""
    from fabber_core_tpu_torch.noise.ar1 import Ar1NoiseModel
    from fabber_core_tpu_torch.ops import fused_loop_ar as fa
    from fabber_core_tpu_torch.options import RunOptions
    rng = np.random.default_rng(seed + 10 * p + nq)
    nt = 30 * nq
    d = (np.arange(1, nt + 1.0)[:, None] / nt) ** np.arange(p)[None]
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
    """The route gate's instance query answers from the one list,
    csrc/fused_ar_loop.cu FABBER_AR_INSTANCES."""
    from fabber_core_tpu_torch.ops.fused_loop_ar import ar_instantiated
    for p in (1, 2, 3, 4):
        assert ar_instantiated(p, 1) and ar_instantiated(p, 2)
        assert not ar_instantiated(p, 3)
    assert not ar_instantiated(5, 1)


def test_engine_on_card_refuses_ar_runs_without_an_instance(cuda):
    """An AR run on the kernel route whose P has no instance raises at
    construction on the card; the CPU runs the plain version."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions
    opts = RunOptions({"model": "poly", "degree": "4", "noise": "ar",
                       "dtype": "single"})
    data = np.random.default_rng(0).standard_normal((64, 30)).astype(
        np.float32)
    with pytest.raises(NotImplementedError, match="FABBER_AR_INSTANCES"):
        VBInference(get_model_class("poly")(opts), opts, data, device=cuda)
    eng = VBInference(get_model_class("poly")(opts), opts, data,
                      device="cpu")
    assert eng.route == "pallas-loop-ar"
    eng.run()


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
        tle.libs[nq] = _cuda.build_generated(tle.source, 4, nq)
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


def test_time_signal_plugin_routes_on_card(cuda):
    """The myexp plugin (a time_signal, no kernel_model): the whole-loop
    route builds a functor generated from its time_signal; the
    per-iteration route, which has no generated functors yet, raises
    naming the ROADMAP item."""
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import (get_model_class,
                                              load_models_from_file)
    from fabber_core_tpu_torch.ops import fused_loop_nl as nl
    from fabber_core_tpu_torch.options import RunOptions
    from pathlib import Path
    load_models_from_file(str(Path(__file__).resolve().parents[1]
                              / "fabber_core_tpu_torch" / "examples"
                              / "fwdmodel_exp.py"))
    data = np.exp(-np.arange(40) * 0.05)[None].repeat(64, 0).astype(
        np.float32)
    base = {"model": "myexp", "dt": "0.05", "noise": "white",
            "dtype": "single", "max-iterations": "5"}
    opts = RunOptions(base)
    eng = VBInference(get_model_class("myexp")(opts), opts, data,
                      device=cuda)
    assert eng.route == "pallas-loop-nl" and eng.generic is None
    assert eng.functor is not None and eng.functor.fn is None
    before = (nl.fused_nl_loop.launches, nl.fused_nl_loop.generic_launches)
    assert np.isfinite(eng.run().means).all()
    # the time_signal mode, through a generated functor: not kernel 6g
    assert (nl.fused_nl_loop.launches,
            nl.fused_nl_loop.generic_launches) == (before[0] + 1, before[1])
    opts = RunOptions({**base, "engine-kernel": "pallas"})
    with pytest.raises(NotImplementedError, match="Queue 1 item 19"):
        VBInference(get_model_class("myexp")(opts), opts, data, device=cuda)
