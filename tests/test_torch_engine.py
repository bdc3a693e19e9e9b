"""The port's VB engine (CPU: the kernels' plain versions) against the
JAX engine on the same data, on the JAX package's whole-program
spectral route (interpreted Pallas, split form) and its XLA
sufficient-statistics route, at float32, poly degree 2. Tolerances are
those of tests/test_spectral.py (the spectral routes against XLA):
means within 5e-3 posterior sd, cov rtol 2e-3, noise rtol 1e-3, F rtol
1e-3 / atol 5e-3, iterations and bad voxels equal. The options that
move poly off the fixed-design route (engine-kernel=pallas,
linearization=fd, a non-identity transform) run the nonlinear routes
and are held to the same tolerances; so are the F-based detectors
(pointzeroone, freduce, trialmode) on the spectral-whole route, whose
core kernel runs them in-kernel. The route gates the port used to
refuse (bf16 storage, engine-kernel=spectral, P above the spectral
kernels' instances, ARD priors, spatial priors, locked linearization
centres, fixed-design-route=direct) run and are held to the JAX route of
the same name at the same tolerances (spatial priors through
SpatialVBInference; biexp at a two-iteration horizon, its float32 fixed
point being chaotic further out); the two features it used to refuse
(motion correction, the likelihood-only output) run on the route the
run would take without them (tests/test_torch_motion_noprior.py holds
them to the JAX package). The fixed-design statistics
routes (xla, pallas-whole, pallas-loop,
spectral-fused, spectral-xstats), lm on a fixed-design model and the
linear model are held to the JAX engine in test_torch_stats_engine.py.
"""

import numpy as np
import pytest
import torch

from fabber_core_tpu.inference.spatial import SpatialVBInference as JSVB
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.convert import posterior_from_numpy, to_numpy
from fabber_core_tpu_torch.exceptions import InvalidOptionValue
from fabber_core_tpu_torch.inference.spatial import SpatialVBInference
from fabber_core_tpu_torch.inference.vb import ROUTES, VBInference, VBResult
from fabber_core_tpu_torch.io import matfile, mvn
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.options import RunOptions

torch.set_num_threads(1)

BASE = {"model": "poly", "degree": "2", "noise": "white",
        "max-iterations": "10", "dtype": "single",
        "print-free-energy": True}


def make_data(nv, nt=30, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1)
    c0 = rng.uniform(-1, 1, (nv, 1))
    c1 = rng.uniform(-0.05, 0.05, (nv, 1))
    return (c0 + c1 * t[None, :]
            + 0.1 * rng.standard_normal((nv, nt))).astype(np.float32)


def run_jax(data, mode, extra=None, getter=None):
    opts = JOptions({**BASE, **(extra or {}), "engine-kernel": mode})
    nv = data.shape[0]
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    eng = JVB(jmodel("poly")(opts), opts, data, coords,
              voxel_data_getter=getter)
    if mode == "spectral-whole":
        assert eng.use_spectral_whole and eng.sw_interpret
    return eng.run()


def run_port(data, extra=None, getter=None, route="spectral-whole"):
    opts = RunOptions({**BASE, **(extra or {})})
    eng = VBInference(get_model_class("poly")(opts), opts, data,
                      voxel_data_getter=getter, device="cpu")
    assert eng.route == route
    return eng.run()


def assert_match(rx, rp):
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < 5e-3
    np.testing.assert_allclose(rp.cov, rx.cov, rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(rp.noise_means, rx.noise_means, rtol=1e-3)
    np.testing.assert_allclose(rp.noise_cov, rx.noise_cov, rtol=2e-3)
    np.testing.assert_allclose(rp.free_energy, rx.free_energy, rtol=1e-3,
                               atol=5e-3)
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


@pytest.mark.parametrize("mode", ["spectral-whole", "xla"])
@pytest.mark.parametrize("nv", [256, 100])
def test_engine_matches_jax(nv, mode):
    data = make_data(nv)
    assert_match(run_jax(data, mode), run_port(data))


@pytest.mark.parametrize("mode", ["spectral-whole", "xla"])
def test_engine_image_prior_matches_jax(mode):
    """Voxelwise prior means (image prior on c0) reach the core."""
    nv = 128
    img = np.linspace(-0.5, 0.5, nv).astype(np.float32)
    extra = {"PSP_byname1": "c0", "PSP_byname1_type": "I",
             "PSP_byname1_image": "prior_img", "PSP_byname1_prec": "10"}
    data = make_data(nv, seed=4)
    assert_match(run_jax(data, mode, extra, lambda key: img),
                 run_port(data, extra, lambda key: img))


@pytest.mark.parametrize("mode", ["spectral-whole", "xla"])
def test_engine_masked_timepoints_match_jax(mode):
    extra = {"mt1": "3", "mt2": "17"}
    data = make_data(128, seed=5)
    assert_match(run_jax(data, mode, extra), run_port(data, extra))


@pytest.mark.parametrize("extra", [
    {"max-iterations": "1"}, {"prior-noise-stddev": "0.2"}, {"degree": "0"},
    {"noise-initial-prior": "NOISE_MTX"},
], ids=["one-iter", "phiprior", "p1", "noise-prior-file"])
def test_engine_cases_match_jax_xla(extra, tmp_path):
    if "noise-initial-prior" in extra:
        # one MVN for every voxel's noise prior (inference_vb.cc:132-142)
        from fabber_core_tpu_torch.io import mvn
        path = str(tmp_path / "noise_prior.mtx")
        mvn.save_matrix([2.0], [[0.5]], path)
        extra = {"noise-initial-prior": path}
    data = make_data(64, seed=6)
    opts = JOptions({**BASE, "engine-kernel": "xla", **extra})
    rx = JVB(jmodel("poly")(opts), opts, data, np.zeros((64, 3))).run()
    assert_match(rx, run_port(data, extra))


GATES = [
    ({"mcsteps": "1"}, "motion-correction"),
    ({"spatial-prior-output-correction": True}, "noprior-output"),
]


def locked_mvn(nv, p, seed=11):
    """An MVN data key ([V, rows], voxel-major as the data store holds
    it) whose latent means are the fixed linearization centres."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(0.5, 1.5, (nv, p + 1))
    cov = np.broadcast_to(np.eye(p + 1), (nv, p + 1, p + 1))
    return mvn.pack(means, cov).T


# gates that used to raise, each now held to the JAX engine's route of
# the same name (port route, JAX engine-kernel): the pure-XLA spectral
# route at bf16 storage and at engine-kernel=spectral, an ARD prior on
# the last parameter (voxelwise mode keeps the last prior's F term),
# fixed linearization centres (on a fixed design they move nothing but
# the route), spatial priors through the spatial engine (its Jacobi
# sweep), the direct route
ROUTE_GATES = [
    ({"dtype": "bf16"}, "spectral", "spectral"),
    ({"engine-kernel": "spectral"}, "spectral", "spectral"),
    ({"param-spatial-priors": "NNA"}, "xla", "xla"),
    ({"param-spatial-priors": "M"}, "spatial", "auto"),
    ({"locked-linear-from-mvn": "m.nii.gz"}, "xla", "xla"),
    ({"fixed-design-route": "direct"}, "xla-direct", "xla"),
]


@pytest.mark.parametrize("extra,route,jmode", ROUTE_GATES,
                         ids=[r + ":" + ",".join(e)
                              for e, r, _ in ROUTE_GATES])
def test_former_route_gate_matches_jax(extra, route, jmode):
    nv = 128
    data = make_data(nv, seed=9)
    mvn_key = locked_mvn(nv, 3)

    def getter(key):
        return mvn_key
    if route == "spatial":
        coords = np.stack([np.arange(nv) % 16, np.arange(nv) // 16,
                           np.zeros(nv)], 1)
        opts = {**BASE, "spatial-dims": "2", **extra}
        jo = JOptions(opts)
        rx = JSVB(jmodel("poly")(jo), jo, data, coords).run()
        po = RunOptions(opts)
        eng = SpatialVBInference(get_model_class("poly")(po), po, data,
                                 device="cpu", coords=coords)
        assert eng.route == route
        assert_match(rx, eng.run())
        return
    rp = run_port(data, extra, getter, route=route)
    assert_match(run_jax(data, jmode, extra, getter), rp)


def test_parameters_above_the_spectral_kernels_take_spectral(tmp_path):
    """P above the prebuilt spectral kernels (P <= 8) takes the
    spectral-whole route, as the JAX engine on a TPU does (its gate
    admits P <= 25; on the card kernels 1 and 2 are per-shape instances,
    here their plain versions): a well-conditioned P=9 linear design
    against the JAX engine's spectral route, the same eigenbasis fixed
    point in XLA. (Poly degree 8, the same gate, is not compared: its
    uncentred powers of t make the float32 fixed point meaningless in
    both packages, ROADMAP Queue 3.)"""
    nt, nv = 30, 128
    t = np.arange(nt) / nt
    design = np.stack([np.ones(nt)] + [np.cos(np.pi * k * t)
                                       for k in range(1, 9)], axis=1)
    path = str(tmp_path / "design9.mat")
    matfile.write_vest(design, path)
    rng = np.random.default_rng(10)
    data = (rng.uniform(-1, 1, (nv, 9)) @ design.T
            + 0.1 * rng.standard_normal((nv, nt))).astype(np.float32)
    extra = {"model": "linear", "basis": path}
    opts = RunOptions({**BASE, **extra})
    eng = VBInference(get_model_class("linear")(opts), opts, data,
                      device="cpu")
    assert eng.nparams == 9 and eng.route == "spectral-whole"
    rp = eng.run()
    jo = JOptions({**BASE, **extra, "engine-kernel": "spectral"})
    je = JVB(jmodel("linear")(jo), jo, data, np.zeros((nv, 3)))
    assert je.use_spectral
    assert_match(je.run(), rp)
    deg8 = RunOptions({**BASE, "degree": "8"})
    assert VBInference(get_model_class("poly")(deg8), deg8, make_data(16),
                       device="cpu").route == "spectral-whole"


# gates that used to raise: each now runs a nonlinear route of the port,
# held to the JAX engine's route of the same name. linearization=fd runs
# at float64: float32 central differences with the reference's 1e-5
# relative step carry ~1e-2 relative rounding error in the Jacobian, so
# two implementations' float32 fd runs differ by whole posterior sds.
# A log transform on c0 needs a positive starting point: its image prior
# gives one (image-prior parameters start at the image).
FORMER_GATES = [
    ({"engine-kernel": "pallas"}, "pallas", "pallas"),
    ({"linearization": "fd", "dtype": "double"}, "xla-generic", "xla"),
    ({"PSP_byname1": "c0", "PSP_byname1_transform": "L",
      "PSP_byname1_type": "I", "PSP_byname1_image": "img",
      "PSP_byname1_prec": "1e-6"}, "pallas-loop-nl", "pallas-loop"),
]


@pytest.mark.parametrize("extra,route,jmode", FORMER_GATES,
                         ids=[r + ":" + ",".join(e)
                              for e, r, _ in FORMER_GATES])
def test_former_gate_runs_and_matches_jax(extra, route, jmode):
    nv = 128
    data = make_data(nv, seed=7) + 2.0          # positive baseline c0
    img = np.full(nv, 2.0, np.float32)
    rx = run_jax(data, jmode, extra, lambda key: img)
    assert_match(rx, run_port(data, extra, lambda key: img, route=route))


def biexp_data(nv, nt=30, seed=12):
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * 0.1
    return (rng.uniform(1.0, 2.0, (nv, 1)) * np.exp(-1.0 * t)[None, :]
            + rng.uniform(1.0, 2.0, (nv, 1)) * np.exp(-8.0 * t)[None, :]
            + rng.normal(0, 0.02, (nv, nt))).astype(np.float32)


# the biexp runs that used to raise: ARD on every parameter through the
# per-iteration kernel's plain version (JAX: engine-kernel=pallas,
# interpreted) at float32; an M prior (the spatial sweep's generic
# route) and fixed linearization centres (xla-generic) at float64
NONLINEAR_GATES = [
    ({"param-spatial-priors": "A+"}, "pallas", "pallas"),
    ({"param-spatial-priors": "MN", "dtype": "double"}, "spatial", "auto"),
    ({"locked-linear-from-mvn": "m.nii.gz", "dtype": "double"},
     "xla-generic", "xla"),
]


@pytest.mark.parametrize("extra,route,jmode", NONLINEAR_GATES,
                         ids=["biexp:" + ",".join(e)
                              for e, _, _ in NONLINEAR_GATES])
def test_nonlinear_family_former_refusals_match_jax(extra, route, jmode):
    """Two iterations (biexp's float32 fixed point is chaotic further
    out, ROADMAP Queue 3 item 7): float32 at this file's tolerances,
    float64 to 1e-9 relative (means in posterior sd)."""
    nv = 96
    data = biexp_data(nv)
    if extra.get("dtype") == "double":
        data = data.astype(np.float64)
    centres = locked_mvn(nv, 4, seed=13)
    opts = {**BASE, "model": "biexp", "dt": "0.1", "max-iterations": "2",
            **extra}
    coords = np.stack([np.arange(nv) % 12, np.arange(nv) // 12,
                       np.zeros(nv)], 1)
    jo, po = JOptions({**opts, "engine-kernel": jmode}), RunOptions(opts)
    jcls, pcls = (JSVB, SpatialVBInference) if route == "spatial" \
        else (JVB, VBInference)
    je = jcls(jmodel("biexp")(jo), jo, data, coords,
              voxel_data_getter=lambda key: centres)
    eng = pcls(get_model_class("biexp")(po), po, data, device="cpu",
               coords=coords, voxel_data_getter=lambda key: centres)
    assert eng.route == route
    rx, rp = je.run(), eng.run()
    if extra.get("dtype") != "double":
        assert je.use_fused
        assert_match(rx, rp)
        return
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < 1e-9
    np.testing.assert_allclose(rp.noise_means, rx.noise_means, rtol=1e-9)
    np.testing.assert_allclose(rp.free_energy, rx.free_energy, rtol=1e-9)


@pytest.mark.parametrize("model,route", [("biexp", "pallas"),
                                         ("poly", "xla")])
def test_ard_takes_the_jax_route(model, route, monkeypatch):
    """An ARD run takes the route the JAX gates give it, auto as on the
    TPU: the whole-loop and whole-program gates exclude ARD
    (vb.py:415, 641), the per-iteration kernel's does not (vb.py:
    344-360), so biexp at float32 runs kernel 7 once per iteration and
    poly the statistics route."""
    from fabber_core_tpu.inference import vb as jvb_module
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    extra = {**BASE, "model": model, "dt": "0.1",
             "param-spatial-priors": "A+"}
    opts = RunOptions(extra)
    eng = VBInference(get_model_class(model)(opts), opts, make_data(16),
                      device="cpu")
    assert eng.route == route and eng.prior_setup.has_ard
    jo = JOptions(extra)
    je = JVB(jmodel(model)(jo), jo, make_data(16), np.zeros((16, 3)))
    assert (je.use_fused, je.use_stats) == (route == "pallas",
                                            route == "xla")
    assert not (je.use_nl_loop or je.use_loop_kernel
                or je.use_whole_kernel or je.use_spectral_whole)


@pytest.mark.parametrize("model,route", [("poly", "xla"),
                                         ("biexp", "pallas")])
def test_continue_from_mvn_takes_the_continuation_route(model, route,
                                                       monkeypatch):
    """continue-from-mvn used to raise. A continued run now takes the
    route the JAX engine's gates give it (loop_gates_common, whole_core
    and the whole-loop gate exclude it, vb.py:412, 498, 636; its auto as
    on the TPU): the statistics route for a fixed design, the
    per-iteration kernel for a time_signal model at float32."""
    from fabber_core_tpu.inference import vb as jvb_module
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    extra = {**BASE, "model": model, "dt": "0.1",
             "continue-from-mvn": "x.nii.gz"}
    opts = RunOptions(extra)
    eng = VBInference(get_model_class(model)(opts), opts, make_data(16),
                      device="cpu")
    assert eng.route == route and eng.continued
    assert eng.continuation_route() == route
    jo = JOptions(extra)
    je = JVB(jmodel(model)(jo), jo, make_data(16), np.zeros((16, 3)))
    assert (je.use_fused, je.use_stats) == (route == "pallas",
                                            route == "xla")
    assert not (je.use_nl_loop or je.use_loop_kernel
                or je.use_whole_kernel or je.use_spectral_whole)


@pytest.mark.parametrize("extra,route", GATES,
                         ids=[r + ":" + ",".join(e) for e, r in GATES])
def test_unported_route_raises(extra, route):
    """The two features that raised until they were ported are feature
    rows of ROUTES with no ROADMAP item; a run with one takes (and
    logs) the route it takes without it, and runs: one motion-correction
    step on a 4x4x1 grid, the likelihood-only maps beside the result."""
    data = make_data(16)
    assert route in ROUTES
    opts = RunOptions({**BASE, **extra})
    coords = np.stack([np.arange(16) % 4, np.arange(16) // 4,
                       np.zeros(16)], 1)
    eng = VBInference(get_model_class("poly")(opts), opts, data,
                      coords=coords, device="cpu")
    assert eng.route == "spectral-whole"
    res = eng.run()
    assert np.isfinite(res.means).all()
    if route == "motion-correction":
        assert len(eng.mc_translations) == 1 and res.noprior_means is None
    else:
        assert res.noprior_means.shape == res.means.shape
        assert np.isfinite(res.noprior_cov).all()


def make_det_data(nv, nt=30, seed=0):
    """make_data with a noise sd log-uniform over 1e-3..3 per voxel, so
    the lanes' free energies settle at different iterations."""
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1)
    c0 = rng.uniform(-1, 1, (nv, 1))
    c1 = rng.uniform(-0.05, 0.05, (nv, 1))
    sd = 10.0 ** rng.uniform(-3, 0.5, (nv, 1))
    return (c0 + c1 * t[None, :]
            + sd * rng.standard_normal((nv, nt))).astype(np.float32)


DETECTOR_RUNS = [
    ("pointzeroone", {"min-fchange": "1"}), ("freduce", {}),
    ("trialmode", {}), ("trialmode", {"max-trials": "2",
                                      "max-iterations": "4"})]


@pytest.mark.parametrize("mode", ["spectral-whole", "xla"])
@pytest.mark.parametrize("conv,extra", DETECTOR_RUNS,
                         ids=[c + "".join(f"-{k}={v}" for k, v in e.items())
                              for c, e in DETECTOR_RUNS])
def test_detector_runs_match_jax(conv, extra, mode):
    """An F-based detector on the spectral-whole route (the core
    kernel's detector mode; the plain version here) against the JAX
    engine's spectral-whole route (interpreted) and its XLA stats route:
    the module docstring's tolerances, iteration counts equal."""
    extra = {"convergence": conv, **extra}
    data = make_det_data(200, seed=8)
    rp = run_port(data, extra)
    assert_match(run_jax(data, mode, extra), rp)
    if "max-iterations" not in extra:
        assert len(np.unique(rp.iterations)) > 1   # lanes stop apart


@pytest.mark.parametrize("conv,extra", DETECTOR_RUNS,
                         ids=[c + "".join(f"-{k}={v}" for k, v in e.items())
                              for c, e in DETECTOR_RUNS])
def test_spectral_route_detectors_match_jax(conv, extra):
    """engine-kernel=spectral under an F-based detector: the lanes'
    state machines in the eigenbasis loop (make_spectral_detector_loop,
    the core kernel's detector algebra in plain torch) against the JAX
    package's spectral route with its in-loop detector."""
    extra = {"convergence": conv, "engine-kernel": "spectral", **extra}
    data = make_det_data(200, seed=15)
    rp = run_port(data, extra, route="spectral")
    assert_match(run_jax(data, "spectral", extra), rp)


def test_direct_route_matches_jax_under_lm():
    """fixed-design-route=direct used to be refused here: the design as
    the Jacobian, with the LM-damped update, against the JAX direct
    route."""
    extra = {"fixed-design-route": "direct", "convergence": "lm"}
    data = make_data(96, seed=14)
    assert_match(run_jax(data, "xla", extra),
                 run_port(data, extra, route="xla-direct"))


@pytest.mark.parametrize("extra,err", [
    ({"engine-kernel": "bogus"}, InvalidOptionValue),
    ({"dtype": "half"}, InvalidOptionValue),
    ({"convergence": "bogus"}, InvalidOptionValue),
])
def test_other_refusals(extra, err):
    with pytest.raises(err):
        run_port(make_data(16), extra)


def test_data_plane_and_route_description():
    """A [T,V] plane passed as data_plane is used as is."""
    data = make_data(50)
    opts = RunOptions(BASE)
    eng = VBInference(get_model_class("poly")(opts), opts, None,
                      data_plane=torch.from_numpy(data.T.copy()),
                      device="cpu")
    assert "spectral" in eng.route_description()
    r = eng.run()
    r2 = run_port(data)
    np.testing.assert_array_equal(r.means, r2.means)
    with pytest.raises(ValueError):
        VBInference(get_model_class("poly")(opts), opts, None,
                    data_plane=torch.zeros(5), device="cpu")


def test_initial_state_matches_jax():
    """Default-init posterior, noise and detector state."""
    data = make_data(32)
    jopts = JOptions({**BASE})
    jeng = JVB(jmodel("poly")(jopts), jopts, data, np.zeros((32, 3)))
    js = jeng.initial_state()
    opts = RunOptions(BASE)
    eng = VBInference(get_model_class("poly")(opts), opts, data, device="cpu")
    s = eng.initial_state()
    port = to_numpy(s.post)
    carried = to_numpy(posterior_from_numpy(js.post))
    for name in ("means", "prec", "cov", "prior_means", "prior_prec"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(carried, name))
    np.testing.assert_array_equal(port.noise.b, carried.noise.b)
    np.testing.assert_array_equal(port.noise.c, carried.noise.c)
    np.testing.assert_array_equal(s.conv.its.numpy(), np.asarray(js.conv.its))
    np.testing.assert_array_equal(s.conv.prev_f.numpy(),
                                  np.asarray(js.conv.prev_f))


def test_convert_carries_a_jax_result():
    data = make_data(40)
    rx = run_jax(data, "xla")
    r = posterior_from_numpy(rx)
    assert isinstance(r, VBResult)
    np.testing.assert_array_equal(r.means, rx.means)
    assert r.fhistory is None


def test_bad_voxels_degrade_to_identity():
    """A voxel with non-finite data fails numerically and is degraded
    to zero mean / identity covariance (inference_vb.cc:556-570)."""
    data = make_data(20)
    data[3, :] = np.nan
    r = run_port(data)
    assert r.bad_voxels.tolist() == [i == 3 for i in range(20)]
    np.testing.assert_array_equal(r.means[3], 0.0)
    np.testing.assert_array_equal(r.cov[3], np.eye(3))
    np.testing.assert_array_equal(r.noise_means[3], 0.0)
    assert np.isfinite(r.means).all()
