"""The port's NLLS engine (inference/nlls.py) on its three routes against
the JAX package's on the same data (CPU: the kernel route runs the
kernel's plain version):

  nlls-stats    vs the JAX engine's fixed-design tier (poly, linear;
                Levenberg and Marquardt; masked timepoints)
  nlls-kernel   vs JAX engine-kernel=pallas-loop (interpreted), and its
                two-phase compaction against the single-phase run
  nlls-generic  vs the JAX generic route at float64 (and under
                fwd-initial-posterior)

Tolerances. float64 routes: means within 1e-9 of |x| floored at 1, cov
within 1e-9 of each lane's sd_i sd_j (biexp's J'J reaches cond ~4e9,
which amplifies summation order in its inverse beyond 1e-9 of the
element itself), iteration counts equal except in at most 5% of lanes,
at most 2 apart: float64 accept ties at the optimum
(tests/test_torch_nlls_kernels.py). The statistics and the eigenbasis
loop from the same statistics: 1e-9. float32: tests/test_nlls_stats.py's
kernel bounds (means rtol 2e-3 / atol 2e-4, cov rtol 5e-3 / atol 1e-5,
iteration counts within 30 and their median difference within 4). The
compaction is bit-identical to the single-phase run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.inference import nlls as jnlls_module
from fabber_core_tpu.inference.nlls import NLLSInference as JNLLS
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.convert import (nlls_state_from_numpy,
                                           nlls_stats_from_numpy, to_numpy)
from fabber_core_tpu_torch.inference import nlls as nlls_module
from fabber_core_tpu_torch.inference.nlls import NLLSInference
from fabber_core_tpu_torch.io import matfile, mvn
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.options import RunOptions

torch.set_num_threads(1)

DT = 0.05


def exp_data(nv, nt=40, seed=0, model="exp", dtype=np.float64):
    """tests/test_nlls_stats.py's exp data (biexp: a second component
    0.5 amp at rate 5)."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * DT
    amp = rng.uniform(0.6, 1.4, nv)
    d = amp[:, None] * np.exp(-rng.uniform(0.7, 1.3, nv)[:, None] * t)
    if model == "biexp":
        d = d + 0.5 * amp[:, None] * np.exp(-5.0 * t)[None]
    return (d + rng.normal(0, 0.05, (nv, nt))).astype(dtype)


def poly_data(nv, nt=40, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1, dtype=float)
    return (rng.uniform(-1, 1, nv)[:, None]
            + rng.uniform(-0.05, 0.05, nv)[:, None] * t[None]
            + rng.normal(0, 0.1, (nv, nt)))


def engines(data, opts, jax_extra=None):
    """(JAX engine, port engine) for the same options (the JAX side
    with jax_extra on top)."""
    nv = data.shape[0]
    jo = JOptions({"method": "nlls", **opts, **(jax_extra or {})})
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    je = JNLLS(jmodel(opts["model"])(jo), jo, data, coords)
    to = RunOptions({"method": "nlls", **opts})
    te = NLLSInference(get_model_class(opts["model"])(to), to, data,
                       device="cpu")
    return je, te


def assert_f64_match(rx, rp):
    assert np.max(np.abs(rp.means - rx.means)
                  / np.maximum(np.abs(rx.means), 1.0)) < 1e-9
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rp.cov - rx.cov)
                  / (sd[:, :, None] * sd[:, None, :])) < 1e-9
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)
    tie = rp.iterations != rx.iterations
    assert np.all(np.abs(rp.iterations - rx.iterations)[tie] <= 2)
    assert tie.mean() <= 0.05


def assert_f32_match(rx, rp):
    np.testing.assert_allclose(rp.means, rx.means, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(rp.cov, rx.cov, rtol=5e-3, atol=1e-5)
    diff = np.abs(rp.iterations - rx.iterations)
    assert diff.max() <= 30 and np.median(diff) <= 4
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


# -- nlls-stats ---------------------------------------------------------------

def linear_basis(tmp_path, nt=40):
    t = np.arange(nt) / nt
    d = np.stack([np.ones(nt), t, np.sin(2 * np.pi * 3 * t),
                  np.cos(2 * np.pi * 5 * t)], axis=1)
    path = str(tmp_path / "design.mat")
    matfile.write_vest(d, path)
    return path, d


@pytest.mark.parametrize("dtype", ["double", "single"])
@pytest.mark.parametrize("lm", [False, True], ids=["L", "LM"])
@pytest.mark.parametrize("model", ["poly", "linear"])
def test_stats_route_matches_jax(model, lm, dtype, tmp_path):
    """The fixed-design tier with two masked timepoints: the statistics
    (through convert.nlls_stats_from_numpy), the eigenbasis loop from
    the JAX statistics, and the whole run."""
    opts = {"model": model, "dtype": dtype, "mt1": "5", "mt2": "18"}
    if model == "poly":
        opts["degree"] = "2"
        data = poly_data(64, seed=1)
    else:
        path, d = linear_basis(tmp_path)
        opts["basis"] = path
        rng = np.random.default_rng(2)
        data = (d @ rng.uniform(-2, 2, (4, 64))
                + 0.2 * rng.standard_normal((40, 64))).T
    if lm:
        opts["lm"] = True
    data[:, 4] = 1e6          # corrupted timepoints, masked
    data[:, 17] = -1e6
    data = data.astype(np.float64 if dtype == "double" else np.float32)
    je, te = engines(data, opts)
    assert je.use_stats and te.route == "nlls-stats"
    assert te.route_description() == je.route_description()
    rx, rp = je.run(), te.run()
    if dtype == "double":
        assert_f64_match(rx, rp)
    if dtype == "double" and not lm:
        bind = je._bind()
        jstats = jax.jit(je._make_stats)(bind)
        stats = nlls_stats_from_numpy(jstats, dtype=torch.float64)
        got, ref = to_numpy(te.make_stats()), to_numpy(stats)
        for f in ("m0", "rtr", "dtd"):
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                       rtol=1e-9)
        # D'r0 is roundoff at the OLS point: held within 1e-9 of its
        # Cauchy-Schwarz scale |D_p| |r0|
        scale = np.sqrt(ref.rtr.max() * np.diag(ref.dtd).max())
        np.testing.assert_allclose(got.dtr, ref.dtr, rtol=0,
                                   atol=1e-9 * scale)
        s, _, cov = te._solve_eigen(te.initial_means(), stats)
        js, _, jcov = jax.jit(je._solve_body_eigen)(
            je._initial_means_traced(bind.data), bind)
        np.testing.assert_allclose(s.params.numpy(), np.asarray(js.params),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(s.its.numpy(), np.asarray(js.its))
    if dtype == "single":
        assert_f32_match(rx, rp)
    # the fit is the OLS fit of the unmasked samples
    assert not rp.bad_voxels.any()


# -- nlls-generic -------------------------------------------------------------

def test_generic_route_matches_jax_float64():
    """biexp under --lm at float64 (the CLI default), a masked sample."""
    data = exp_data(48, seed=3, model="biexp")
    opts = {"model": "biexp", "dt": str(DT), "mt1": "7", "lm": True}
    je, te = engines(data, opts)
    assert te.route == "nlls-generic" and not je.use_nl_kernel
    assert_f64_match(je.run(), te.run())
    # one step from the JAX engine's state, through convert.py
    from fabber_core_tpu.inference.nlls import LAMBDA_INIT, NLLSState
    bind = je._bind()
    p0 = je._initial_means_traced(bind.data)
    js0 = NLLSState(p0, jax.jit(je._cost)(p0, bind),
                    jnp.full(48, LAMBDA_INIT), jnp.zeros(48, bool),
                    jnp.int32(0), jnp.zeros(48, jnp.int32))
    js1 = jax.jit(je._step)(js0, bind)
    s1 = te._step(nlls_state_from_numpy(js0, dtype=torch.float64))
    for f in ("params", "cost", "lam"):
        np.testing.assert_allclose(getattr(s1, f).numpy(),
                                   np.asarray(getattr(js1, f)), rtol=1e-9)
    for f in ("done", "its"):
        np.testing.assert_array_equal(getattr(s1, f).numpy(),
                                      np.asarray(getattr(js1, f)))


def test_fwd_initial_posterior_matches_jax(tmp_path):
    """Initial estimates from an MVN matrix file take the generic route
    (the kernel starts from the model default) at float32 too, and start
    every lane from the file's means."""
    path = str(tmp_path / "init.mat")
    mvn.save_matrix(np.array([1.2, 0.9]), np.eye(2), path)
    data = exp_data(32, seed=4)
    for dtype in ("double", "single"):
        opts = {"model": "exp", "dt": str(DT), "dtype": dtype,
                "fwd-initial-posterior": path}
        je, te = engines(data, opts)
        assert te.route == "nlls-generic" and not je.use_nl_kernel
        np.testing.assert_allclose(te.initial_means().numpy(),
                                   np.asarray(je.initial_means()),
                                   rtol=1e-7)
    opts["dtype"] = "double"
    je, te = engines(data, opts)
    assert_f64_match(je.run(), te.run())


# -- nlls-kernel --------------------------------------------------------------

def test_kernel_route_matches_jax_exp():
    data = exp_data(200, seed=3, dtype=np.float32)
    opts = {"model": "exp", "dt": str(DT), "dtype": "single", "mt1": "8"}
    je, te = engines(data, opts, {"engine-kernel": "pallas-loop"})
    assert je.use_nl_kernel and te.route == "nlls-kernel"
    assert te.route_description() == je.route_description().replace(
        "Pallas ", "")
    rx, rp = je.run(), te.run()
    assert_f32_match(rx, rp)
    assert len(np.unique(rp.iterations)) > 1 and not rp.bad_voxels.any()


def compaction_data():
    """tests/test_nlls_oracle.py's compaction data: easy lanes mixed
    with near-degenerate ones (rates 1.25x apart)."""
    rng = np.random.default_rng(11)
    nv, nt = 160, 50
    t = np.arange(nt) * DT
    amp = rng.uniform(0.8, 1.2, (nv, 1))
    r2 = np.where(rng.uniform(size=(nv, 1)) < 0.2, 1.25, 3.0)
    return (amp * np.exp(-1.0 * t)[None, :]
            + 0.6 * amp * np.exp(-r2 * t[None, :])
            + 0.04 * rng.standard_normal((nv, nt))).astype(np.float32)


def test_compaction_bit_identical_to_single_phase():
    """The port's twin of tests/test_nlls_oracle.py's compaction test:
    phase 1 capped at 16, the lanes sorted, the resumed launch and the
    inverse permutation give the single-phase run's outputs bit for
    bit. 160 lanes, a multiple of the CPU's vector width: torch's
    elementwise ops take a scalar path for a row's last V mod 8 lanes,
    whose exp may differ from the vector path's by an ulp, so on the
    CPU a lane's bits can depend on its position (the kernel's
    threads' cannot; tests/test_torch_cuda.py holds them at 20,001)."""
    data = compaction_data()
    res = {}
    for phase1 in (0, 16):
        o = RunOptions({"model": "biexp", "dt": str(DT), "dtype": "single",
                        "nlls-phase1-iterations": str(phase1)})
        eng = NLLSInference(get_model_class("biexp")(o), o, data,
                            device="cpu")
        assert eng.route == "nlls-kernel"
        res[phase1] = eng.run()
    for f in ("means", "cov", "iterations", "bad_voxels"):
        np.testing.assert_array_equal(getattr(res[0], f),
                                      getattr(res[16], f))
    assert int(res[0].iterations.max()) > 16   # the cap bites


def test_failed_lanes_get_the_failure_precision():
    """A lane whose posterior is not finite keeps its (finite) params and
    takes precision 1e-12 I (inference_nlls.cc:195-214), as in JAX."""
    data = exp_data(16, seed=6)
    data[3] = np.nan                    # a voxel of NaN data
    data[9, :] = 0.0                    # a flat zero voxel: mse = 0
    je, te = engines(data, {"model": "exp", "dt": str(DT)})
    rx, rp = je.run(), te.run()
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)
    assert rp.bad_voxels[3]
    for v in np.flatnonzero(rp.bad_voxels):
        np.testing.assert_array_equal(rp.cov[v], np.eye(2) / 1e-12)
    assert np.isfinite(rp.means).all()
    np.testing.assert_allclose(rp.means, rx.means, rtol=1e-9, atol=1e-12)


# -- the route table ---------------------------------------------------------

ROUTE_TABLE = [
    ({"model": "poly", "degree": "2"}, "nlls-stats"),
    ({"model": "poly", "degree": "2", "dtype": "single"}, "nlls-stats"),
    ({"model": "poly", "degree": "1", "PSP_byname1": "c0",
      "PSP_byname1_transform": "L", "dtype": "single"}, "nlls-kernel"),
    ({"model": "biexp", "dtype": "single"}, "nlls-kernel"),
    ({"model": "biexp", "dtype": "single", "lm": True}, "nlls-kernel"),
    ({"model": "exp", "dtype": "single", "engine-kernel": "pallas-loop"},
     "nlls-kernel"),
    ({"model": "exp", "dtype": "bf16"}, "nlls-kernel"),
    ({"model": "exp"}, "nlls-generic"),
    ({"model": "exp", "dtype": "single", "engine-kernel": "xla"},
     "nlls-generic"),
    ({"model": "exp", "dtype": "single", "engine-kernel": "pallas"},
     "nlls-generic"),
    ({"model": "exp", "dtype": "single", "linearization": "fd"},
     "nlls-generic"),
    ({"model": "poly", "degree": "2", "linearization": "fd"},
     "nlls-generic"),
]


@pytest.mark.parametrize("extra,route", ROUTE_TABLE)
def test_route_table_matches_jax(extra, route, monkeypatch):
    """The route each configuration takes, against the JAX engine's
    flags with its auto as on the TPU; the descriptions are the JAX
    engine's (the kernel's without "Pallas")."""
    monkeypatch.setattr(jnlls_module.jax, "default_backend", lambda: "tpu")
    data = exp_data(8, seed=7)
    je, te = engines(data, {"dt": str(DT), **extra})
    jroute = "nlls-stats" if je.use_stats else (
        "nlls-kernel" if je.use_nl_kernel else "nlls-generic")
    assert te.route == jroute == route
    assert te.route_description() == je.route_description().replace(
        "Pallas ", "")


def on_card(eng):
    """eng's kernel-instance gate as it runs on "cuda"."""
    eng.device = torch.device("cuda")
    eng._require_kernel_instance()


def test_kernel_route_without_instance_raises_on_card(monkeypatch):
    """On the card the kernel route needs the model's functor: a
    hand-written one's prebuilt instance (csrc/vb_device.cuh
    FABBER_NL_INSTANCES) or per-shape one (ops/_cuda.py build_instance
    "nl", built at the route's first launch, so nothing is built at
    construction: biexp with the prebuilt list stood in as empty, exp at
    num-exps 5, P = 10, which raised before per-shape instances), else
    one generated from its time_signal and built at construction (kernel
    "nlls"). Where none can be (no hand-written functor and a
    time_signal the generator refuses) the engine raises at
    construction, naming the generator, rather than run plain torch.
    The library's instance query and the builds are stood in for here;
    the card tests ask the real ones."""
    from fabber_core_tpu_torch.inference import nlls as nlls_module
    from fabber_core_tpu_torch.ops import _cuda
    data = exp_data(8, seed=8, model="biexp", dtype=np.float32)
    o = RunOptions({"model": "biexp", "dt": str(DT), "dtype": "single"})
    eng = NLLSInference(get_model_class("biexp")(o), o, data, device="cpu")
    asked, built = [], []
    monkeypatch.setattr(_cuda, "has_nlls_instance",
                        lambda kind, p: asked.append((kind, p)) or False)
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda src, p, q, kernel: built.append(
                            (p, q, kernel)) or "lib")
    monkeypatch.setattr(_cuda, "build_instance",
                        lambda *a: built.append(a))
    on_card(eng)
    assert asked == [(1, 4)] and built == [] and eng.functor is None
    monkeypatch.setattr(eng.model, "kernel_model", lambda: None)
    on_card(eng)
    assert built == [(4, None, "nlls")]
    assert eng.functor.libs == {("nlls", None): "lib"}
    o = RunOptions({"model": "exp", "dt": str(DT), "dtype": "single",
                    "num-exps": "5"})
    eng = NLLSInference(get_model_class("exp")(o), o, data, device="cpu")
    assert eng.route == "nlls-kernel"
    on_card(eng)
    assert asked[1:] == [(1, 10)] and len(built) == 1
    assert eng.functor is None
    monkeypatch.setattr(eng.model, "kernel_model", lambda: None)
    monkeypatch.setattr(nlls_module, "derive_time_signal_functor",
                        lambda model, p: None)
    with pytest.raises(NotImplementedError,
                       match="P=10.*no functor can be generated"):
        on_card(eng)
    assert len(built) == 1
    # the plain-torch routes have no kernel to ask for
    for extra in ({"dtype": "double"}, {"engine-kernel": "xla"}):
        o = RunOptions({"model": "biexp", "dt": str(DT), "dtype": "single",
                        **extra})
        eng = NLLSInference(get_model_class("biexp")(o), o, data,
                            device="cpu")
        on_card(eng)
    assert asked == [(1, 4), (1, 10)]
    assert nlls_module.ROUTES[eng.route]
