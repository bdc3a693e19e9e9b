"""The port's VB engine on its three nonlinear routes (CPU: the kernels'
plain versions) against the JAX engine on the same data, route by
route:

  pallas-loop-nl  vs JAX engine-kernel=pallas-loop (interpreted)
  pallas          vs JAX engine-kernel=pallas (interpreted), with
                  save-free-energy-history and programmatic continuation
  xla-generic     vs JAX engine-kernel=xla, at float32 and float64, with
                  linearization=fd

each also under the four F-based detectors (pointzeroone, freduce,
trialmode, lm): the whole-loop kernel's in-kernel detectors, the
engine's own while loop with best-state save/revert and the
LM-damped update.

Tolerances. exp at float32: those of tests/test_fused_loop_nl.py —
means within 5e-3 posterior sd and rtol 3e-4 (atol 1e-5), noise rtol
2e-3, F rtol 1e-4 / atol 2e-3; iterations and bad voxels equal. At
float64 on the generic route, exp and the Asym4 twin (a P=4 model with
no exchange symmetry) agree to 1e-9 relative, the oracle level.
linearization=fd at float64 agrees to 1e-7 posterior sd: the initial
latent rate is 0, so the reference's step rule takes its 1e-10 floor
step there and the Jacobian carries ~1e-6 relative rounding noise that
XLA's and torch's exp round differently. biexp is symmetric under
exchange of its two components and ill-conditioned where the rates
meet, so ten float32 iterations from the model-default start move
voxels between basins on summation order alone (the JAX package's own
routes agree on about 80% of the voxels of tests/test_fused_loop_nl.py's
biexp data). biexp is therefore held by the criteria of that file's
canonical test: component-sorted parameters within 2e-2 in at least 75%
of voxels, their F within 5 nats, at most 5 more bad voxels; at float64
every voxel's sorted parameters within 2e-2, the median within 1e-7,
and the median F within 1e-4 nats.
"""

import numpy as np
import pytest
import torch

from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.models.base import Model as JModel
from fabber_core_tpu.noise.white import WhiteNoiseState as JNoise
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.convert import noise_state_from_numpy
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.models.base import (DistParams, Model,
                                               ParamSpec)
from fabber_core_tpu_torch.options import RunOptions

torch.set_num_threads(1)

DT = 0.05


def exp_data(nv, nt=24, seed=0, model="exp"):
    """tests/test_fused_loop_nl.py make_engine's data."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * DT
    amp = rng.uniform(0.5, 2.0, nv)
    d = amp[:, None] * np.exp(-t)[None, :]
    if model == "biexp":
        d = d + rng.uniform(0.2, 1.0, nv)[:, None] * np.exp(-5.0 * t)[None]
    return (d + rng.normal(0, 0.05, (nv, nt))).astype(np.float32)


def biexp_data(nv=128, nt=40, seed=1):
    """tests/test_fused_loop_nl.py test_nl_loop_biexp_canonical's data."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * DT
    a1 = rng.uniform(1.0, 2.0, nv)
    a2 = rng.uniform(1.0, 2.0, nv)
    return (a1[:, None] * np.exp(-1.0 * t)[None, :]
            + a2[:, None] * np.exp(-8.0 * t)[None, :]
            + rng.normal(0, 0.02, (nv, nt))).astype(np.float32)


def options(model, extra):
    return {"model": model, "dt": str(DT), "noise": "white",
            "max-iterations": "10", "dtype": "single",
            "save-free-energy": True, **extra}


def run_jax(data, mode, extra=None, model="exp", jm=None, **run_kw):
    o = JOptions({**options(model, extra or {}), "engine-kernel": mode})
    nv = data.shape[0]
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    eng = JVB(jm or jmodel(model)(o), o, data, coords)
    if mode == "pallas-loop":
        assert eng.use_nl_loop and eng.nl_interpret
    if mode == "pallas":
        assert eng.use_fused
    return eng.run(**run_kw)


def port_engine(data, extra=None, model="exp", route=None, tm=None):
    o = RunOptions(options(model, extra or {}))
    eng = VBInference(tm or get_model_class(model)(o), o, data,
                      device="cpu")
    if route is not None:
        assert eng.route == route, eng.route_description()
    return eng


def assert_match(rx, rp, mean_rtol=3e-4, f_atol=2e-3):
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / np.maximum(sd, 1e-6)) \
        < 5e-3
    np.testing.assert_allclose(rp.means, rx.means, rtol=mean_rtol,
                               atol=1e-5)
    np.testing.assert_allclose(rp.noise_means, rx.noise_means, rtol=2e-3)
    if rx.free_energy is not None:
        np.testing.assert_allclose(rp.free_energy, rx.free_energy,
                                   rtol=1e-4, atol=f_atol)
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


def assert_match_f64(rx, rp, rtol=1e-9):
    scale = np.maximum(np.abs(rx.means), 1.0)
    assert np.max(np.abs(rp.means - rx.means) / scale) < rtol
    np.testing.assert_allclose(rp.cov, rx.cov, rtol=rtol * 10,
                               atol=rtol * np.abs(rx.cov).max())
    np.testing.assert_allclose(rp.noise_means, rx.noise_means, rtol=rtol)
    np.testing.assert_allclose(rp.free_energy, rx.free_energy, rtol=rtol,
                               atol=rtol * np.abs(rx.free_energy).max())
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


# -- pallas-loop-nl ----------------------------------------------------------

@pytest.mark.parametrize("nv", [256, 200])
def test_nl_loop_route_matches_jax(nv):
    data = exp_data(nv)
    eng = port_engine(data, route="pallas-loop-nl")
    assert "whole-loop nonlinear kernel" in eng.route_description()
    assert_match(run_jax(data, "pallas-loop"), eng.run())


@pytest.mark.parametrize("extra", [
    {"noise-pattern": "12"}, {"locked-noise-stdev": "0.05"},
    {"prior-noise-stddev": "0.1"}, {"mt1": "4", "mt2": "9"}],
    ids=["pattern-12", "locked-stdev", "phiprior", "masked"])
def test_nl_loop_noise_options_match_jax(extra):
    data = exp_data(128, seed=3)
    assert_match(run_jax(data, "pallas-loop", extra),
                 port_engine(data, extra, route="pallas-loop-nl").run())


def test_nl_loop_without_f_matches_jax():
    data = exp_data(64, seed=4)
    extra = {"save-free-energy": False}
    rx = run_jax(data, "pallas-loop", extra)
    rp = port_engine(data, extra, route="pallas-loop-nl").run()
    assert rp.free_energy is None and rx.free_energy is None
    assert_match(rx, rp)


def _canon_biexp(means):
    """Each voxel's (amp, rate) pairs sorted by the rate latent."""
    pairs = np.stack([means[:, 0:2], means[:, 2:4]], axis=1)
    order = np.argsort(pairs[:, :, 1], axis=1)
    return np.take_along_axis(pairs, order[:, :, None],
                              axis=1).reshape(len(means), 4)


def assert_biexp_close(rx, rp, frac=0.75, f_nats=5.0):
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    assert rp.bad_voxels.sum() <= rx.bad_voxels.sum() + 5
    ok = ~(rx.bad_voxels | rp.bad_voxels)
    assert ok.mean() >= 0.75
    err = np.abs(_canon_biexp(rx.means[ok])
                 - _canon_biexp(rp.means[ok])).max(axis=1)
    close = err < 2e-2
    assert close.mean() >= frac
    fdiff = np.abs(rx.free_energy[ok] - rp.free_energy[ok])
    if f_nats is not None:
        np.testing.assert_array_less(fdiff[close], f_nats)
    return err, fdiff


@pytest.mark.parametrize("jmode,extra,route", [
    ("pallas-loop", {}, "pallas-loop-nl"),
    ("pallas", {"engine-kernel": "pallas"}, "pallas"),
    ("xla", {"engine-kernel": "xla"}, "xla-generic")],
    ids=["pallas-loop-nl", "pallas", "xla-generic"])
def test_biexp_routes_match_jax_canonically(jmode, extra, route):
    data = biexp_data()
    extra = {**extra, "max-iterations": "20"}
    rx = run_jax(data, jmode, extra, model="biexp")
    rp = port_engine(data, extra, model="biexp", route=route).run()
    assert_biexp_close(rx, rp)


# -- pallas (per-iteration kernel) ------------------------------------------

def test_per_iteration_route_matches_jax():
    data = exp_data(200, seed=5)
    extra = {"engine-kernel": "pallas", "noise-pattern": "12"}
    eng = port_engine(data, extra, route="pallas")
    assert_match(run_jax(data, "pallas", extra), eng.run())


def test_free_energy_history_matches_jax():
    """save-free-energy-history takes the per-iteration route: the
    history has one row per iteration plus the final F, as the JAX
    engine's (inference_vb.cc:553-554)."""
    data = exp_data(64, seed=6)
    extra = {"save-free-energy-history": True}
    rx = run_jax(data, "pallas", extra)
    rp = port_engine(data, extra, route="pallas").run()
    assert_match(rx, rp)
    assert rp.fhistory.shape == rx.fhistory.shape == (11, 64)
    np.testing.assert_allclose(rp.fhistory, rx.fhistory, rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_array_equal(rp.fhistory[-1], rp.free_energy)


def test_programmatic_continuation_matches_jax():
    """run(continue_means=...) steps off the whole-loop route onto the
    per-iteration kernel, as the JAX engine does (vb.py:2516-2539)."""
    data = exp_data(96, seed=7)
    first = run_jax(data, "pallas", {"max-iterations": "3"})
    nq = first.noise_means.shape[1]
    var = np.diagonal(first.noise_cov, axis1=1, axis2=2)
    b = (var / first.noise_means).T
    c = (first.noise_means ** 2 / var).T
    kw = dict(continue_means=first.means, continue_cov=first.cov)
    rx = run_jax(data, "pallas", continue_noise=JNoise(b, c), **kw)
    eng = port_engine(data, route="pallas-loop-nl")
    assert eng.continuation_route() == "pallas"
    rp = eng.run(continue_noise=noise_state_from_numpy(JNoise(b, c)), **kw)
    assert nq == 1
    assert_match(rx, rp)


# -- xla-generic --------------------------------------------------------------

def test_generic_route_matches_jax_float32():
    data = exp_data(128, seed=8)
    extra = {"engine-kernel": "xla"}
    assert_match(run_jax(data, "xla", extra),
                 port_engine(data, extra, route="xla-generic").run())


@pytest.mark.parametrize("extra", [{}, {"noise-pattern": "12"}],
                         ids=["one-group", "pattern-12"])
def test_generic_route_matches_jax_float64(extra):
    data = exp_data(64, seed=9).astype(np.float64)
    extra = {"dtype": "double", **extra}
    assert_match_f64(run_jax(data, "auto", extra),
                     port_engine(data, extra, route="xla-generic").run())


def test_generic_route_fd_matches_jax_float64():
    data = exp_data(64, seed=10).astype(np.float64)
    extra = {"dtype": "double", "linearization": "fd"}
    rx = run_jax(data, "auto", extra)
    rp = port_engine(data, extra, route="xla-generic").run()
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < 1e-7
    np.testing.assert_allclose(rp.noise_means, rx.noise_means, rtol=1e-9)
    np.testing.assert_allclose(rp.free_energy, rx.free_energy, rtol=1e-9,
                               atol=1e-7)
    np.testing.assert_array_equal(rp.iterations, rx.iterations)


def test_generic_route_biexp_float64():
    data = biexp_data(64).astype(np.float64)
    extra = {"dtype": "double"}
    rx = run_jax(data, "auto", extra, model="biexp")
    rp = port_engine(data, extra, model="biexp", route="xla-generic").run()
    # F is held at the median only: in the voxels whose posterior is
    # near-singular (the rates meeting) its log-determinant term moves
    # by orders of magnitude while the parameters agree
    err, fdiff = assert_biexp_close(rx, rp, frac=1.0, f_nats=None)
    assert np.median(err) < 1e-7
    assert np.median(fdiff) < 1e-4


class JAsym4(JModel):
    """tests/test_fused_loop_nl.py's Asym4Model: P=4, time-local, no
    exchange symmetry."""
    name = "asym4test"
    dt = 0.05

    def __init__(self, options=None):
        pass

    def param_defaults(self):
        from fabber_core_tpu.models.base import DistParams as JD
        from fabber_core_tpu.models.base import ParamSpec as JP
        return [JP(i, n, JD(0, 100), JD(0, 10))
                for i, n in enumerate(["c0", "c1", "camp", "cdamp"])]

    def evaluate(self, params, ctx, key=""):
        import jax.numpy as jnp
        t = jnp.arange(ctx.nt, dtype=params.dtype) * self.dt
        return (params[0] + params[1] * jnp.sin(jnp.pi * t)
                + params[2] * jnp.cos(jnp.pi * t)
                + params[3] * jnp.sin(2 * jnp.pi * t))

    def time_signal(self, params, t):
        import jax.numpy as jnp
        tv = t * self.dt
        return (params[0] + params[1] * jnp.sin(jnp.pi * tv)
                + params[2] * jnp.cos(jnp.pi * tv)
                + params[3] * jnp.sin(2 * jnp.pi * tv))


class Asym4(Model):
    """The torch twin of JAsym4. It has a time_signal but neither an
    analytic time_signal_jac nor a CUDA functor (kernel_model): on the
    CPU the kernel routes' plain versions differentiate its
    time_signal, on the card those routes refuse it."""
    name = "asym4test"
    dt = 0.05

    def param_defaults(self):
        return [ParamSpec(i, n, DistParams(0, 100), DistParams(0, 10))
                for i, n in enumerate(["c0", "c1", "camp", "cdamp"])]

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        return (params[0] + params[1] * torch.sin(np.pi * t)
                + params[2] * torch.cos(np.pi * t)
                + params[3] * torch.sin(2 * np.pi * t))

    def time_signal(self, params, t):
        tv = t * self.dt
        return (params[0] + params[1] * torch.sin(np.pi * tv)
                + params[2] * torch.cos(np.pi * tv)
                + params[3] * torch.sin(2 * np.pi * tv))


def asym4_data(nv=128, nt=40, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * 0.05
    c = rng.uniform(0.5, 1.5, (nv, 4))
    return (c[:, 0:1] + c[:, 1:2] * np.sin(np.pi * t)[None, :]
            + c[:, 2:3] * np.cos(np.pi * t)[None, :]
            - c[:, 3:4] * np.sin(2 * np.pi * t)[None, :]
            + rng.normal(0, 0.02, (nv, nt)))


def test_asym4_generic_route_matches_jax_float64():
    data = asym4_data()
    extra = {"dtype": "double"}
    o = RunOptions(options("asym4test", extra))
    assert_match_f64(run_jax(data, "auto", extra, jm=JAsym4()),
                     port_engine(data, extra, tm=Asym4(o),
                                 route="xla-generic").run())


def on_card(eng):
    """eng's kernel-instance gate as it runs on "cuda"."""
    eng.device = torch.device("cuda")
    eng._require_kernel_instance()


def test_asym4_float32_has_no_kernel_and_matches_jax(monkeypatch):
    """A time-signal model without a hand-written CUDA functor takes the
    JAX gates' route, the whole-loop kernel's: on the CPU its plain
    version (the Jacobian by forward-mode autodiff of time_signal, as
    the JAX kernel's jax.jvp) matches JAX; on the card the route builds
    a functor generated from its time_signal (models/kernelgen.py; the
    build is stood in for here, the card tests run it) for kernel 6, and
    the per-iteration route builds the same functor for kernel 7, each
    a library of its own, before anything launches."""
    from fabber_core_tpu_torch.ops import _cuda
    data = asym4_data(seed=1).astype(np.float32)
    o = RunOptions(options("asym4test", {}))
    eng = port_engine(data, tm=Asym4(o), route="pallas-loop-nl")
    assert_match(run_jax(data, "pallas-loop", jm=JAsym4()), eng.run(),
                 mean_rtol=1e-3)
    built = []
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda src, p, q, kernel:
                        built.append((src, p, q, kernel)) or kernel)
    on_card(eng)
    assert [(p, q, k) for _, p, q, k in built] == [(4, 1, "nl_loop")]
    assert "g_sin" in built[0][0] and "g_cos" in built[0][0]
    assert eng.functor is not None and eng.functor.fn is None
    # the continuation's kernel 7, built before its first launch
    eng._require_kernel_instance(eng.continuation_route())
    assert [(p, q, k) for _, p, q, k in built[1:]] == [(4, 1, "vb_iter")]
    assert eng.functor.libs == {("nl_loop", 1): "nl_loop",
                                ("vb_iter", 1): "vb_iter"}
    extra = {"engine-kernel": "pallas"}
    eng = port_engine(data, extra, tm=Asym4(RunOptions(
        options("asym4test", extra))), route="pallas")
    on_card(eng)
    assert [k for _, _, _, k in built[2:]] == ["vb_iter"]
    assert built[2][0] == built[0][0]


def test_asym4_per_iteration_route_matches_jax():
    data = asym4_data(seed=2).astype(np.float32)
    extra = {"engine-kernel": "pallas"}
    o = RunOptions(options("asym4test", extra))
    eng = port_engine(data, extra, tm=Asym4(o), route="pallas")
    assert_match(run_jax(data, "pallas", extra, jm=JAsym4()), eng.run(),
                 mean_rtol=1e-3)


def test_group_count_outside_the_kernels_raises_on_card(monkeypatch):
    """Five noise groups: outside the prebuilt list (csrc/vb_device.cuh
    FABBER_NL_INSTANCES, Q <= 4), where the card raised before its
    per-shape instances. Now a per-shape instance (ops/_cuda.py
    build_instance "nl") serves kernel 6, built at the route's first
    launch: construction asks the list, builds nothing (no instance, no
    generated functor) and raises nothing. On the CPU the run takes the
    JAX route (the whole-loop kernel's plain version) and matches JAX.
    The library's instance query is stood in for here; the card tests
    ask the real one."""
    from fabber_core_tpu_torch.ops import _cuda
    data = exp_data(64, seed=11)
    extra = {"noise-pattern": "12345"}
    eng = port_engine(data, extra, route="pallas-loop-nl")
    assert_match(run_jax(data, "pallas-loop", extra), eng.run())
    asked, built = [], []
    monkeypatch.setattr(_cuda, "has_nl_instance",
                        lambda kind, p, q: asked.append((kind, p, q))
                        or q <= 4)
    monkeypatch.setattr(_cuda, "build_instance", lambda *a: built.append(a))
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda *a: built.append(a))
    on_card(eng)
    assert asked == [(1, 2, 5)] * 2 and built == []
    assert eng.functor is None and eng.route == "pallas-loop-nl"
    on_card(port_engine(data, {"noise-pattern": "1234"}))
    assert built == []


# -- evaluate_model (model fit / residual outputs) ----------------------------

@pytest.mark.parametrize("dtype", ["single", "double"])
def test_evaluate_model_biexp_matches_jax(dtype):
    data = exp_data(50, seed=12, model="biexp")
    extra = {"dtype": dtype}
    o = JOptions(options("biexp", extra))
    jeng = JVB(jmodel("biexp")(o), o, data, np.zeros((50, 3)))
    eng = port_engine(data, extra, model="biexp")
    rng = np.random.default_rng(13)
    means = rng.normal(0.0, 0.5, (4, 50))
    ref = np.asarray(jeng.evaluate_model(means))
    got = eng.evaluate_model(means).numpy()
    assert got.shape == (24, 50)
    np.testing.assert_allclose(got, ref, rtol=1e-6 if dtype == "single"
                               else 1e-13)


def test_noise_initial_posterior_file_takes_per_iteration_route(tmp_path):
    """A noise-initial-posterior file fails the whole-loop gate
    (vb.py:643-644): the run takes the per-iteration kernel's route,
    starting every voxel's noise from the file's MVN."""
    from fabber_core_tpu_torch.io import mvn
    path = str(tmp_path / "noise_post.mtx")
    mvn.save_matrix([400.0], [[1e4]], path)
    data = exp_data(64, seed=14)
    extra = {"noise-initial-posterior": path}
    eng = port_engine(data, extra, route="pallas")
    assert_match(run_jax(data, "pallas", extra), eng.run())


# -- the F-based detectors ----------------------------------------------------

NL_DETECTORS = ["pointzeroone", "freduce", "trialmode", "lm"]


@pytest.mark.parametrize("conv", NL_DETECTORS)
@pytest.mark.parametrize("jmode,extra,route", [
    ("pallas-loop", {}, "pallas-loop-nl"),
    ("pallas-loop", {"noise-pattern": "12"}, "pallas-loop-nl"),
    ("pallas", {"engine-kernel": "pallas"}, "pallas")],
    ids=["pallas-loop-nl", "pallas-loop-nl-12", "pallas"])
def test_detector_routes_match_jax(jmode, extra, route, conv):
    """exp under each detector on the kernel routes against the JAX
    engine's route of the same name (interpreted): the tolerances of the
    module docstring, iteration counts equal lane by lane."""
    data = exp_data(160, seed=15)
    extra = {**extra, "convergence": conv}
    eng = port_engine(data, extra, route=route)
    if route == "pallas-loop-nl":
        assert f"in-kernel {conv} detector" in eng.route_description()
    rp = eng.run()
    assert_match(run_jax(data, jmode, extra), rp)
    assert rp.iterations.max() <= eng.detector.max_iterations


@pytest.mark.parametrize("conv", NL_DETECTORS)
def test_detector_generic_route_matches_jax_float64(conv):
    """At float64 on the generic route: iteration counts identical and
    the (possibly reverted) posterior and F to 1e-9."""
    data = exp_data(96, seed=16).astype(np.float64)
    extra = {"dtype": "double", "convergence": conv}
    rp = port_engine(data, extra, route="xla-generic").run()
    assert_match_f64(run_jax(data, "auto", extra), rp)


@pytest.mark.parametrize("conv", NL_DETECTORS)
def test_biexp_detectors_match_jax_at_short_horizon(conv):
    """biexp, the slice's headline model, under each detector on the
    whole-loop route at a short horizon (max-iterations 3, max-trials
    2): its float32 fixed point is chaotic further out (ROADMAP Queue 3
    item 7), so it is held by the canonical criteria of
    assert_biexp_close, iteration counts equal."""
    data = biexp_data(96, seed=17)
    extra = {"convergence": conv, "max-iterations": "3", "max-trials": "2"}
    rx = run_jax(data, "pallas-loop", extra, model="biexp")
    rp = port_engine(data, extra, model="biexp", route="pallas-loop-nl").run()
    assert_biexp_close(rx, rp)


def bench_biexp_data(nv, seed=0):
    """bench.py's biexp data: T=100, dt=0.02, amp ~ U(0.5, 1.5), rates 1
    and 5, the second amplitude 0.5 amp, noise sd 0.05."""
    rng = np.random.default_rng(seed)
    t = np.arange(100) * 0.02
    amp = rng.uniform(0.5, 1.5, nv)
    d = amp[:, None] * (np.exp(-t) + 0.5 * np.exp(-5.0 * t))[None, :]
    return (d + rng.normal(0, 0.05, (nv, 100))).astype(np.float32)


def test_biexp_lm_divergent_lanes_match_jax():
    """biexp under lm at its full horizon on bench.py's data, where
    float32 lm diverges on a few percent of the lanes (the JAX whole-loop
    kernel too; float64 on under 1%): the port's whole-loop route (plain)
    against the JAX engine's pallas-loop kernel interpreted. Which lanes
    diverge is chaotic at float32 (ROADMAP Queue 3 item 7), so the test
    holds rates, with chip_smoke.py phase 5c's bounds: the port's share
    of bad (non-finite) voxels within [0.8, 1.25] times the JAX kernel's
    +-1e-3, and its share of voxels whose (iterations, bad) differ from
    the JAX engine at float64 at most twice the JAX kernel's + 1e-3."""
    nv = 2048
    data = bench_biexp_data(nv)
    extra = {"convergence": "lm", "dt": "0.02"}
    rx = run_jax(data, "pallas-loop", extra, model="biexp")
    rp = port_engine(data, extra, model="biexp", route="pallas-loop-nl").run()
    r64 = run_jax(data.astype(np.float64), "auto",
                  {**extra, "dtype": "double"}, model="biexp")
    bad_x, bad_p = rx.bad_voxels.mean(), rp.bad_voxels.mean()
    assert bad_x >= 0.02 and r64.bad_voxels.mean() < bad_x / 2
    assert 0.8 * bad_x - 1e-3 <= bad_p <= 1.25 * bad_x + 1e-3

    def off_f64(r):
        return ((r.iterations != r64.iterations)
                | (r.bad_voxels != r64.bad_voxels)).mean()

    assert off_f64(rp) <= 2 * off_f64(rx) + 1e-3


def test_nl_fdet_consts_match_jax():
    """The host ELBO constants of the whole-loop detector mode."""
    data = exp_data(8, seed=18)
    extra = {"convergence": "freduce", "noise-pattern": "12",
             "mt1": "3", "prior-noise-stddev": "0.2"}
    o = JOptions({**options("exp", extra), "engine-kernel": "pallas-loop"})
    jeng = JVB(jmodel("exp")(o), o, data, np.zeros((8, 3)))
    jeng._ensure_noise_prior()
    jc = jeng._nl_fdet_consts(10)
    tc = port_engine(data, extra)._nl_fdet_consts()
    np.testing.assert_allclose(tc["lb_coeff"], jc["lb_coeff"], rtol=1e-14)
    for key in ("f_const", "f_const_init"):
        np.testing.assert_allclose(tc[key], jc[key], rtol=1e-13)


@pytest.mark.parametrize("conv", NL_DETECTORS)
def test_detector_lane_state_matches_jax_float64(conv):
    """The engine's final lane state on the generic route at float64
    (after its while loop and finalize) against the JAX engine's: every
    ConvState field (iterations, revert, done, trial and LM state)
    identical, prev_f and alpha to 1e-9."""
    from fabber_core_tpu_torch.convert import to_numpy
    data = exp_data(64, seed=19).astype(np.float64)
    extra = {"dtype": "double", "convergence": conv}
    o = JOptions({**options("exp", extra), "engine-kernel": "xla"})
    jeng = JVB(jmodel("exp")(o), o, data, np.zeros((64, 3)))
    jfin, _ = jeng.compiled_loop()(jeng.initial_state(), jeng._bind())
    eng = port_engine(data, {**extra, "engine-kernel": "xla"},
                      route="xla-generic")
    fin = eng._run_iterations(eng.initial_state(), eng.route)
    assert fin.it == int(jfin.it)
    for field in fin.conv._fields:
        got = to_numpy(getattr(fin.conv, field))
        ref = np.asarray(getattr(jfin.conv, field))
        if field in ("prev_f", "alpha"):
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=field)


def test_trialmode_fd_linearization_matches_jax_float64():
    """linearization=fd under trialmode (the generic route, plain torch)
    against the JAX engine at float64: iteration counts equal, means
    within 1e-7 posterior sd (the fd Jacobian's floor step, see
    test_generic_route_fd_matches_jax_float64)."""
    data = exp_data(64, seed=20).astype(np.float64)
    extra = {"dtype": "double", "linearization": "fd",
             "convergence": "trialmode", "max-trials": "3"}
    rx = run_jax(data, "auto", extra)
    rp = port_engine(data, extra, route="xla-generic").run()
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < 1e-7
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
