"""The port's fixed-design sufficient-statistics routes (CPU: the
kernels' plain versions) against the JAX engine on the same data:

  xla             plain torch (the JAX engine's XLA stats route) at
                  float64 against the JAX xla route, to 1e-9 relative
                  (means in posterior sd), for every detector, noise
                  patterns 12 and 121, masked timepoints, a locked noise
                  sd and save-free-energy-history;
  pallas-whole, pallas-loop, spectral-fused, spectral-xstats
                  at float32 against the JAX engine's same engine-kernel
                  / spectral-impl (its Pallas kernels interpreted):
                  tests/test_fused_whole.py's bounds, at most 3 of 256
                  lanes with another iteration count, means within 5e-3
                  posterior sd on the others, noise rtol 2e-3, F rtol
                  1e-4 / atol 5e-3 (the detector modes assemble F in
                  float32 from terms of a few hundred);
  linear          the linear model (a VEST design file) against the JAX
                  linear model;
  routes          for each configuration, the port's route against the
                  JAX engine's use_* flags with its `auto` on a TPU (the
                  port's `auto` picks the card's route on either device).
"""

import numpy as np
import pytest
import torch

import fabber_core_tpu.inference.vb as jvb_module
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.io import matfile
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.ops import fused_loop as tfl
from fabber_core_tpu_torch.ops import fused_spectral as tfs
from fabber_core_tpu_torch.ops import fused_whole as tfw
from fabber_core_tpu_torch.options import RunOptions

torch.set_num_threads(1)

BASE = {"model": "poly", "degree": "2", "noise": "white",
        "max-iterations": "10", "dtype": "single",
        "print-free-energy": True}


def make_data(nv, nt=30, seed=0):
    """poly degree 1 signals with a noise sd per voxel (log-uniform over
    1e-3..3, so detector lanes stop apart) and twice that on every
    second timepoint (the noise pattern 12)."""
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1)
    c0 = rng.uniform(-1, 1, (nv, 1))
    c1 = rng.uniform(-0.05, 0.05, (nv, 1))
    sd = 10.0 ** rng.uniform(-3, 0.5, (nv, 1))
    gsd = np.where(np.arange(nt) % 2 == 0, 1.0, 2.0)[None, :]
    return (c0 + c1 * t[None, :]
            + sd * gsd * rng.standard_normal((nv, nt))).astype(np.float32)


def jax_engine(data, extra, model="poly"):
    opts = JOptions({**BASE, "model": model, **extra})
    nv = data.shape[0]
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    return JVB(jmodel(model)(opts), opts, data, coords)


def port_engine(data, extra, model="poly"):
    opts = RunOptions({**BASE, "model": model, **extra})
    return VBInference(get_model_class(model)(opts), opts, data,
                       device="cpu")


def assert_f64_match(rx, rp):
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < 1e-9
    np.testing.assert_allclose(rp.cov, rx.cov, rtol=1e-9,
                               atol=1e-9 * np.abs(rx.cov).max())
    np.testing.assert_allclose(rp.noise_means, rx.noise_means, rtol=1e-9)
    np.testing.assert_allclose(rp.free_energy, rx.free_energy, rtol=1e-9,
                               atol=1e-9 * np.abs(rx.free_energy).max())
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


XLA_CASES = [
    {}, {"noise-pattern": "12"}, {"noise-pattern": "121"},
    {"mt1": "3", "mt2": "17", "noise-pattern": "12"},
    {"locked-noise-stdev": "0.1", "noise-pattern": "12"},
    {"convergence": "pointzeroone", "noise-pattern": "12"},
    {"convergence": "freduce"},
    {"convergence": "trialmode", "noise-pattern": "121"},
    {"convergence": "lm"}, {"convergence": "lm", "noise-pattern": "12"},
    {"save-free-energy-history": True, "convergence": "trialmode"},
    {"save-free-energy-history": True, "noise-pattern": "12"},
]


@pytest.mark.parametrize("extra", XLA_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in e.items())
                              or "default" for e in XLA_CASES])
def test_xla_route_f64_matches_jax(extra):
    """The port's xla route at float64 (the CLI's default dtype) against
    the JAX engine's XLA stats route."""
    extra = {**extra, "dtype": "double"}
    data = make_data(96, seed=1).astype(np.float64)
    jeng = jax_engine(data, extra)
    assert jeng.route_description() == \
        "fixed-design sufficient-statistics route (XLA)"
    eng = port_engine(data, extra)
    assert eng.route == "xla"
    rx, rp = jeng.run(), eng.run()
    assert_f64_match(rx, rp)
    if extra.get("save-free-energy-history"):
        np.testing.assert_allclose(rp.fhistory, rx.fhistory, rtol=1e-9,
                                   atol=1e-9 * np.abs(rx.fhistory).max())
    if extra.get("convergence", "maxits") not in ("maxits", "freduce"):
        assert len(np.unique(rp.iterations)) > 1   # lanes stop apart


def assert_f32_match(rx, rp, max_flips=3):
    flip = rx.iterations != rp.iterations
    assert flip.sum() <= max_flips, flip.sum()
    ok = ~flip
    sd = np.sqrt(np.diagonal(rx.cov[ok], axis1=1, axis2=2))
    assert np.max(np.abs(rx.means[ok] - rp.means[ok])
                  / np.maximum(sd, 1e-6)) < 5e-3
    np.testing.assert_allclose(rp.cov[ok], rx.cov[ok], rtol=2e-3,
                               atol=1e-7)
    np.testing.assert_allclose(rp.noise_means[ok], rx.noise_means[ok],
                               rtol=2e-3)
    np.testing.assert_allclose(rp.free_energy[ok], rx.free_energy[ok],
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


KERNEL_CASES = [
    ("pallas-whole", {"engine-kernel": "pallas-whole"}),
    ("pallas-whole", {"noise-pattern": "12"}),
    ("pallas-whole", {"noise-pattern": "121", "mt1": "3", "mt2": "17"}),
    ("pallas-whole", {"locked-noise-stdev": "0.1"}),
    ("pallas-whole", {"convergence": "pointzeroone",
                      "noise-pattern": "12"}),
    ("pallas-whole", {"convergence": "trialmode", "noise-pattern": "12"}),
    ("pallas-whole", {"convergence": "lm"}),
    ("pallas-whole", {"convergence": "lm", "noise-pattern": "12"}),
    ("pallas-loop", {"engine-kernel": "pallas-loop"}),
    ("pallas-loop", {"engine-kernel": "pallas-loop", "noise-pattern": "12",
                     "locked-noise-stdev": "0.2"}),
    ("spectral-fused", {"spectral-impl": "fused"}),
    ("spectral-fused", {"spectral-impl": "fused",
                        "convergence": "trialmode"}),
    ("spectral-xstats", {"spectral-impl": "xstats"}),
    ("spectral-xstats", {"spectral-impl": "xstats",
                         "convergence": "freduce"}),
]


@pytest.mark.parametrize("route,extra", KERNEL_CASES,
                         ids=[r + ":" + "-".join(f"{k}={v}"
                                                 for k, v in e.items())
                              for r, e in KERNEL_CASES])
def test_kernel_routes_match_jax(route, extra, monkeypatch):
    """Each fixed-design kernel route (its plain version here) against
    the JAX engine's route of the same name, interpreted; an F-based
    detector's lanes stop at different iterations."""
    data = make_data(256, seed=2)
    jextra = dict(extra)
    if route.startswith("spectral"):
        jextra["engine-kernel"] = "spectral-whole"
    elif "engine-kernel" not in jextra:
        jextra["engine-kernel"] = route
    jeng = jax_engine(data, jextra)
    flag = {"pallas-whole": "use_whole_kernel",
            "pallas-loop": "use_loop_kernel"}.get(route,
                                                  "use_spectral_whole")
    assert getattr(jeng, flag)
    eng = port_engine(data, extra)
    assert eng.route == route
    rp = eng.run()
    assert_f32_match(jeng.run(), rp)
    if extra.get("convergence", "maxits") not in ("maxits", "freduce"):
        assert len(np.unique(rp.iterations)) > 1


def test_kernel_route_descriptions():
    data = make_data(16)
    eng = port_engine(data, {"convergence": "lm"})
    assert eng.route == "pallas-whole"
    assert "whole-program" in eng.route_description()
    assert "in-kernel lm detector" in eng.route_description()
    assert port_engine(data, {"spectral-impl": "fused"}).route_description() \
        == "whole-program spectral route in one kernel (spectral-impl=fused)"


def test_lm_under_spectral_whole_takes_the_stats_route():
    """lm fails the spectral gates (loop_gates_common's `not is_lm`,
    vb.py:413): with engine-kernel=spectral-whole the JAX engine runs
    poly under lm on its XLA stats route, and so does the port."""
    extra = {"convergence": "lm", "engine-kernel": "spectral-whole"}
    data = make_data(128, seed=3)
    jeng = jax_engine(data, extra)
    assert not jeng.use_spectral_whole
    assert jeng.route_description() == \
        "fixed-design sufficient-statistics route (XLA)"
    eng = port_engine(data, extra)
    assert eng.route == "xla"
    rp = eng.run()
    assert_f32_match(jeng.run(), rp, max_flips=2)
    assert len(np.unique(rp.iterations)) > 1


def test_lm_under_auto_takes_the_whole_program_kernel(monkeypatch):
    """whole_core admits lm (vb.py:494-508): `auto` on the card takes
    the whole-program kernel, whose lm mode matches the JAX engine's
    XLA stats route within test_fused_whole.py's bounds."""
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    data = make_data(256, seed=4)
    assert jax_engine(data, {"convergence": "lm"}).use_whole_kernel
    monkeypatch.undo()
    eng = port_engine(data, {"convergence": "lm"})
    assert eng.route == "pallas-whole"
    rx = jax_engine(data, {"convergence": "lm", "engine-kernel": "xla"}).run()
    assert_f32_match(rx, eng.run())


@pytest.mark.parametrize("extra", [{}, {"noise-pattern": "12"}],
                         ids=["spectral-whole", "pallas-whole"])
def test_programmatic_continuation_takes_the_stats_route(extra):
    """run(continue_means=...) on a fixed-design model: the kernels
    start from the model default, so the run takes 'xla', as the JAX
    engine's does (tests/test_fused_loop.py
    test_loop_kernel_programmatic_continue_forces_xla); the engine keeps
    its kernel route for later runs."""
    nv = 64
    data = make_data(nv, seed=5)
    base = jax_engine(data, {"engine-kernel": "xla"}).run()
    cm = base.means + 0.5
    one = {"max-iterations": "1", **extra}
    rx = jax_engine(data, {**one, "engine-kernel": "xla"}).run(
        continue_means=cm, continue_cov=base.cov)
    eng = port_engine(data, one)
    route = eng.route
    assert route in ("spectral-whole", "pallas-whole")
    assert eng.continuation_route() == "xla"
    rp = eng.run(continue_means=cm, continue_cov=base.cov)
    assert eng.route == route
    assert_f32_match(rx, rp, max_flips=0)


def write_design(tmp_path, ones, nt=40):
    """A VEST design of drift and two slow oscillations, with an offset
    column unless the model adds its ones regressor; the design the
    model sees is returned beside the path."""
    t = np.arange(nt) / nt
    d = np.stack([t, np.sin(2 * np.pi * 3 * t), np.cos(2 * np.pi * 5 * t)],
                 axis=1)
    path = str(tmp_path / "design.mat")
    matfile.write_vest(d if ones else np.concatenate(
        [np.ones((nt, 1)), d], axis=1), path)
    return path, np.concatenate([d, np.ones((nt, 1))] if ones
                                else [np.ones((nt, 1)), d], axis=1)


@pytest.mark.parametrize("extra", [
    {}, {"dtype": "double"}, {"noise-pattern": "12"},
    {"add-ones-regressor": True}, {"spectral-impl": "fused"}],
    ids=["spectral-whole", "xla-double", "pallas-whole", "ones-regressor",
         "spectral-fused"])
def test_linear_matches_jax(tmp_path, extra):
    """models/linear.py (basis from a VEST file under tmp_path, default
    priors N(0, 1e12)) against the JAX linear model: the same route's
    result within the float32 bounds (float64: 1e-9)."""
    path, d = write_design(tmp_path, bool(extra.get("add-ones-regressor")))
    rng = np.random.default_rng(6)
    nv = 256
    truth = rng.uniform(-2, 2, (d.shape[1], nv))
    data = (d @ truth + 0.2 * rng.standard_normal((d.shape[0], nv))).T
    extra = {**extra, "basis": path}
    double = extra.get("dtype") == "double"
    data = data.astype(np.float64 if double else np.float32)
    eng = port_engine(data, extra, model="linear")
    assert eng.nparams == 4
    jextra = dict(extra)
    if eng.route.startswith("spectral"):
        jextra["engine-kernel"] = "spectral-whole"
    elif eng.route == "pallas-whole":
        jextra["engine-kernel"] = "pallas-whole"
    rx = jax_engine(data, jextra, model="linear").run()
    rp = eng.run()
    (assert_f64_match if double else assert_f32_match)(rx, rp)
    np.testing.assert_allclose(
        eng.evaluate_model(torch.as_tensor(rp.means.T)).numpy(),
        d @ rp.means.T, rtol=1e-5, atol=1e-5)


# configuration -> the port's route; the JAX engine's flags for it,
# with its auto as on the TPU
ROUTE_TABLE = [
    ({}, "spectral-whole"),
    ({"spectral-impl": "fused"}, "spectral-fused"),
    ({"spectral-impl": "xstats"}, "spectral-xstats"),
    ({"convergence": "trialmode"}, "spectral-whole"),
    ({"convergence": "freduce", "noise-pattern": "12"}, "xla"),
    ({"noise-pattern": "12"}, "pallas-whole"),
    ({"noise-pattern": "121", "mt1": "2"}, "pallas-whole"),
    ({"locked-noise-stdev": "0.1"}, "pallas-whole"),
    ({"convergence": "lm"}, "pallas-whole"),
    ({"convergence": "lm", "engine-kernel": "spectral-whole"}, "xla"),
    ({"convergence": "pointzeroone", "noise-pattern": "12"},
     "pallas-whole"),
    ({"engine-kernel": "pallas-whole"}, "pallas-whole"),
    ({"engine-kernel": "pallas-loop"}, "pallas-loop"),
    ({"engine-kernel": "pallas-loop", "noise-pattern": "12"}, "pallas-loop"),
    ({"engine-kernel": "xla"}, "xla"),
    ({"dtype": "double"}, "xla"),
    ({"dtype": "bf16", "noise-pattern": "12"}, "pallas-loop"),
    ({"dtype": "bf16"}, "spectral"),
    ({"save-free-energy-history": True}, "xla"),
    ({"noise-initial-posterior": "n.mtx"}, "xla"),
    ({"engine-kernel": "spectral", "noise-pattern": "12"}, "xla"),
    # the AR(1) detector gate admits no white-noise run
    ({"convergence": "pointzeroone", "engine-kernel": "pallas-loop"}, "xla"),
    # AR(1) noise: kernel 9 without cross terms under the model-default
    # noise prior, maxits / pointzeroone / freduce at float32; the rest
    # the statistics route; fixed-design-route=direct the generic one
    ({"noise": "ar"}, "pallas-loop-ar"),
    ({"noise": "ar", "num-echoes": "2"}, "pallas-loop-ar"),
    ({"noise": "ar", "convergence": "pointzeroone"}, "pallas-loop-ar"),
    ({"noise": "ar", "convergence": "freduce", "num-echoes": "2"},
     "pallas-loop-ar"),
    ({"noise": "ar", "engine-kernel": "pallas-loop"}, "pallas-loop-ar"),
    ({"noise": "ar", "dtype": "bf16"}, "pallas-loop-ar"),
    ({"noise": "ar", "convergence": "trialmode"}, "xla"),
    ({"noise": "ar", "convergence": "lm"}, "xla"),
    ({"noise": "ar", "dtype": "double"}, "xla"),
    ({"noise": "ar", "num-echoes": "2", "ar1-cross-terms": "same"}, "xla"),
    ({"noise": "ar", "num-echoes": "2", "ar1-cross-terms": "dual"}, "xla"),
    ({"noise": "ar", "noise-initial-prior": "n.mtx"}, "xla"),
    ({"noise": "ar", "save-free-energy-history": True}, "xla"),
    ({"noise": "ar", "engine-kernel": "spectral"}, "xla"),
    ({"noise": "ar", "engine-kernel": "spectral-whole"}, "xla"),
    ({"noise": "ar", "engine-kernel": "pallas-whole"}, "xla"),
    ({"noise": "ar", "engine-kernel": "xla"}, "xla"),
    ({"noise": "ar", "fixed-design-route": "direct"}, "xla-generic"),
    # routes and features that used to raise: the pure-XLA spectral
    # route under a detector, ARD priors (off every whole-loop gate),
    # the direct route
    ({"engine-kernel": "spectral", "convergence": "trialmode"}, "spectral"),
    ({"dtype": "bf16", "convergence": "freduce"}, "spectral"),
    ({"param-spatial-priors": "A"}, "xla"),
    ({"param-spatial-priors": "A", "noise-pattern": "12"}, "xla"),
    ({"fixed-design-route": "direct"}, "xla-direct"),
    ({"fixed-design-route": "direct", "convergence": "lm"}, "xla-direct"),
]


def jax_route(jeng):
    """The JAX engine's route (its compiled_loop dispatch order) as a
    key of the port's ROUTES."""
    if getattr(jeng, "use_spectral_whole", False):
        impl = jeng.options.get_string("spectral-impl", "split")
        return {"split": "spectral-whole", "xstats": "spectral-xstats"}.get(
            impl, "spectral-fused")
    if getattr(jeng, "use_whole_kernel", False):
        return "pallas-whole"
    if getattr(jeng, "use_spectral_fdet", False):
        return "spectral"
    if jeng.use_loop_kernel:
        if getattr(jeng, "use_spectral", False):
            return "spectral"
        return "pallas-loop-ar" if jeng.noise.name == "ar" else "pallas-loop"
    if jeng.use_stats:
        return "xla"
    return "xla-direct" if jeng.design is not None else "xla-generic"


@pytest.mark.parametrize("extra,route", ROUTE_TABLE,
                         ids=[r + ":" + "-".join(f"{k}={v}"
                                                 for k, v in e.items())
                              for e, r in ROUTE_TABLE])
def test_route_table_matches_jax(extra, route, monkeypatch):
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    data = make_data(16)
    assert jax_route(jax_engine(data, extra)) == route
    monkeypatch.undo()
    opts = RunOptions({**BASE, **extra})
    eng = VBInference(get_model_class("poly")(opts), opts, data,
                      device="cpu")
    assert eng.route == route


def test_kernel_routes_count_no_launch_on_cpu():
    """On the CPU the fixed-design routes run the kernels' plain
    versions: no launch counter moves."""
    data = make_data(32)
    before = (tfw.fused_whole.launches, tfl.fused_vb_loop.launches,
              tfs.spectral_fused.launches)
    for extra in ({"noise-pattern": "12"}, {"engine-kernel": "pallas-loop"},
                  {"spectral-impl": "fused"}):
        port_engine(data, extra).run()
    assert before == (tfw.fused_whole.launches, tfl.fused_vb_loop.launches,
                      tfs.spectral_fused.launches)
