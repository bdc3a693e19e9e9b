"""The port's engine under AR(1) noise against the JAX engine on the same
data (numpy, one seed):

  xla             float64, to 1e-9 (means in posterior sd, the rest
                  relative to each output's max): one and two echoes,
                  cross terms dual, under pointzeroone, trialmode and lm;
  pallas-loop-ar  float32 (kernel 9's plain version) against the JAX
                  engine's engine-kernel=pallas-loop (its kernel
                  interpreted) under pointzeroone and freduce: iteration
                  counts equal except near-threshold lanes (at most 1
                  apart, on < 2% of lanes: tests/test_fused_loop_ar.py),
                  the other lanes at that file's bounds;
  xla-generic     float64 to 1e-9: exp with AR noise, and poly with
                  fixed-design-route=direct (the JAX engine drops the
                  design for a statistics-only noise model);
  continuation    a programmatic continuation of an AR run (the kernel
                  route steps aside to xla); noise prior and initial
                  posterior from an MVN matrix file;
  API and CLI     run_with_data and the CLI with --noise=ar
                  --num-echoes=2 at float64 against the JAX API and CLI,
                  finalMVN's noise block of A+Q columns, continue-from-mvn
                  through state_from_mvn, and the CLI's option listing.
"""

import os

import numpy as np
import pytest
import torch

from fabber_core_tpu import cli as jcli
from fabber_core_tpu.api import FabberTpu as JFabber
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.io import nifti as jnifti
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch import cli as tcli
from fabber_core_tpu_torch.api import FabberTpu
from fabber_core_tpu_torch.inference.vb import ROUTES, VBInference
from fabber_core_tpu_torch.io import mvn, nifti
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.noise.ar1 import Ar1NoiseState
from fabber_core_tpu_torch.options import RunOptions

torch.set_num_threads(1)

BASE = {"model": "poly", "degree": "1", "noise": "ar",
        "max-iterations": "10", "print-free-energy": True}


def make_data(nv, nt=30, seed=0, nphis=1, scale=True):
    """A linear trend plus AR(1) noise (alpha 0.4) per echo, its sd
    log-uniform over 1e-2..1 per voxel so detector lanes stop apart."""
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1)
    e = rng.standard_normal((nv, nt))
    for k in range(nphis, nt):
        e[:, k] += 0.4 * e[:, k - nphis]
    sd = 10.0 ** rng.uniform(-2, 0, (nv, 1)) if scale else 0.1
    return (rng.uniform(-1, 1, (nv, 1)) + rng.uniform(-0.05, 0.05, (nv, 1))
            * t + sd * e).astype(np.float32)


def engines(data, extra, jextra=None, model="poly"):
    opts = {**BASE, "model": model, **extra}
    jo = JOptions({**opts, **(jextra or {})})
    nv = data.shape[0]
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    to = RunOptions(opts)
    return (JVB(jmodel(model)(jo), jo, data, coords),
            VBInference(get_model_class(model)(to), to, data, device="cpu"))


def assert_f64_match(rx, rp):
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < 1e-9
    for f in ("cov", "noise_means", "noise_cov", "free_energy"):
        a, b = getattr(rx, f), getattr(rp, f)
        assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max(), f
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


XLA_CASES = [{}, {"num-echoes": "2"},
             {"num-echoes": "2", "ar1-cross-terms": "dual"},
             {"convergence": "pointzeroone", "max-iterations": "20"},
             {"convergence": "trialmode", "num-echoes": "2",
              "ar1-cross-terms": "same"},
             {"convergence": "lm"}]


@pytest.mark.parametrize("extra", XLA_CASES,
                         ids=["-".join(f"{k}={v}" for k, v in e.items())
                              or "default" for e in XLA_CASES])
def test_xla_route_f64_matches_jax(extra):
    data = make_data(48, seed=1).astype(np.float64)
    jeng, eng = engines(data, {**extra, "dtype": "double"})
    assert jeng.route_description() == \
        "fixed-design sufficient-statistics route (XLA)"
    assert eng.route == "xla"
    rp = eng.run()
    assert_f64_match(jeng.run(), rp)
    if "convergence" in extra:
        assert len(np.unique(rp.iterations)) > 1   # lanes stop apart


def cut(r, keep):
    return r._replace(**{f: getattr(r, f)[keep] for f in (
        "means", "cov", "noise_means", "noise_cov", "free_energy",
        "iterations", "bad_voxels")})


def assert_f32_match(rx, rp):
    """tests/test_fused_loop_ar.py:37-55 and its detector rule."""
    diff = np.abs(rx.iterations - rp.iterations)
    assert diff.max() <= 1 and (diff != 0).mean() < 0.02, diff
    rx, rp = cut(rx, diff == 0), cut(rp, diff == 0)
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < 5e-3
    np.testing.assert_allclose(rx.cov, rp.cov, rtol=8e-4, atol=1e-7)
    np.testing.assert_allclose(rx.noise_means, rp.noise_means, rtol=5e-4,
                               atol=5e-6)
    np.testing.assert_allclose(rx.noise_cov, rp.noise_cov, rtol=5e-4,
                               atol=5e-6)
    np.testing.assert_allclose(rx.free_energy, rp.free_energy, rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_array_equal(rx.bad_voxels, rp.bad_voxels)


@pytest.mark.parametrize("extra", [
    {"convergence": "pointzeroone"},
    {"convergence": "freduce", "num-echoes": "2"}],
    ids=["pointzeroone", "freduce-echoes2"])
def test_kernel_route_detectors_match_jax(extra):
    """pallas-loop-ar's in-kernel detector (the plain version here)
    against the JAX AR(1) kernel's, interpreted."""
    extra = {**extra, "max-iterations": "20", "dtype": "single"}
    jeng, eng = engines(make_data(200, scale=False), extra,
                        {"engine-kernel": "pallas-loop"})
    assert jeng.use_loop_kernel and jeng.ar_loop_fdet == extra["convergence"]
    assert eng.route == "pallas-loop-ar"
    assert f"in-kernel {extra['convergence']} detector" \
        in eng.route_description()
    rp = eng.run()
    assert_f32_match(jeng.run(), rp)
    assert len(np.unique(rp.iterations)) > 1


@pytest.mark.parametrize("model,extra", [
    ("exp", {"dt": "0.1", "num-echoes": "2"}),
    ("poly", {"fixed-design-route": "direct", "degree": "2"})],
    ids=["exp", "poly-direct"])
def test_generic_route_f64_matches_jax(model, extra):
    """AR noise on the generic-Jacobian route: a nonlinear model, and a
    fixed-design one with fixed-design-route=direct (AR has no direct
    design route, so both engines drop the design)."""
    rng = np.random.default_rng(3)
    nv, nt = 32, 30
    if model == "exp":
        t = np.arange(nt) * 0.1
        e = rng.standard_normal((nv, nt))
        for k in range(2, nt):
            e[:, k] += 0.4 * e[:, k - 2]
        data = (rng.uniform(1, 2, (nv, 1))
                * np.exp(-rng.uniform(0.5, 2, (nv, 1)) * t) + 0.05 * e)
    else:
        data = make_data(nv, seed=3).astype(np.float64)
    jeng, eng = engines(data, {**extra, "dtype": "double"}, model=model)
    assert jeng.route_description() == "generic-Jacobian XLA route"
    assert eng.route == "xla-generic" and eng.design is None
    assert_f64_match(jeng.run(), eng.run())


def test_continuation_of_an_ar_run_matches_jax():
    """run(continue_means, continue_cov, continue_noise) after an AR run:
    the kernel route's engine continues on 'xla', as the JAX engine's
    does (its kernel starts from the model default)."""
    data = make_data(64, seed=4)
    jbase, _ = engines(data, {"dtype": "single"},
                       {"engine-kernel": "xla"})
    base = jbase.run()
    cm, cc = base.means + 0.1, base.cov
    jeng, eng = engines(data, {"dtype": "single", "max-iterations": "2"},
                        {"engine-kernel": "xla"})
    cn_j = jeng.noise.state_from_mvn(base.noise_means, base.noise_cov)
    cn_t = eng.noise.state_from_mvn(base.noise_means, base.noise_cov)
    assert isinstance(cn_t, Ar1NoiseState)
    assert eng.route == "pallas-loop-ar"
    assert eng.continuation_route() == "xla"
    rp = eng.run(continue_means=cm, continue_cov=cc, continue_noise=cn_t)
    assert eng.route == "pallas-loop-ar"
    assert_f32_match(jeng.run(continue_means=cm, continue_cov=cc,
                              continue_noise=cn_j), rp)


@pytest.mark.parametrize("key", ["noise-initial-prior",
                                 "noise-initial-posterior"])
def test_noise_dists_from_file_match_jax(key, tmp_path):
    """One AR noise MVN (two alphas, then phi) from a matrix file for
    every voxel: the engine builds an Ar1NoiseState from it; float64, the
    statistics route, against the JAX engine."""
    path = str(tmp_path / "noise.mtx")
    mvn.save_matrix([0.2, 0.0, 50.0], np.diag([0.5, 0.5, 1e4]), path)
    data = make_data(32, seed=6).astype(np.float64)
    jeng, eng = engines(data, {key: path, "dtype": "double"})
    assert eng.route == "xla"
    rp = eng.run()
    assert isinstance(eng.noise_prior, Ar1NoiseState)
    assert_f64_match(jeng.run(), rp)


AR_ROUTES = {"pallas-loop-ar", "xla", "xla-generic"}


@pytest.mark.parametrize("extra", [
    {}, {"engine-kernel": "pallas-loop"}, {"engine-kernel": "pallas-whole"},
    {"engine-kernel": "spectral-whole"}, {"engine-kernel": "spectral"},
    {"engine-kernel": "pallas"}, {"spectral-impl": "fused"},
    {"spectral-impl": "xstats"}, {"convergence": "trialmode"},
    {"dtype": "bf16"}, {"fixed-design-route": "direct"}],
    ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()) or "auto")
def test_ar_runs_take_no_white_route(extra):
    """Every engine-kernel, spectral-impl and detector with AR noise at
    float32 lands on an AR route: the white-noise gates check the noise
    model before reading its white-only attributes."""
    opts = RunOptions({**BASE, "dtype": "single", **extra})
    eng = VBInference(get_model_class("poly")(opts), opts,
                      make_data(8), device="cpu")
    assert eng.route in AR_ROUTES
    assert eng.route in ROUTES


def ar_volume(shape=(4, 3, 2), nt=24, seed=5):
    data = make_data(int(np.prod(shape)), nt=nt, seed=seed, nphis=2)
    return data.reshape(shape + (nt,), order="F")


SAVE = {"save-mean": True, "save-std": True, "save-noise-mean": True,
        "save-noise-std": True, "save-free-energy": True, "save-mvn": True,
        "save-model-fit": True}


def test_run_with_data_matches_jax():
    """run_with_data with noise=ar, num-echoes=2 at float64: every output
    within 1e-6 of its max of the JAX API's (both cast to float32);
    finalMVN carries P + A + Q rows of means; continue-from-mvn of it
    goes through the AR state_from_mvn."""
    vol = ar_volume()
    o = {**BASE, "method": "vb", "num-echoes": "2", "dtype": "double",
         **SAVE}
    jd = JFabber().run_with_data(o, {"data": vol}).data
    run = FabberTpu(device="cpu").run_with_data(o, {"data": vol})
    td = run.data
    assert sorted(td) == sorted(jd)
    for key in jd:
        assert td[key].shape == jd[key].shape, key
        scale = max(float(np.abs(jd[key]).max()), 1e-30)
        assert np.abs(td[key] - jd[key]).max() <= 1e-6 * scale, key
    nv = int(np.prod(vol.shape[:3]))
    assert td["noise_means"].reshape(nv, -1).shape[1] == 2 + 2
    means, _ = mvn.unpack(np.asarray(td["finalMVN"]).reshape(nv, -1).T)
    assert means.shape[1] == 2 + 2 + 2
    c = {**o, "max-iterations": "2"}
    jc = JFabber().run_with_data(c, {"data": vol,
                                     "continue-from-mvn": jd["finalMVN"]})
    tc = FabberTpu(device="cpu").run_with_data(
        c, {"data": vol, "continue-from-mvn": td["finalMVN"]})
    for key in ("mean_c0", "noise_means", "freeEnergy"):
        scale = float(np.abs(jc.data[key]).max())
        assert np.abs(tc.data[key] - jc.data[key]).max() <= 1e-6 * scale


def test_cli_ar_run_matches_jax(tmp_path, capsys):
    """The CLI with --noise=ar --num-echoes=2 (its default dtype,
    double) writes the JAX CLI's file set and values; --help
    --method=vb lists the AR options."""
    vol = ar_volume((4, 4, 2))
    data_f = str(tmp_path / "data.nii.gz")
    nifti.save(nifti.NiftiImage(vol), data_f)
    common = ["--model=poly", "--degree=1", "--method=vb", "--noise=ar",
              "--num-echoes=2", f"--data={data_f}", "--save-noise-mean",
              "--save-mvn"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.execute(common + [f"--output={jout}"]) == 0
    assert tcli.execute(common + [f"--output={tout}", "--device=cpu"]) == 0
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    for name in ("mean_c0", "mean_c1", "noise_means"):
        j = jnifti.load(os.path.join(jout, f"{name}.nii.gz")).data
        t = nifti.load(os.path.join(tout, f"{name}.nii.gz")).data
        assert np.abs(t - j).max() <= 1e-6 * np.abs(j).max(), name
    capsys.readouterr()
    assert tcli.execute(["--help", "--method=vb"]) == 0
    out = capsys.readouterr().out
    assert "--num-echoes" in out and "--ar1-cross-terms" in out
