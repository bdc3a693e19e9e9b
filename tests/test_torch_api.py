"""The port's API, runner and CLI against the JAX package's, on the CPU:
run_with_data returns the same output keys with matching values, and
the CLI writes the same file set as the JAX CLI. Value tolerances are
those of tests/test_spectral.py scaled to each output (the JAX package
runs its XLA route here; the port its spectral route's plain torch).
method=nlls, continue-from-mvn (with continue-from-params), output-only
and the NLLS->VB workflow are held to the JAX API at float64 (1e-9 of
each output before the API's float32 cast, so 1e-6 relative after it)
and at float32 (the kernel routes: each test's stated bounds)."""

import os

import numpy as np
import pytest
import torch

from fabber_core_tpu import cli as jcli
from fabber_core_tpu.api import FabberTpu as JFabber
from fabber_core_tpu.io import nifti as jnifti
from fabber_core_tpu_torch import cli as tcli
from fabber_core_tpu_torch.api import FabberTpu
from fabber_core_tpu_torch.io import mvn, nifti

torch.set_num_threads(1)

OPTS = {"model": "poly", "degree": "2", "noise": "white", "method": "vb",
        "max-iterations": "10", "dtype": "single", "save-mean": True,
        "save-std": True, "save-var": True, "save-zstat": True,
        "save-noise-mean": True, "save-noise-std": True,
        "save-free-energy": True, "save-mvn": True,
        "save-model-fit": True, "save-residuals": True}


def phantom(shape=(6, 5, 4), nt=30, seed=0):
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    t = np.arange(1, nt + 1)
    data = (rng.uniform(-1, 1, (nv, 1)) + rng.uniform(-.05, .05, (nv, 1)) * t
            + 0.1 * rng.standard_normal((nv, nt)))
    return data.reshape(shape + (nt,), order="F").astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    vol = phantom()
    mask = np.ones(vol.shape[:3], np.float32)
    mask[0, 0, 0] = 0
    jr = JFabber().run_with_data(OPTS, {"data": vol}, mask=mask)
    tr = FabberTpu(device="cpu").run_with_data(OPTS, {"data": vol},
                                               mask=mask)
    return jr.data, tr.data, mask > 0


def test_run_with_data_keys_match_jax(runs):
    jd, td, _ = runs
    assert sorted(td) == sorted(jd)
    for key in jd:
        assert td[key].shape == jd[key].shape, key
        assert td[key].dtype == np.float32


def test_run_with_data_values_match_jax(runs):
    jd, td, m = runs
    for i in range(3):
        sd = jd[f"std_c{i}"][m]
        assert np.max(np.abs(td[f"mean_c{i}"][m] - jd[f"mean_c{i}"][m])
                      / sd) < 5e-3
        np.testing.assert_allclose(td[f"std_c{i}"], jd[f"std_c{i}"],
                                   rtol=1e-3)
        np.testing.assert_allclose(td[f"var_c{i}"], jd[f"var_c{i}"],
                                   rtol=2e-3)
        np.testing.assert_allclose(td[f"zstat_c{i}"][m],
                                   jd[f"zstat_c{i}"][m], atol=5e-3,
                                   rtol=5e-3)
    for key in ("noise_means", "noise_stdevs"):
        np.testing.assert_allclose(td[key], jd[key], rtol=1e-3)
    np.testing.assert_allclose(td["freeEnergy"], jd["freeEnergy"],
                               rtol=1e-3, atol=5e-3)
    scale = np.abs(jd["modelfit"]).max()
    for key in ("modelfit", "residuals"):
        np.testing.assert_allclose(td[key], jd[key], atol=1e-4 * scale)
    # the unmasked voxel is zero-filled in every output
    for key in td:
        assert not td[key][~m].any(), key


def test_final_mvn_matches_jax(runs):
    jd, td, m = runs
    jm, jc = mvn.unpack(jd["finalMVN"][m].T)
    tm, tc = mvn.unpack(td["finalMVN"][m].T)
    sd = np.sqrt(np.diagonal(jc, axis1=1, axis2=2))
    assert np.max(np.abs(tm - jm) / sd) < 5e-3
    np.testing.assert_allclose(tc, jc, rtol=2e-3, atol=1e-7)


def test_api_introspection():
    fab = FabberTpu(device="cpu")
    assert "poly" in fab.get_models()
    assert fab.get_methods() == JFabber().get_methods() == \
        ["vb", "spatialvb", "nlls"]
    assert fab.get_model_params({"model": "poly", "degree": "2"}) == \
        ["c0", "c1", "c2"]
    opts, _ = fab.get_options(method="vb")
    assert "max-iterations" in {o["name"] for o in opts}
    opts, desc = fab.get_options(method="nlls")
    jopts, jdesc = JFabber().get_options(method="nlls")
    assert [o["name"] for o in opts] == [o["name"] for o in jopts]
    assert desc == jdesc
    out = fab.model_evaluate({"model": "poly", "degree": "2"},
                             {"c0": 1.0, "c1": 2.0, "c2": 0.5}, 4)
    np.testing.assert_allclose(out, JFabber().model_evaluate(
        {"model": "poly", "degree": "2"},
        {"c0": 1.0, "c1": 2.0, "c2": 0.5}, 4))


@pytest.mark.parametrize("method,extra,what", [
    ("nlls", {"shard-voxels": True}, "shard-voxels"),
    ("spatialvb", {"distributed": True}, "distributed")],
    ids=["nlls", "spatialvb"])
def test_unported_methods_raise(method, extra, what):
    """The multi-device modes of every method (the runs themselves are
    ported: see the NLLS tests below, and the spatialvb one)."""
    with pytest.raises(NotImplementedError, match=what):
        FabberTpu(device="cpu").run_with_data(
            {**OPTS, "method": method, **extra},
            {"data": phantom((2, 2, 1))})


def test_spatialvb_run_matches_jax():
    """method=spatialvb (which used to raise) through run_with_data,
    with an M prior on c0, at float64 against the JAX API: every output
    within 1e-6 relative after the API's float32 cast."""
    opts = {**OPTS, "method": "spatialvb", "dtype": "double",
            "param-spatial-priors": "MNN", "max-iterations": "5"}
    vol = phantom((4, 3, 2), seed=5)
    tr = FabberTpu(device="cpu").run_with_data(opts, {"data": vol})
    jr = JFabber().run_with_data(opts, {"data": vol})
    assert sorted(tr.data) == sorted(jr.data)
    for key in jr.data:
        np.testing.assert_allclose(tr.data[key], jr.data[key], rtol=1e-6,
                                   atol=1e-6 * np.abs(jr.data[key]).max(),
                                   err_msg=key)


def test_api_cuda_without_card_raises(monkeypatch):
    from fabber_core_tpu_torch import FabberError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FabberError, match="cuda"):
        FabberTpu().run_with_data(OPTS, {"data": phantom((2, 2, 1))})


def test_cli_writes_same_files_as_jax(tmp_path):
    vol = phantom((4, 4, 2), nt=15, seed=3)
    data_f = str(tmp_path / "data.nii.gz")
    nifti.save(nifti.NiftiImage(vol), data_f)
    common = ["--model=poly", "--degree=2", "--method=vb", "--noise=white",
              "--dtype=single", f"--data={data_f}"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.execute(common + [f"--output={jout}"]) == 0
    assert tcli.execute(common + [f"--output={tout}", "--device=cpu"]) == 0
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    jmean = jnifti.load(os.path.join(jout, "mean_c0.nii.gz")).data
    tmean = nifti.load(os.path.join(tout, "mean_c0.nii.gz")).data
    jstd = jnifti.load(os.path.join(jout, "std_c0.nii.gz")).data
    assert tmean.shape == jmean.shape
    assert np.max(np.abs(tmean - jmean) / jstd) < 5e-3
    with open(os.path.join(tout, "paramnames.txt")) as f:
        assert f.read().split() == ["c0", "c1", "c2"]


def test_cli_fast_paths(capsys):
    assert tcli.execute(["--listmodels"]) == 0
    assert capsys.readouterr().out.split() == ["biexp", "exp", "linear",
                                               "poly"]
    assert tcli.execute(["--listparams", "--model=poly", "--degree=1"]) == 0
    assert capsys.readouterr().out.split() == ["c0", "c1"]
    assert tcli.execute(["--help"]) == 0
    assert "--device" in capsys.readouterr().out
    assert tcli.execute(["bad"]) == 1


def biexp_phantom(shape=(8, 4, 4), nt=40, dt=0.05, seed=1):
    """tests/test_fused_loop_nl.py's biexp data (rates 1 and 8, both
    amplitudes in [1, 2]) as a volume."""
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    t = np.arange(nt) * dt
    a1 = rng.uniform(1.0, 2.0, (nv, 1))
    a2 = rng.uniform(1.0, 2.0, (nv, 1))
    data = (a1 * np.exp(-t)[None] + a2 * np.exp(-8.0 * t)[None]
            + 0.02 * rng.standard_normal((nv, nt)))
    return data.reshape(shape + (nt,), order="F").astype(np.float32)


def test_run_with_data_biexp_fit_and_residuals_match_jax():
    """biexp end to end through run_with_data with save-model-fit and
    save-residuals: the port's whole-loop route (plain torch) against
    the JAX package's XLA route. The port's model fit is exactly the
    JAX model evaluated at the port's posterior means, and the
    residuals are the data minus it. Against the JAX run the fit is
    held in most voxels only: biexp's components are exchangeable and
    its fixed point ill-conditioned, so two implementations' float32
    runs settle different voxels in different basins (the JAX package's
    own routes agree on ~80% of this data, tests/test_fused_loop_nl.py);
    the bound is 70% of voxels within 1e-3."""
    vol = biexp_phantom()
    opts = {"model": "biexp", "dt": "0.05", "noise": "white",
            "method": "vb", "max-iterations": "20", "dtype": "single",
            "save-mean": True, "save-noise-mean": True,
            "save-model-fit": True, "save-residuals": True,
            "allow-bad-voxels": True}
    jd = JFabber().run_with_data(opts, {"data": vol}).data
    td = FabberTpu(device="cpu").run_with_data(opts, {"data": vol}).data
    assert sorted(td) == sorted(jd)
    for key in td:
        assert td[key].shape == jd[key].shape, key
        assert np.isfinite(td[key]).all(), key
    np.testing.assert_allclose(td["residuals"], vol - td["modelfit"],
                               atol=1e-6)
    names = ["amp1", "r1", "amp2", "r2"]
    jfab = JFabber()
    for idx in [(0, 0, 0), (3, 1, 2), (7, 3, 3), (5, 2, 0)]:
        ref = jfab.model_evaluate(
            opts, {n: float(td[f"mean_{n}"][idx]) for n in names}, 40)
        np.testing.assert_allclose(td["modelfit"][idx], ref, rtol=1e-5,
                                   atol=1e-6)
    err = np.abs(td["modelfit"] - jd["modelfit"]).max(axis=-1)
    assert np.mean(err < 1e-3) >= 0.7


@pytest.mark.parametrize("conv", ["trialmode", "freduce"])
def test_cli_detector_run_matches_jax(tmp_path, conv):
    """--convergence and its options reach the engine through the CLI:
    poly under an F-based detector (the spectral-whole route, the core
    kernel's detector mode) against the JAX CLI (its XLA stats route on
    the CPU)."""
    vol = phantom((4, 4, 2), nt=15, seed=4)
    data_f = str(tmp_path / "data.nii.gz")
    nifti.save(nifti.NiftiImage(vol), data_f)
    common = ["--model=poly", "--degree=2", "--method=vb", "--noise=white",
              "--dtype=single", f"--data={data_f}", f"--convergence={conv}",
              "--max-trials=3", "--min-fchange=0.1"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.execute(common + [f"--output={jout}"]) == 0
    assert tcli.execute(common + [f"--output={tout}", "--device=cpu"]) == 0
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    jmean = jnifti.load(os.path.join(jout, "mean_c0.nii.gz")).data
    tmean = nifti.load(os.path.join(tout, "mean_c0.nii.gz")).data
    jstd = jnifti.load(os.path.join(jout, "std_c0.nii.gz")).data
    assert np.max(np.abs(tmean - jmean) / jstd) < 5e-3


def test_run_with_data_biexp_trialmode_matches_jax():
    """biexp under trialmode through run_with_data: the whole-loop
    route's detector mode (plain torch) against the JAX package's
    whole-loop kernel (interpreted), at a short horizon (biexp's float32
    fixed point is chaotic further out), held as the maxits biexp run
    above: 70% of voxels' fits within 1e-3."""
    vol = biexp_phantom(seed=2)
    opts = {"model": "biexp", "dt": "0.05", "noise": "white",
            "method": "vb", "dtype": "single", "convergence": "trialmode",
            "engine-kernel": "pallas-loop", "max-iterations": "3",
            "max-trials": "2", "save-mean": True,
            "save-noise-mean": True, "save-model-fit": True,
            "allow-bad-voxels": True}
    jd = JFabber().run_with_data(opts, {"data": vol}).data
    td = FabberTpu(device="cpu").run_with_data(opts, {"data": vol}).data
    assert sorted(td) == sorted(jd)
    err = np.abs(td["modelfit"] - jd["modelfit"]).max(axis=-1)
    assert np.mean(err < 1e-3) >= 0.7
    np.testing.assert_allclose(np.median(td["noise_means"]),
                               np.median(jd["noise_means"]), rtol=2e-2)


@pytest.mark.parametrize("extra", [
    [], ["--noise-pattern=12"], ["--model=linear", "--basis=BASIS"]],
    ids=["poly", "poly-pattern", "linear"])
def test_cli_default_dtype_matches_jax(tmp_path, extra):
    """The CLI at its default dtype (double: the statistics route in
    plain torch) writes the JAX CLI's file set and values, to 1e-9
    posterior sd."""
    vol = phantom((4, 4, 2), nt=15, seed=4)
    data_f = str(tmp_path / "data.nii.gz")
    nifti.save(nifti.NiftiImage(vol), data_f)
    if "--basis=BASIS" in extra:
        from fabber_core_tpu_torch.io import matfile
        basis = str(tmp_path / "basis.mat")
        t = np.arange(15) / 15
        matfile.write_vest(np.stack([np.ones(15), t, np.cos(np.pi * t)],
                                    axis=1), basis)
        extra = ["--model=linear", f"--basis={basis}"]
        names = ["Parameter_1", "Parameter_2", "Parameter_3"]
    else:
        extra = ["--model=poly", "--degree=2"] + extra
        names = ["c0", "c1", "c2"]
    common = extra + ["--method=vb", "--noise=white", f"--data={data_f}",
                      "--save-noise-mean"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.execute(common + [f"--output={jout}"]) == 0
    assert tcli.execute(common + [f"--output={tout}", "--device=cpu"]) == 0
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    for name in names:
        jmean = jnifti.load(os.path.join(jout, f"mean_{name}.nii.gz")).data
        tmean = nifti.load(os.path.join(tout, f"mean_{name}.nii.gz")).data
        jstd = jnifti.load(os.path.join(jout, f"std_{name}.nii.gz")).data
        assert np.max(np.abs(tmean - jmean) / jstd) < 1e-9
    jn = jnifti.load(os.path.join(jout, "noise_means.nii.gz")).data
    tn = nifti.load(os.path.join(tout, "noise_means.nii.gz")).data
    np.testing.assert_allclose(tn, jn, rtol=1e-9)


# -- method=nlls, continue-from-mvn, output-only -----------------------------

NLLS_SAVE = {"save-mean": True, "save-std": True, "save-mvn": True,
             "save-model-fit": True, "save-residuals": True}


def assert_outputs_match(td, jd, rtol=1e-6):
    """Same keys and shapes, values within rtol of each output's max
    (both sides float32 after the API's cast)."""
    assert sorted(td) == sorted(jd)
    for key in jd:
        assert td[key].shape == jd[key].shape, key
        scale = max(float(np.abs(jd[key]).max()), 1e-30)
        assert np.abs(td[key] - jd[key]).max() <= rtol * scale, key


@pytest.mark.parametrize("opts", [
    {"model": "poly", "degree": "2", "dtype": "double", "lm": True},
    {"model": "exp", "dt": "0.05", "dtype": "double"}],
    ids=["poly-stats-lm", "exp-generic"])
def test_run_with_data_nlls_matches_jax(opts):
    """method=nlls through run_with_data at float64: the fixed-design
    and the generic route."""
    if opts["model"] == "poly":
        vol = phantom((4, 4, 2), nt=20, seed=5)
    else:
        vol = biexp_phantom((4, 2, 2), nt=20, seed=5)
    o = {**opts, "method": "nlls", **NLLS_SAVE}
    jd = JFabber().run_with_data(o, {"data": vol}).data
    run = FabberTpu(device="cpu").run_with_data(o, {"data": vol})
    assert_outputs_match(run.data, jd)
    assert "NLLS::Engine route" in run.log


def test_run_with_data_nlls_kernel_route_matches_jax():
    """method=nlls at float32 on the kernel route (the plain version
    here) against the JAX kernel interpreted: outputs within the kernel
    bounds of tests/test_nlls_stats.py (means 2e-3 of their scale)."""
    vol = biexp_phantom((4, 4, 2), nt=30, seed=6)[..., :30]
    o = {"model": "exp", "dt": "0.05", "dtype": "single", "method": "nlls",
         **NLLS_SAVE}
    jd = JFabber().run_with_data({**o, "engine-kernel": "pallas-loop"},
                                 {"data": vol}).data
    run = FabberTpu(device="cpu").run_with_data(o, {"data": vol})
    assert "whole-loop nonlinear NLLS kernel" in run.log
    assert_outputs_match(run.data, jd, rtol=2e-3)


def test_continue_from_mvn_and_output_only_match_jax(tmp_path):
    """A VB run continued from an MVN whose parameters are named by
    continue-from-params (reordered, one unknown name, one parameter
    missing: merged by name), and output-only from the same MVN, at
    float64 against the JAX API."""
    vol = phantom((4, 4, 2), nt=20, seed=7)
    base = {"model": "poly", "degree": "2", "noise": "white",
            "method": "vb", "dtype": "double", "save-mean": True,
            "save-std": True, "save-noise-mean": True, "save-mvn": True}
    jfab, tfab = JFabber(), FabberTpu(device="cpu")
    first = jfab.run_with_data({**base, "max-iterations": "2"},
                               {"data": vol}).data["finalMVN"]
    # the file's parameters: c2, c0, a name the model lacks (the noise
    # block follows); c1 is missing and takes the model default
    means, cov = mvn.unpack(first.reshape(-1, first.shape[-1], order="F").T)
    perm = [2, 0, 1, 3]
    means, cov = means[:, perm], cov[:, perm][:, :, perm]
    mvn_vol = mvn.pack(means, cov).T.reshape(first.shape, order="F")
    pfile = str(tmp_path / "params.txt")
    with open(pfile, "w") as f:
        f.write("c2\nc0\nunknown\n")
    data = {"data": vol, "continue-from-mvn": mvn_vol}
    for extra in ({"max-iterations": "3"}, {"output-only": True}):
        o = {**base, **extra, "continue-from-params": pfile}
        jd = jfab.run_with_data(o, data).data
        run = tfab.run_with_data(o, data)
        assert_outputs_match(run.data, jd)
    assert "output-only set" in run.log
    with pytest.raises(Exception, match="continue-from-mvn"):
        tfab.run_with_data({**base, "output-only": True}, {"data": vol})


def flow_phantom(shape=(4, 4, 2), nt=100, dt=0.02, noise=0.05, seed=0):
    """tests/test_flows.py's biexp phantom (a1 ~ U(0.8, 1.2), second
    component 0.5 a1 at rate 5) as float32, and a1."""
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    t = np.arange(nt) * dt
    a1 = rng.uniform(0.8, 1.2, nv)
    data = (a1[:, None] * np.exp(-1.0 * t)[None, :]
            + 0.5 * a1[:, None] * np.exp(-5.0 * t)[None, :]
            + rng.normal(0, noise, (nv, nt)))
    return (data.reshape(shape + (nt,), order="F").astype(np.float32),
            a1.reshape(shape, order="F"))


def nlls_then_vb(fab, vol, pfile, dtype, vb_extra=None, nlls_extra=None):
    """tests/test_flows.py's NLLS->VB workflow: method=nlls with
    save-mvn, then VB (trialmode) continued from its finalMVN, merged by
    name."""
    base = {"model": "biexp", "dt": "0.02", "noise": "white",
            "dtype": dtype}
    nlls = fab.run_with_data({
        **base, "method": "nlls", "vb-init": True, "save-mvn": True,
        "save-mean": True, **(nlls_extra or {})}, {"data": vol})
    vb = fab.run_with_data({
        **base, "method": "vb", "convergence": "trialmode",
        "max-iterations": "30", "save-mean": True, "save-noise-mean": True,
        "save-mvn": True, "continue-from-params": pfile,
        **(vb_extra or {})},
        {"data": vol, "continue-from-mvn": nlls.data["finalMVN"]})
    return nlls, vb


def test_nlls_then_vb_flow_matches_jax(tmp_path):
    """The workflow at float64 (both packages' generic routes) against
    the JAX API, every output; at float32 on the port's kernel routes
    (the NLLS kernel, then kernel 7 per iteration: the JAX gates' routes
    for a continued run), held to tests/test_flows.py's bounds (total
    amplitude within 0.25 of 1.5 a1 everywhere, 0.08 on average; NLLS
    0.2 on average)."""
    vol, a1 = flow_phantom()
    pfile = str(tmp_path / "params.txt")
    with open(pfile, "w") as f:
        f.write("amp1\nr1\namp2\nr2\n")
    jn, jv = nlls_then_vb(JFabber(), vol, pfile, "double")
    tn, tv = nlls_then_vb(FabberTpu(device="cpu"), vol, pfile, "double")
    assert_outputs_match(tn.data, jn.data)
    assert_outputs_match(tv.data, jv.data)
    assert "no noise block" in tv.log

    tn, tv = nlls_then_vb(FabberTpu(device="cpu"), vol, pfile, "single")
    assert "whole-loop nonlinear NLLS kernel" in tn.log
    assert "per-iteration fused kernel" in tv.log
    total = tv.data["mean_amp1"] + tv.data["mean_amp2"]
    np.testing.assert_allclose(total, 1.5 * a1, atol=0.25)
    assert np.abs(total - 1.5 * a1).mean() < 0.08
    total_nlls = tn.data["mean_amp1"] + tn.data["mean_amp2"]
    assert np.abs(total_nlls - 1.5 * a1).mean() < 0.2
