"""The port's spatial VB (inference/spatial.py, plain torch on the CPU)
against the JAX package's SpatialVBInference on the same data: the
neighbour graph, each spatial prior type M/m/P/p in the Jacobi sweep
with the dense stencil and with the gather, mixes with N and ARD, the
P=4 linear model and a nonlinear model on the generic route, and the
runner, API and CLI surfaces of method=spatialvb.

Tolerances: at float64 the oracle level (README "Validation"): means,
covariances, noise, F, final aK and coefficient resels within 1e-9
relative (means in posterior sd); at float32 those of
tests/test_torch_engine.py (means 5e-3 posterior sd, cov rtol 2e-3,
noise rtol 1e-3, F rtol 1e-3 / atol 5e-3), aK rtol 1e-3. Each JAX run is
made once per configuration, in module-scoped fixtures.
"""

import numpy as np
import pytest
import torch

from fabber_core_tpu.core.neighbours import calc_neighbours as jneigh
from fabber_core_tpu.inference.spatial import SpatialVBInference as JSVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.core.neighbours import (calc_neighbours,
                                                   check_coords_ordered)
from fabber_core_tpu_torch.exceptions import FabberError
from fabber_core_tpu_torch.inference.spatial import SpatialVBInference
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.io import matfile
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.options import RunOptions

torch.set_num_threads(1)


def grid_coords(nx, ny, nz):
    """x-fastest (z-major) coordinates, as VolumeGeometry orders them."""
    return np.array([[x, y, z] for z in range(nz) for y in range(ny)
                     for x in range(nx)], float)


def neigh_set(neigh, v):
    return {int(i) for i in neigh[v] if i >= 0}


# -- the neighbour graph -----------------------------------------------------

def both_graphs(coords, dims):
    ours = calc_neighbours(coords, dims)
    for a, b in zip(ours, jneigh(coords, dims)):
        np.testing.assert_array_equal(a, b)
    return ours


def test_neighbours_line():
    neigh, neigh2 = both_graphs(grid_coords(5, 1, 1), 1)
    assert neigh_set(neigh, 0) == {1}
    assert neigh_set(neigh, 2) == {1, 3}
    assert neigh_set(neigh, 4) == {3}
    assert sorted(i for i in neigh2[2] if i >= 0) == [0, 4]


def test_neighbours_cube():
    neigh, neigh2 = both_graphs(grid_coords(3, 3, 3), 3)
    assert neigh_set(neigh, 13) == {12, 14, 10, 16, 4, 22}
    assert neigh_set(neigh, 0) == {1, 3, 9}
    n2 = [int(i) for i in neigh2[0] if i >= 0]
    assert n2.count(4) == 2 and n2.count(10) == 2   # two paths each


def test_neighbours_irregular_mask():
    coords = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], float)
    neigh, _ = both_graphs(coords, 2)
    assert [neigh_set(neigh, v) for v in range(3)] == [{1, 2}, {0}, {0}]


def test_neighbours_no_wraparound():
    neigh, _ = both_graphs(grid_coords(3, 2, 1), 2)
    assert neigh_set(neigh, 2) == {1, 5}


def test_neighbours_misordered_coords_refused():
    coords = np.array([[1, 0, 0], [0, 0, 0]], float)
    with pytest.raises(FabberError, match="mis-ordered"):
        check_coords_ordered(coords)
    with pytest.raises(FabberError):
        calc_neighbours(coords)


# -- the Jacobi sweep against the JAX package ---------------------------------

def poly_volume(coords, nt=12, seed=0, noise=0.05):
    """poly degree 1 with a truth that varies smoothly over x and y."""
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1, dtype=float)
    truth = 1.0 + 0.1 * coords[:, 0] - 0.05 * coords[:, 1]
    return (truth[:, None] * (1.0 + 0.02 * t[None, :])
            + noise * rng.standard_normal((len(coords), nt)))


def run_pair(opts, data, coords, model="poly", getter=None):
    """(JAX engine, its result, port engine, its result)."""
    jo = JOptions(opts)
    je = JSVB(jmodel(model)(jo), jo, data, coords, voxel_data_getter=getter)
    rx = je.run()
    po = RunOptions(opts)
    pe = SpatialVBInference(get_model_class(model)(po), po, data,
                            voxel_data_getter=getter, device="cpu",
                            coords=coords)
    return je, rx, pe, pe.run()


def assert_f64(je, rx, pe, rp, rtol=1e-9):
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < rtol
    np.testing.assert_allclose(rp.cov, rx.cov, rtol=rtol,
                               atol=rtol * np.abs(rx.cov).max())
    np.testing.assert_allclose(rp.noise_means, rx.noise_means, rtol=rtol)
    if rx.free_energy is not None:
        np.testing.assert_allclose(rp.free_energy, rx.free_energy,
                                   rtol=rtol,
                                   atol=rtol * np.abs(rx.free_energy).max())
    np.testing.assert_allclose(pe.final_ak, je.final_ak, rtol=rtol)
    np.testing.assert_allclose(pe.coefficient_resels, je.coefficient_resels,
                               rtol=rtol, atol=rtol)
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


def assert_f32(je, rx, pe, rp):
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / sd) < 5e-3
    np.testing.assert_allclose(rp.cov, rx.cov, rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(rp.noise_means, rx.noise_means, rtol=1e-3)
    np.testing.assert_allclose(rp.free_energy, rx.free_energy, rtol=1e-3,
                               atol=5e-3)
    np.testing.assert_allclose(pe.final_ak, je.final_ak, rtol=1e-3)
    np.testing.assert_allclose(pe.coefficient_resels, je.coefficient_resels,
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


PRIOR_CASES = [(t, dt, st) for t in "MmPp"
               for dt, st in (("double", "dense"), ("single", "gather"))]


@pytest.fixture(scope="module", params=PRIOR_CASES,
                ids=[f"{t}-{dt}-{st}" for t, dt, st in PRIOR_CASES])
def prior_case(request):
    tcode, dtype, stencil = request.param
    coords = grid_coords(6, 5, 3)
    data = poly_volume(coords)
    if dtype == "single":
        data = data.astype(np.float32)
    opts = {"model": "poly", "degree": "1", "noise": "white",
            "method": "spatialvb", "max-iterations": "5",
            "param-spatial-priors": tcode * 2, "dtype": dtype,
            "spatial-stencil": stencil, "print-free-energy": True}
    return request.param, run_pair(opts, data, coords)


def test_each_prior_type_matches_jax(prior_case):
    """Each spatial prior type on both parameters, at float64 with the
    dense stencil and at float32 with the gather: every output, aK and
    the coefficient resels against the JAX package's same stencil."""
    (tcode, dtype, stencil), (je, rx, pe, rp) = prior_case
    assert pe.route == "spatial"
    assert pe.route_description() == je.route_description()
    assert (pe._dense is not None) == (stencil == "dense")
    (assert_f64 if dtype == "double" else assert_f32)(je, rx, pe, rp)
    assert np.all(pe.final_ak > 0) and np.isfinite(pe.final_ak).all()


@pytest.mark.parametrize("tcode", ["M", "P"])
def test_dense_and_gather_on_an_irregular_mask(tcode):
    """An irregular mask (a quarter of a 7x6 grid removed): the dense
    stencil goes through the grid's inverse permutation. Each stencil
    against the JAX package's same stencil at float64, and the two
    against each other."""
    rng = np.random.default_rng(23)
    keep = rng.random(42) > 0.25
    coords = grid_coords(7, 6, 1)[keep]
    data = 3.0 + rng.normal(0, 0.4, (len(coords), 8))
    base = {"model": "poly", "degree": "0", "noise": "white",
            "method": "spatialvb", "param-spatial-priors": tcode,
            "spatial-dims": "2", "max-iterations": "5",
            "print-free-energy": True}
    res = {}
    for stencil in ("dense", "gather"):
        je, rx, pe, rp = run_pair({**base, "spatial-stencil": stencil},
                                  data, coords)
        assert_f64(je, rx, pe, rp)
        res[stencil] = rp
    np.testing.assert_allclose(res["dense"].means, res["gather"].means,
                               rtol=1e-9)


def test_all_n_priors_equal_voxelwise():
    """method=spatialvb with all-N priors (the reference's golden
    outdata_linear_spatialvb run) is voxelwise VB: no coupling, the same
    updates and sweep count."""
    coords = grid_coords(6, 5, 1)
    data = poly_volume(coords, nt=20, seed=4, noise=0.3)
    base = {"model": "poly", "degree": "1", "noise": "white",
            "max-iterations": "10", "print-free-energy": True}
    so = RunOptions({**base, "method": "spatialvb",
                     "param-spatial-priors": "N+", "spatial-dims": "2"})
    se = SpatialVBInference(get_model_class("poly")(so), so, data,
                            device="cpu", coords=coords)
    assert se.spatial_params == []
    rs = se.run()
    vo = RunOptions(base)
    ve = VBInference(get_model_class("poly")(vo), vo, data, device="cpu")
    assert ve.route == "xla"
    rv = ve.run()
    np.testing.assert_allclose(rs.means, rv.means, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(rs.noise_means, rv.noise_means, rtol=1e-12)
    np.testing.assert_allclose(rs.free_energy, rv.free_energy, rtol=1e-12)


def test_mmnn_linear_p4_matches_jax(tmp_path):
    """bench.py's spatial-p4 shape at small size: the linear model,
    P=4, spatial (M) priors on two parameters and N on two."""
    rng = np.random.default_rng(8)
    nx, ny, nt = 8, 8, 40
    t = np.arange(nt, dtype=float)
    design = np.stack([np.ones(nt), t / nt, np.sin(t / 3.0),
                       np.cos(t / 3.0)], axis=1)
    path = str(tmp_path / "design.mat")
    matfile.write_vest(design, path)
    coords = grid_coords(nx, ny, 1)
    xs, ys = coords[:, 0] / nx, coords[:, 1] / ny
    truth = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * xs),
                      0.5 * np.cos(2 * np.pi * ys),
                      rng.uniform(-1, 1, nx * ny),
                      rng.uniform(-1, 1, nx * ny)], axis=1)
    data = truth @ design.T + rng.normal(0, 0.05, (nx * ny, nt))
    opts = {"model": "linear", "basis": path, "noise": "white",
            "method": "spatialvb", "param-spatial-priors": "MMNN",
            "spatial-dims": "2", "max-iterations": "6",
            "print-free-energy": True}
    je, rx, pe, rp = run_pair(opts, data, coords, model="linear")
    assert [p.prior_type for p in pe.params] == ["M", "M", "N", "N"]
    assert_f64(je, rx, pe, rp)
    assert np.all(np.abs(rp.means - truth).mean(axis=0) < 0.05)


def test_nonlinear_generic_route_matches_jax():
    """exp with an M prior on its amplitude: the generic route
    (linearize, then the noise model's updates) in the sweep."""
    coords = grid_coords(6, 5, 1)
    rng = np.random.default_rng(2)
    tt = np.arange(20) * 0.1
    amp = 1.0 + 0.05 * coords[:, 0]
    data = (amp[:, None] * np.exp(-0.8 * tt[None, :])
            + 0.02 * rng.standard_normal((len(coords), 20)))
    opts = {"model": "exp", "dt": "0.1", "noise": "white",
            "method": "spatialvb", "max-iterations": "5",
            "param-spatial-priors": "MN", "print-free-energy": True}
    je, rx, pe, rp = run_pair(opts, data, coords, model="exp")
    assert not pe.use_stats and pe.design is None
    assert_f64(je, rx, pe, rp)


def test_ard_in_spatial_mode_sums_prior_f():
    """An ARD prior beside an M prior: spatial mode sums the priors' F
    terms (inference_vb.cc:630) where voxelwise mode keeps the last
    parameter's, and ARD's variance is the model default at sweep 0."""
    coords = grid_coords(5, 4, 2)
    data = poly_volume(coords, seed=6)
    opts = {"model": "poly", "degree": "1", "noise": "white",
            "method": "spatialvb", "max-iterations": "4",
            "param-spatial-priors": "AM", "print-free-energy": True}
    je, rx, pe, rp = run_pair(opts, data, coords)
    assert pe.prior_setup.has_ard
    assert_f64(je, rx, pe, rp)


def test_spatial_smooths_estimates():
    """Spatial smoothing shrinks the scatter of a constant signal under
    heavy noise and shrinks its posterior sd below the voxelwise run's
    (the JAX package's test_spatial_smooths_estimates)."""
    rng = np.random.default_rng(1)
    coords = grid_coords(6, 6, 1)
    data = 5.0 + rng.normal(0, 2.0, (36, 10))
    opts = {"model": "poly", "degree": "0", "noise": "white",
            "max-iterations": "10"}
    vo = RunOptions(opts)
    vox = VBInference(get_model_class("poly")(vo), vo, data,
                      device="cpu").run()
    so = RunOptions({**opts, "method": "spatialvb",
                     "param-spatial-priors": "M", "spatial-dims": "2"})
    sp = SpatialVBInference(get_model_class("poly")(so), so, data,
                            device="cpu", coords=coords).run()
    assert sp.means[:, 0].std() < 0.7 * vox.means[:, 0].std()
    assert abs(sp.means[:, 0].mean() - 5.0) < 0.5
    assert np.mean(sp.cov[:, 0, 0] < vox.cov[:, 0, 0]) >= 0.99


# -- the runner, API and CLI --------------------------------------------------

def test_run_with_data_spatialvb_matches_jax():
    """method=spatialvb through run_with_data, and method=vb with an M
    prior dispatching to spatial VB (inference_vb.cc:334-358): the
    outputs and the coefficient-resels log lines against the JAX API."""
    from fabber_core_tpu.api import FabberTpu as JFabber
    from fabber_core_tpu_torch.api import FabberTpu
    rng = np.random.default_rng(2)
    t = np.arange(1, 13)
    vol = (1.0 + 0.1 * t + rng.normal(0, 0.1, (4, 4, 2, 12)))
    opts = {"model": "poly", "degree": "1", "noise": "white",
            "param-spatial-priors": "M+", "max-iterations": "4",
            "save-mean": True, "save-std": True, "save-noise-mean": True,
            "save-free-energy": True}
    for method in ("spatialvb", "vb"):
        run = FabberTpu(device="cpu").run_with_data(
            {**opts, "method": method}, {"data": vol})
        jrun = JFabber().run_with_data({**opts, "method": method},
                                       {"data": vol})
        assert set(run.data) == set(jrun.data)
        for key in run.data:
            np.testing.assert_allclose(run.data[key], jrun.data[key],
                                       rtol=1e-5, atol=1e-6)
        assert "Vb::Engine route: spatial jacobi sweeps" in run.log
        lines = [ln for ln in run.log.splitlines()
                 if "Coefficient resels per voxel" in ln]
        jlines = [ln for ln in jrun.log.splitlines()
                  if "Coefficient resels per voxel" in ln]
        assert len(lines) == 2 and len(lines) == len(jlines)


def test_cli_help_lists_spatial_options(capsys):
    from fabber_core_tpu_torch import cli
    assert cli.execute(["--help", "--method=spatialvb"]) == 0
    out = capsys.readouterr().out
    for name in ("spatial-dims", "spatial-sweep-mode", "spatial-stencil",
                 "spatial-block-voxels", "spatial-fchange", "max-iterations"):
        assert f"--{name}" in out
