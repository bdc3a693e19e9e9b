"""The port's spatial VB modes against the JAX package's: the
Gauss-Seidel sweep (stats route with white and AR(1) noise, direct and
generic routes), blocked
streaming sweeps (against the JAX blocked run and against the unblocked
run), the excision of a voxel that fails, the spatial-fchange early
stop, the capacity pre-check and the refusals.

Tolerances: float64 runs within 1e-9 relative of the JAX package's
(means in posterior sd); blocked float32 runs against the unblocked
ones as in the JAX package's tests/test_spatial_blocked.py (means rtol
2e-4 / atol 1e-5, aK and resels rtol 2e-4); the float32 early stop
with the JAX run's sweep count, means within 1e-4 and F within
tests/test_torch_engine.py's rtol 1e-3 / atol 5e-3.
"""

import numpy as np
import pytest
import torch

from fabber_core_tpu.inference.spatial import SpatialVBInference as JSVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.exceptions import FabberError, InvalidOptionValue
from fabber_core_tpu_torch.inference.spatial import SpatialVBInference
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.options import RunOptions

torch.set_num_threads(1)


def grid_coords(nx, ny, nz):
    return np.array([[x, y, z] for z in range(nz) for y in range(ny)
                     for x in range(nx)], float)


def make_data(coords, nt, seed=0, noise=0.05):
    """tests/test_spatial_blocked.py's data (float32)."""
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1, dtype=float)
    truth = 1.0 + 0.1 * coords[:, 0] - 0.05 * coords[:, 1]
    return (truth[:, None] * (1.0 + 0.02 * t[None, :])
            + noise * rng.standard_normal((len(coords), nt))
            ).astype(np.float32)


BASE = {"model": "poly", "degree": "1", "noise": "white",
        "method": "spatialvb", "max-iterations": "6",
        "print-free-energy": True}


def port(opts, data, coords, model="poly"):
    o = RunOptions(opts)
    return SpatialVBInference(get_model_class(model)(o), o, data,
                              device="cpu", coords=coords)


def jax(opts, data, coords, model="poly"):
    o = JOptions(opts)
    return JSVB(jmodel(model)(o), o, data, coords)


def assert_close(je, rx, pe, rp, rtol=1e-9, good=None):
    good = np.ones(len(rx.means), bool) if good is None else good
    sd = np.sqrt(np.diagonal(rx.cov[good], axis1=1, axis2=2))
    assert np.max(np.abs(rx.means[good] - rp.means[good]) / sd) < rtol
    np.testing.assert_allclose(rp.cov[good], rx.cov[good], rtol=rtol,
                               atol=rtol * np.abs(rx.cov).max())
    np.testing.assert_allclose(rp.noise_means[good], rx.noise_means[good],
                               rtol=rtol)
    np.testing.assert_allclose(pe.final_ak, je.final_ak, rtol=rtol)
    np.testing.assert_allclose(pe.coefficient_resels, je.coefficient_resels,
                               rtol=rtol, atol=rtol)
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


# -- Gauss-Seidel -------------------------------------------------------------

GS_CASES = [("poly", "stats", "white"), ("poly", "direct", "white"),
            ("exp", "stats", "white"), ("poly", "stats", "ar")]


@pytest.mark.parametrize("model,route,noise", GS_CASES,
                         ids=[f"{m}-{r}-{n}" for m, r, n in GS_CASES])
def test_gauss_seidel_matches_jax(model, route, noise):
    """The reference's voxel order (a Python loop over 20 voxels) on the
    statistics route (white and AR(1) noise: each noise model's
    design_stats_voxel), the direct route and, for exp, the generic
    route, at float64."""
    rng = np.random.default_rng(17)
    coords = grid_coords(5, 4, 1)
    if model == "poly":
        data = 4.0 + rng.normal(0, 0.5, (20, 10))
        extra = {"degree": "0", "param-spatial-priors": "M"}
    else:
        tt = np.arange(10) * 0.1
        data = ((1.0 + 0.05 * coords[:, 0])[:, None]
                * np.exp(-0.8 * tt[None, :]) + rng.normal(0, 0.02, (20, 10)))
        extra = {"dt": "0.1", "param-spatial-priors": "MN"}
    opts = {**BASE, "model": model, **extra, "spatial-dims": "2",
            "max-iterations": "4", "spatial-sweep-mode": "gauss-seidel",
            "fixed-design-route": route, "noise": noise}
    je, pe = jax(opts, data, coords, model), port(opts, data, coords, model)
    assert pe.use_stats == (model == "poly" and route == "stats")
    rx, rp = je.run(), pe.run()
    assert_close(je, rx, pe, rp)
    np.testing.assert_allclose(rp.free_energy, rx.free_energy, rtol=1e-9)
    # the sweep orders genuinely differ from Jacobi's at a few sweeps
    rj = port({**opts, "spatial-sweep-mode": "jacobi"}, data, coords,
              model).run()
    assert not np.allclose(rj.means, rp.means, rtol=1e-12, atol=0)


# -- blocked sweeps -----------------------------------------------------------

def assert_equivalent(r_ref, r_blk, eng_ref, eng_blk):
    """tests/test_spatial_blocked.py's bounds (float32)."""
    np.testing.assert_allclose(r_blk.means, r_ref.means, rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(r_blk.cov, r_ref.cov, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(r_blk.noise_means, r_ref.noise_means,
                               rtol=2e-4)
    np.testing.assert_allclose(
        r_blk.free_energy, r_ref.free_energy, rtol=1e-4,
        atol=1e-3 * np.abs(r_ref.free_energy).max())
    np.testing.assert_allclose(eng_blk.final_ak, eng_ref.final_ak, rtol=2e-4)
    np.testing.assert_allclose(eng_blk.coefficient_resels,
                               eng_ref.coefficient_resels, rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(r_blk.bad_voxels, r_ref.bad_voxels)


BLOCK_CASES = [("M", 64, "single"), ("P", 37, "single"), ("p", 48, "double"),
               ("m", 50, "double")]


@pytest.mark.parametrize("prior,block,dtype", BLOCK_CASES,
                         ids=[f"{p}-{b}-{d}" for p, b, d in BLOCK_CASES])
def test_blocked_matches_unblocked_and_jax(prior, block, dtype):
    """The statistics route, each spatial prior family, divisible and
    prime block sizes: the host-resident run equals the unblocked run to
    roundoff, and (float64) the JAX package's blocked run to 1e-9."""
    coords = grid_coords(8, 6, 4)
    data = make_data(coords, 14)
    opts = {**BASE, "param-spatial-priors": prior + "N", "dtype": dtype}
    e_ref = port(opts, data, coords)
    r_ref = e_ref.run()
    blk = {**opts, "spatial-block-voxels": str(block)}
    e_blk = port(blk, data, coords)
    assert e_blk.block_voxels == block and e_blk.data.device.type == "cpu"
    assert "blocked streaming sweeps" in e_blk.route_description()
    r_blk = e_blk.run()
    assert_equivalent(r_ref, r_blk, e_ref, e_blk)
    if dtype == "double":
        je = jax(blk, data, coords)
        assert_close(je, je.run(), e_blk, r_blk)


def test_blocked_generic_route_matches_jax():
    """exp (no fixed design): the blocked step ships [T,Vb] data blocks
    and relinearizes in the block."""
    coords = grid_coords(6, 5, 1)
    rng = np.random.default_rng(2)
    tt = np.arange(20) * 0.1
    amp = 1.0 + 0.05 * coords[:, 0]
    data = (amp[:, None] * np.exp(-0.8 * tt[None, :])
            + 0.02 * rng.standard_normal((30, 20))).astype(np.float32)
    opts = {"model": "exp", "dt": "0.1", "noise": "white",
            "method": "spatialvb", "max-iterations": "5",
            "print-free-energy": True, "param-spatial-priors": "MN",
            "spatial-block-voxels": "11"}
    je, pe = jax(opts, data, coords, "exp"), port(opts, data, coords, "exp")
    assert not pe.use_stats
    assert_close(je, je.run(), pe, pe.run())


# -- excision, early stop, capacity -------------------------------------------

@pytest.mark.parametrize("block", ["0", "8"], ids=["unblocked", "blocked"])
def test_failing_voxel_is_excised_as_in_jax(block):
    """A voxel with NaN data fails in sweep 0, reverts to its pre-sweep
    state, is marked bad and leaves the graph: the excision mask, the
    neighbours' posteriors and priors, aK and the resels against the
    JAX package at float64."""
    coords = grid_coords(5, 4, 1)
    data = make_data(coords, 12).astype(np.float64)
    data[7] = np.nan
    opts = {**BASE, "param-spatial-priors": "MM", "allow-bad-voxels": True,
            "spatial-block-voxels": block}
    je, pe = jax(opts, data, coords), port(opts, data, coords)
    rx, rp = je.run(), pe.run()
    assert rp.bad_voxels.tolist() == [v == 7 for v in range(20)]
    assert_close(je, rx, pe, rp, good=~rx.bad_voxels)
    np.testing.assert_array_equal(rp.means[7], 0.0)


def test_spatial_fchange_matches_jax():
    """--spatial-fchange stops when the global F changes by no more than
    the tolerance between sweeps: the sweep count and the posterior
    against the JAX run (float32), the blocked runner agreeing."""
    coords = grid_coords(8, 6, 1)
    data = make_data(coords, 14, noise=0.02)
    opts = {**BASE, "param-spatial-priors": "MN", "max-iterations": "30",
            "spatial-fchange": "0.05", "dtype": "single"}
    je, pe = jax(opts, data, coords), port(opts, data, coords)
    rx, rp = je.run(), pe.run()
    assert 1 < rp.iterations[0] < 30
    np.testing.assert_array_equal(rp.iterations, rx.iterations)
    np.testing.assert_allclose(rp.means, rx.means, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rp.free_energy, rx.free_energy, rtol=1e-3,
                               atol=5e-3)
    r2 = port({**opts, "spatial-block-voxels": "13"}, data, coords).run()
    np.testing.assert_array_equal(r2.iterations, rp.iterations)
    np.testing.assert_allclose(r2.means, rp.means, rtol=2e-4, atol=1e-5)


def test_capacity_precheck_names_the_escapes():
    """Over the budget the unblocked run fails before it starts, naming
    the escapes; the blocked run under the same budget runs."""
    coords = grid_coords(6, 4, 1)
    data = make_data(coords, 10)
    opts = {**BASE, "param-spatial-priors": "MN", "spatial-mem-gb": "1e-6"}
    with pytest.raises(FabberError) as exc:
        port(opts, data, coords).run()
    msg = str(exc.value)
    for escape in ("--spatial-block-voxels", "--dtype=bf16",
                   "--spatial-mem-gb", "item 18"):
        assert escape in msg
    r = port({**opts, "spatial-block-voxels": "8"}, data, coords).run()
    assert not r.bad_voxels.any()
    # off the card the check runs only when the option sets a budget
    assert port(BASE, data, coords)._device_mem_budget() is None


def test_progress_and_image_prior_in_blocks():
    """Per-sweep progress reaches (V, V); an image prior's means reach
    each block's slice."""
    coords = grid_coords(6, 4, 1)
    nv = len(coords)
    data = make_data(coords, 12)
    img = np.linspace(0.5, 1.5, nv).astype(np.float32)
    opts = {**BASE, "param-spatial-priors": "MN", "PSP_byname1": "c1",
            "PSP_byname1_type": "I", "PSP_byname1_image": "prior_img"}

    def make(extra):
        o = RunOptions({**opts, **extra})
        return SpatialVBInference(get_model_class("poly")(o), o, data,
                                  voxel_data_getter=lambda key: img,
                                  device="cpu", coords=coords)
    r_ref = make({}).run()
    e_blk = make({"spatial-block-voxels": "7"})
    calls = []
    e_blk.progress_cb = lambda done, total: calls.append((done, total))
    r_blk = e_blk.run()
    np.testing.assert_allclose(r_blk.means, r_ref.means, rtol=1e-9)
    assert len(calls) >= 6 and calls[-1] == (nv, nv)


# -- refusals -----------------------------------------------------------------

REFUSALS = [
    ({"convergence": "trialmode"}, InvalidOptionValue, "maxits"),
    ({"spatial-sweep-mode": "gauss-seidel", "spatial-block-voxels": "4"},
     InvalidOptionValue, "jacobi"),
    ({"spatial-sweep-mode": "red-black"}, InvalidOptionValue, "jacobi"),
    ({"mcsteps": "1"}, InvalidOptionValue, "method=vb only"),
]


@pytest.mark.parametrize("extra,err,match", REFUSALS,
                         ids=["-".join(e) for e, _, _ in REFUSALS])
def test_refusals(extra, err, match):
    coords = grid_coords(4, 3, 1)
    data = make_data(coords, 8)
    with pytest.raises(err, match=match):
        port({**BASE, "param-spatial-priors": "MN", **extra}, data, coords)
