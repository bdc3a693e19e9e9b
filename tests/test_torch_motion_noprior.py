"""The port's motion correction (core/motion.py, VBInference mcsteps), its
likelihood-only output (compute_noprior, --spatial-prior-output-
correction), and the helpers ported with them (core/dists.py,
core/rootfind.py), against the JAX package on the same inputs.

Tolerances and why:
  dists, rootfind      equal up to 1e-12 (the same arithmetic;
                       rootfind is pure Python in both);
  registerer, float64  1e-9 on the estimated transforms and the
                       realigned volumes (the same Gauss-Newton steps and
                       trilinear samples, summed in the same order);
  register_timeseries  1e-6 voxels at float64: the gauge composition
                       casts the transforms to float32 and makes their
                       affine forms there (the JAX module's choice; the
                       port with XLA's roundings), so a 1e-12 difference
                       in a parameter can move it one float32 step;
  registerer, float32  by recovered parameters, port against JAX within
                       5e-3 voxels (tests/test_motion.py's bar);
  mcsteps              at float64 with float64 registerers in both
                       engines: translations within 1e-6 voxels, means
                       within 1e-6 posterior sd;
  compute_noprior      1e-9 at float64 of each output's scale (its sd
                       for the means), on every route family.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fabber_core_tpu.api import FabberTpu as JFabber
from fabber_core_tpu.core import dists as jdists
from fabber_core_tpu.core import motion as jmotion
from fabber_core_tpu.core import rootfind as jroot
from fabber_core_tpu.exceptions import InvalidOptionValue as JInvalid
from fabber_core_tpu.inference.spatial import SpatialVBInference as JSVB
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.api import FabberTpu
from fabber_core_tpu_torch.core import dists as tdists
from fabber_core_tpu_torch.core import motion as tmotion
from fabber_core_tpu_torch.core import rootfind as troot
from fabber_core_tpu_torch.exceptions import InvalidOptionValue
from fabber_core_tpu_torch.inference.spatial import SpatialVBInference
from fabber_core_tpu_torch.inference.vb import ROUTES, VBInference
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.options import RunOptions

torch.set_num_threads(1)

SHAPE = (16, 16, 8)


def full_coords(shape):
    g = np.stack(np.meshgrid(*[np.arange(n) for n in shape],
                             indexing="ij"), -1)
    return g.reshape(-1, 3).astype(np.float64)


def blob(coords, centre, sigma=3.0, amp=2.0):
    d2 = ((coords - np.asarray(centre)) ** 2).sum(axis=1)
    return amp * np.exp(-d2 / (2.0 * sigma ** 2))


# -- dists -------------------------------------------------------------------

def spd_batch(seed=0):
    """Four PD 3x3 matrices, one indefinite, one zero (the jitter retry
    makes it PD), one that stays singular after it."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(7, 3, 3))
    m = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)
    m[4] = np.diag([1.0, -1.0, 1.0])
    m[5] = 0.0
    m[6] = np.diag([1.0, -1e-3, 1.0])
    return m


def test_chol_inv_logdet_matches_jax():
    m = spd_batch()
    jinv, jld, jok = (np.asarray(x) for x in jdists.chol_inv_logdet(m))
    tinv, tld, tok = (x.numpy() for x in tdists.chol_inv_logdet(
        torch.as_tensor(m)))
    np.testing.assert_array_equal(tok, jok)
    assert not tok[4] and tok[5] and not tok[6]
    np.testing.assert_allclose(tinv, jinv, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tld, jld, rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(tdists.sym_inv(torch.as_tensor(m)).numpy(),
                               np.asarray(jdists.sym_inv(m)), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        tdists.sym_logdet(torch.as_tensor(m)).numpy(),
        np.asarray(jdists.sym_logdet(m)), rtol=1e-12, equal_nan=True)


def test_mvn_block_helpers_match_jax():
    rng = np.random.default_rng(1)
    m1, m2 = rng.normal(size=(5, 3)), rng.normal(size=(5, 1))
    c1 = spd_batch(2)[:5]
    c2 = rng.uniform(0.5, 2.0, (5, 1, 1))
    tm, tc = tdists.concat_mvn(m1, c1, m2, c2)
    jm, jc = jdists.concat_mvn(m1, c1, m2, c2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    (a, b), (c, d) = tdists.split_mvn(tm, tc, 3)
    for x, y in ((a, m1), (b, c1), (c, m2), (d, c2)):
        np.testing.assert_array_equal(x.numpy(), y)
    v = rng.uniform(0.1, 1.0, (5, 3))
    np.testing.assert_array_equal(tdists.diag_mvn(m1, v),
                                  jdists.diag_mvn(m1, v))
    b, c = tdists.gamma_from_mean_var(2.0, 0.5)
    assert (tdists.gamma_mean(b, c), tdists.gamma_var(b, c)) == (2.0, 0.5)


# -- rootfind (tests/test_rootfind.py's cases, both packages) ----------------

PKGS = {"jax": jroot, "port": troot}


def descending(x):
    return 5.0 - x


def descending_exp(x):
    return math.exp(-x) - 0.1


@pytest.mark.parametrize("pkg", PKGS)
def test_guesstimators(pkg):
    r = PKGS[pkg]
    assert r.bisection_guess(0, 10, 1, -1) == 5
    assert r.log_bisection_guess(1, 100, 1, -1) == pytest.approx(10)
    assert r.interp_guess(0, 10, 2, -2) == pytest.approx(5)


ROOT_CASES = [
    ("linear-bisection", descending, dict(guess=0.0, scale=2.0, tol_y=1e-10,
                                          guesstimator="bisection")),
    ("linear-interp", descending, dict(guess=0.0, scale=2.0, tol_y=1e-10,
                                       guesstimator="interp")),
    ("linear-riddlers", descending, dict(guess=0.0, scale=2.0, tol_y=1e-10,
                                         guesstimator="riddlers")),
    ("exp-logbisection", descending_exp, dict(
        search_min=1e-6, search_max=100.0, guess=1.0, scale=2.0,
        tol_y=1e-12, guesstimator="logbisection")),
    ("exp-logriddlers", descending_exp, dict(
        search_min=1e-6, search_max=100.0, guess=1.0, scale=2.0,
        tol_y=1e-12, guesstimator="logriddlers")),
    ("boundary-clamp", descending, dict(search_min=0.0, search_max=2.0,
                                        guess=1.0, scale=1.0, tol_x=1e-8)),
    ("tol-x", descending, dict(guess=0.0, scale=10.0, tol_x=0.5)),
]


@pytest.mark.parametrize("name,f,kw", ROOT_CASES,
                         ids=[c[0] for c in ROOT_CASES])
def test_zero_finder_matches_jax(name, f, kw):
    """Each case finds the same root in both packages, with the same
    sequence of evaluations."""
    calls = {}
    roots = {}
    for pkg, r in PKGS.items():
        seen = []

        def g(x, seen=seen):
            seen.append(x)
            return f(x)
        roots[pkg] = r.DescendingZeroFinder(g, **kw).find_zero()
        calls[pkg] = seen
    assert roots["port"] == roots["jax"]
    assert calls["port"] == calls["jax"]
    want = {"boundary-clamp": 2.0}.get(name, 5.0 if f is descending
                                       else math.log(10))
    assert roots["port"] == pytest.approx(want, abs=0.5 if name == "tol-x"
                                          else 1e-5)
    if name == "tol-x":
        assert len(calls["port"]) < 12


def test_zero_finder_too_many_evaluations():
    for r in PKGS.values():
        with pytest.raises(RuntimeError):
            r.DescendingZeroFinder(descending, guess=0.0, scale=2.0,
                                   tol_y=1e-30, tol_x=1e-300,
                                   max_evaluations=5).find_zero()


# -- the registerer ----------------------------------------------------------

def registerers(coords, shape, dtype64=True, **kw):
    j = jmotion.make_registerer(coords, shape, dtype=jnp.float64 if dtype64
                                else jnp.float32, **kw)
    t = tmotion.make_registerer(coords, shape, dtype=torch.float64
                                if dtype64 else torch.float32, **kw)
    return j, t


def rotated_scene(coords, centre, ang):
    def scene(pts):
        return (blob(pts, centre + [4, 0, 0], sigma=2.0)
                + blob(pts, centre - [4, 0, 0], sigma=2.5, amp=1.5))
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return scene((coords - centre) @ rot + centre), scene(coords)


REG_CASES = ["translation", "rotation", "dof12"]


@pytest.mark.parametrize("case", REG_CASES)
def test_registerer_matches_jax_float64(case):
    """The estimated transform and the realigned volume at float64
    within 1e-9 of the JAX registerer's (a small volume: the pyramid's
    coarse level is skipped in both)."""
    coords = full_coords(SHAPE)
    centre = np.array([7.5, 7.5, 3.5])
    if case == "rotation":
        moved, target = rotated_scene(coords, centre, 0.06)
    else:
        target = blob(coords, centre)
        moved = blob(coords, centre + np.array([0.6, -0.8, 0.4]))
    dof = 12 if case == "dof12" else 6
    jr, tr = registerers(coords, SHAPE, dof=dof, n_iters=12)
    assert jr.levels == tr.levels == (1,)
    assert jr.capture_range == tr.capture_range == 2.0
    ja, jp = jr(moved, target)
    ta, tp = tr(torch.as_tensor(moved), torch.as_tensor(target))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-9 * np.abs(target).max())
    if case == "rotation":
        assert abs(float(tp[5]) - 0.06) < 0.01


def test_pyramid_matches_jax_float64():
    """A 4-voxel translation on a volume that takes the 4x pool level:
    the pyramid's levels, capture range and estimate as the JAX one's,
    and the shift recovered."""
    shape = (32, 32, 16)
    coords = full_coords(shape)
    centre = np.array([15.5, 15.5, 7.5])
    shift = np.array([4.0, -3.5, 2.5])
    target = blob(coords, centre, sigma=5.0)
    moved = blob(coords, centre + shift, sigma=5.0)
    jr, tr = registerers(coords, shape, n_iters=12)
    assert jr.levels == tr.levels == (4, 1)
    assert tr.capture_range == 8.0
    _, jp = jr(moved, target)
    _, tp = tr(torch.as_tensor(moved), torch.as_tensor(target))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(tp.numpy()[:3], shift, atol=0.1)


@pytest.mark.parametrize("dof", [6, 12])
def test_registerer_float32_matches_jax_by_parameters(dof):
    """The registerer at its default float32, port against JAX by the
    recovered parameters: within 5e-3 voxels of each other (the JAX
    test's bar), each within 0.05 of the true shift (tests/
    test_motion.py's; at float64 the discretised cost puts the optimum
    5.7e-3 off it, in both packages)."""
    coords = full_coords(SHAPE)
    centre = np.array([7.5, 7.5, 3.5])
    shift = np.array([0.6, -0.8, 0.4])
    target = blob(coords, centre)
    moved = blob(coords, centre + shift)
    jr, tr = registerers(coords, SHAPE, dtype64=False, dof=dof, n_iters=12)
    assert tr.dtype == torch.float32
    _, jp = jr(moved, target)
    _, tp = tr(torch.as_tensor(moved), torch.as_tensor(target))
    jp, tp = np.asarray(jp, np.float64), tp.double().numpy()
    assert np.abs(tp - jp).max() < 5e-3
    for p in (jp, tp):
        assert np.abs(p[:3] - shift).max() < 0.05
        if dof == 6:
            assert np.abs(p[3:]).max() < 0.02


@pytest.mark.parametrize("dof", [6, 12])
def test_register_timeseries_matches_jax(dof):
    """Every timepoint registered, then the median gauge: at float64
    the displacements within 1e-6 voxels and the realigned planes within
    1e-6 of the data's max of the JAX module's (the float32 affine
    forms); still volumes pass through unresampled (identity); a volume
    scaled in intensity is moved (the demeaned cost is not scale-free)
    alike in both packages."""
    coords = full_coords(SHAPE)
    centre = np.array([7.5, 7.5, 3.5])
    vol = blob(coords, centre)
    moved = blob(coords, centre + np.array([0.5, 0.3, -0.2]))
    data = np.stack([vol, vol, vol * 1.5, moved])
    pred = np.stack([vol] * 4)
    jr, tr = registerers(coords, SHAPE, dof=dof)
    jo, jd = jmotion.register_timeseries(jnp.asarray(data), jnp.asarray(pred),
                                         coords, SHAPE, dof=dof, reg=jr)
    to, td = tmotion.register_timeseries(torch.as_tensor(data),
                                         torch.as_tensor(pred), coords,
                                         SHAPE, dof=dof, reg=tr)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-6 * np.abs(data).max())
    np.testing.assert_array_equal(to.numpy()[:2], data[:2])
    assert np.abs(td[:2]).max() < tmotion.IDENTITY_TOL
    assert 0.4 < np.abs(td[3]).max() < 0.7


def test_map_coordinates_matches_jax():
    """Trilinear sampling with edge clamping, points inside, on and
    outside the grid."""
    from jax.scipy.ndimage import map_coordinates
    rng = np.random.default_rng(3)
    grid = rng.normal(size=(5, 4, 3))
    pts = rng.uniform(-1.5, 6.0, (3, 200))
    pts[:, :4] = [[0, 4, 1.5, 2], [0, 3, 2.0, -0.5], [0, 2, 1.0, 2.5]]
    want = np.asarray(map_coordinates(jnp.asarray(grid), list(pts), order=1,
                                      mode="nearest"))
    got = tmotion.map_coordinates_linear(torch.as_tensor(grid),
                                         torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


# -- mcsteps through the engine ---------------------------------------------

def mc_data(shift_x, nt, start, seed):
    rng = np.random.default_rng(seed)
    coords = full_coords(SHAPE)
    centre = np.array([7.5, 7.5, 3.5])
    data = np.empty((coords.shape[0], nt))
    for k in range(nt):
        s = np.array([shift_x if k >= start else 0.0, 0, 0])
        data[:, k] = 1.0 + blob(coords, centre + s, sigma=4.0)
    return data + 0.02 * rng.standard_normal(data.shape), coords


def mc_engines(data, coords, extra, f64_reg=True):
    o = {"model": "poly", "degree": "0", "noise": "white",
         "max-iterations": "6", "dtype": "double", **extra}
    je = JVB(jmodel("poly")(JOptions(o)), JOptions(o), data, coords)
    te = VBInference(get_model_class("poly")(RunOptions(o)), RunOptions(o),
                     data, coords=coords, device="cpu")
    if f64_reg:
        dof = int(extra.get("mc-dof", 6))
        je._mc_registerer = jmotion.make_registerer(coords, SHAPE, dof=dof,
                                                    dtype=jnp.float64)
        te._mc_registerer = tmotion.make_registerer(coords, SHAPE, dof=dof,
                                                    dtype=torch.float64)
    return je, te


@pytest.mark.parametrize("dof", ["6", "12"])
def test_mcsteps_match_jax(dof):
    """mcsteps=2 on poly degree 0 with the last quarter of the volumes
    shifted 1.2 voxels (tests/test_motion.py's case): the route the run
    takes without motion correction (and logs), each step's largest
    translation within 1e-6 voxels of the JAX engine's, the means within
    1e-6 posterior sd; the translation near 1.2 and not saturated."""
    data, coords = mc_data(1.2, 16, 12, seed=7)
    je, te = mc_engines(data, coords, {"mcsteps": "2", "mc-dof": dof})
    assert te.route == "xla" and "motion-correction" in ROUTES
    rj, rt = je.run(), te.run()
    np.testing.assert_allclose(te.mc_translations, je.mc_translations,
                               rtol=0, atol=1e-6)
    sd = np.sqrt(rj.cov[:, 0, 0])
    assert np.max(np.abs(rj.means - rt.means)[:, 0] / sd) < 1e-6
    assert len(te.mc_translations) == 2
    assert 0.9 < te.mc_translations[0] < 1.5 and not te.mc_saturated
    assert te.mc_capture_range == je.mc_capture_range == 2.0


def test_mcsteps_saturation_and_repeated_run():
    """A shift near the capture range sets the saturation flag in both
    engines; a second run() registers from the original data again
    (its first step's translation equals the first run's first step's,
    though its VB pass started from the realigned data)."""
    data, coords = mc_data(1.8, 12, 9, seed=11)
    je, te = mc_engines(data, coords, {"mcsteps": "1",
                                       "max-iterations": "5"})
    je.run()
    te.run()
    assert te.mc_saturated and je.mc_saturated
    assert te.mc_translations[0] >= 1.5
    np.testing.assert_allclose(te.mc_translations, je.mc_translations,
                               atol=1e-6)
    orig = te._mc_orig_data
    t1 = list(te.mc_translations)
    r2j, r2t = je.run(), te.run()
    assert te._mc_orig_data is orig and not torch.equal(te.data, orig)
    np.testing.assert_allclose(te.mc_translations, je.mc_translations,
                               atol=1e-6)
    assert abs(te.mc_translations[0] - t1[0]) < 0.2
    sd = np.sqrt(r2j.cov[:, 0, 0])
    assert np.max(np.abs(r2j.means - r2t.means)[:, 0] / sd) < 1e-6


def test_mcsteps_refusals():
    """Spatial VB refuses mcsteps (both packages, InvalidOptionValue);
    mc-dof takes 6 or 12 only."""
    coords = full_coords((8, 8, 4))
    data = np.ones((coords.shape[0], 8))
    o = {"model": "poly", "degree": "0", "noise": "white",
         "method": "spatialvb", "param-spatial-priors": "M", "mcsteps": "1"}
    with pytest.raises(JInvalid):
        JSVB(jmodel("poly")(JOptions(o)), JOptions(o), data, coords)
    with pytest.raises(InvalidOptionValue, match="method=vb only"):
        SpatialVBInference(get_model_class("poly")(RunOptions(o)),
                           RunOptions(o), data, coords=coords, device="cpu")
    o = {"model": "poly", "degree": "0", "noise": "white", "mcsteps": "1",
         "mc-dof": "7"}
    with pytest.raises(InvalidOptionValue, match="mc-dof"):
        VBInference(get_model_class("poly")(RunOptions(o)), RunOptions(o),
                    data, coords=coords, device="cpu")


# -- compute_noprior ---------------------------------------------------------

NV, NT = 48, 30


def poly_data(seed=0, nv=NV, nt=NT):
    rng = np.random.default_rng(seed)
    t = np.arange(1, nt + 1)
    return (rng.uniform(-1, 1, (nv, 1)) + rng.uniform(-.05, .05, (nv, 1)) * t
            + 0.1 * rng.standard_normal((nv, nt)))


def exp_data(seed=1, nv=NV, nt=NT, flat=False):
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * 0.1
    d = (rng.uniform(0.5, 2, (nv, 1)) * np.exp(-rng.uniform(0.5, 2, (nv, 1))
                                                * t)
         + 0.3 * rng.uniform(0.5, 2, (nv, 1)) * np.exp(-5 * t)
         + 0.02 * rng.standard_normal((nv, nt)))
    if flat:
        d[0] = 1.0     # a flat lane: the rates are not identified
    return d


def assert_noprior(rj, rt, rtol=1e-9, good=None):
    good = np.ones(len(rj.means), bool) if good is None else good
    sd = np.sqrt(np.diagonal(rj.noprior_cov[good], axis1=1, axis2=2))
    assert np.max(np.abs(rj.noprior_means[good] - rt.noprior_means[good])
                  / sd) < rtol
    np.testing.assert_allclose(rt.noprior_cov[good], rj.noprior_cov[good],
                               rtol=rtol,
                               atol=rtol * np.abs(rj.noprior_cov[good]).max())
    np.testing.assert_allclose(rt.means, rj.means, rtol=1e-9, atol=1e-12)


NOPRIOR_CASES = {
    "poly-stats": ("poly", {"degree": "2"}, poly_data, "xla"),
    "exp-generic": ("exp", {"dt": "0.1"}, exp_data, "xla-generic"),
    "exp-ar": ("exp", {"dt": "0.1", "noise": "ar"}, exp_data, "xla-generic"),
    "poly-ar-direct": ("poly", {"degree": "1", "noise": "ar",
                                "fixed-design-route": "direct"}, poly_data,
                       "xla-generic"),
}


@pytest.mark.parametrize("case", NOPRIOR_CASES)
def test_noprior_voxelwise_matches_jax(case):
    """The likelihood-only posterior at float64 on each route family:
    poly on the statistics route (the design as J), exp (white and AR
    noise) on the generic route, poly with AR noise without its design;
    within 1e-9 of the JAX engine's. (biexp is no case for 1e-9: its two
    components are near-exchangeable on such data, the no-prior J'XJ
    reaches condition 1e17, and the two packages' float64 runs already
    part at 1e-3 after ten iterations.)"""
    model, extra, make, route = NOPRIOR_CASES[case]
    o = {"model": model, "noise": "white", "max-iterations": "5",
         "dtype": "double", "spatial-prior-output-correction": True,
         **extra}
    data = make()
    coords = np.zeros((NV, 3))
    rj = JVB(jmodel(model)(JOptions(o)), JOptions(o), data, coords).run()
    te = VBInference(get_model_class(model)(RunOptions(o)), RunOptions(o),
                     data, device="cpu")
    assert te.route == route
    rt = te.run()
    assert rt.noprior_means.shape == rt.means.shape
    assert_noprior(rj, rt)


def test_noprior_singular_lane_takes_jax_branch():
    """exp linearized at locked centres (locked-linear-from-mvn), one
    lane's rate so large that its Jacobian column vanishes: with no prior
    J'XJ is singular there, and update_theta's Cholesky with its jitter
    retry decides the output, the same branch in both packages (the
    same non-finite pattern, the same finite values); the other lanes
    within 1e-9."""
    from fabber_core_tpu_torch.io import mvn
    rng = np.random.default_rng(2)
    t = np.arange(NT) * 0.1
    amp, r = rng.uniform(0.5, 2, (NV, 1)), rng.uniform(0.5, 2, (NV, 1))
    data = amp * np.exp(-r * t) + 0.02 * rng.standard_normal((NV, NT))
    lmeans = np.concatenate([np.log(amp) + 0.05, np.log(r) - 0.05,
                             np.ones((NV, 1))], axis=1)
    lmeans[0, 1] = 8.5     # exp(-r t) underflows for every t > 0
    key = mvn.pack(lmeans, np.broadcast_to(np.eye(3), (NV, 3, 3))).T

    def getter(name):
        return key
    o = {"model": "exp", "dt": "0.1", "noise": "white",
         "max-iterations": "5", "dtype": "double",
         "spatial-prior-output-correction": True,
         "locked-linear-from-mvn": "locked"}
    rj = JVB(jmodel("exp")(JOptions(o)), JOptions(o), data,
             np.zeros((NV, 3)), voxel_data_getter=getter).run()
    te = VBInference(get_model_class("exp")(RunOptions(o)), RunOptions(o),
                     data, voxel_data_getter=getter, device="cpu")
    assert te.locked_linear and te.route == "xla-generic"
    rt = te.run()
    good = np.ones(NV, bool)
    good[0] = False
    assert_noprior(rj, rt, good=good)
    for j, p in ((rj.noprior_cov[0], rt.noprior_cov[0]),
                 (rj.noprior_means[0], rt.noprior_means[0])):
        fin = np.isfinite(j)
        np.testing.assert_array_equal(np.isfinite(p), fin)
        assert not fin.all()
        np.testing.assert_allclose(p[fin], j[fin], rtol=1e-9)


def spatial_case(extra):
    """A spatial M run in both packages on data that float32 holds
    exactly (the JAX package's blocked sweeps keep the data on the host
    in float32)."""
    coords = np.array([[x, y, 0] for y in range(6) for x in range(8)], float)
    rng = np.random.default_rng(5)
    data = rng.uniform(3, 5, (48, 1)) + 0.5 * rng.standard_normal((48, 20))
    data = data.astype(np.float32).astype(np.float64)
    o = {"model": "poly", "degree": "0", "noise": "white",
         "method": "spatialvb", "param-spatial-priors": "M",
         "spatial-dims": "2", "max-iterations": "4", "dtype": "double",
         "spatial-prior-output-correction": True, **extra}
    rj = JSVB(jmodel("poly")(JOptions(o)), JOptions(o), data, coords).run()
    te = SpatialVBInference(get_model_class("poly")(RunOptions(o)),
                            RunOptions(o), data, coords=coords, device="cpu")
    return rj, te, te.run()


@pytest.mark.parametrize("blocked", [False, True], ids=["whole", "blocked"])
def test_noprior_spatial_matches_jax(blocked):
    """Spatial VB's likelihood-only output (the unshrunk per-voxel
    estimates), whole and in blocks of 7 voxels (the data kept on the
    host, shipped a block at a time)."""
    rj, te, rt = spatial_case({"spatial-block-voxels": "7"} if blocked
                              else {})
    assert te.route == "spatial" and (te.block_voxels > 0) == blocked
    assert_noprior(rj, rt)


# -- runner outputs ----------------------------------------------------------

def test_runner_noprior_maps_and_mc_log_match_jax():
    """run_with_data writes mean_noprior_* and std_noprior_* through each
    parameter's transform (exp's are log-transformed), as the JAX API
    does, and logs each motion correction step."""
    vol = exp_data(seed=9, nv=24).reshape(4, 3, 2, NT)
    opts = {"model": "exp", "dt": "0.1", "noise": "white",
            "method": "vb", "max-iterations": "4", "dtype": "double",
            "spatial-prior-output-correction": True, "save-mean": True}
    jd = JFabber().run_with_data(opts, {"data": vol}).data
    run = FabberTpu(device="cpu").run_with_data(opts, {"data": vol})
    for name in ("mean_noprior_amp1", "std_noprior_amp1",
                 "mean_noprior_r1", "std_noprior_r1"):
        np.testing.assert_allclose(run.data[name], jd[name], rtol=1e-6,
                                   atol=1e-7)
    data, _ = mc_data(1.2, 8, 6, seed=3)
    mvol = data.reshape(SHAPE + (8,))
    run = FabberTpu(device="cpu").run_with_data(
        {"model": "poly", "degree": "0", "noise": "white", "method": "vb",
         "max-iterations": "3", "mcsteps": "2", "save-mean": True},
        {"data": mvol})
    lines = [ln for ln in run.log.splitlines()
             if "Motion correction step" in ln]
    assert len(lines) == 2 and "2/2: max |translation|" in lines[1]
