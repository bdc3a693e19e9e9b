"""The port's AR(1) noise model (fabber_core_tpu_torch/noise/ar1.py)
against the JAX package's at float64, on the same inputs made from one
numpy seed:

  every method of the statistics route (make_design_stats,
  update_theta_stats, update_noise_stats, free_energy_stats) and of the
  generic route (update_theta, update_noise, free_energy), the initial
  state and the MVN round trip, for (echoes, cross terms) = (1, none),
  (2, none), (2, same), (2, dual): to 1e-10 of each output's max;
  the engine against the dense-matrix oracle (tests/oracle_ar.py) at the
  JAX test's bounds (tests/test_ar1.py); option validation; recovery of
  the AR coefficient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.noise.ar1 import Ar1NoiseModel as JAr1
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.convert import (design_stats_from_numpy,
                                           noise_state_from_numpy, to_numpy)
from fabber_core_tpu_torch.exceptions import InvalidOptionValue
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.noise import get_noise_class
from fabber_core_tpu_torch.noise.ar1 import Ar1NoiseModel
from fabber_core_tpu_torch.options import RunOptions

import oracle_ar

torch.set_num_threads(1)

CASES = [(1, "none"), (2, "none"), (2, "same"), (2, "dual")]
IDS = [f"echoes{n}-{c}" for n, c in CASES]


def close(got, ref, tol=1e-10):
    got = np.asarray(to_numpy(got), np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def close_tuple(got, ref, tol=1e-10):
    for g, r in zip(got, ref):
        close(g, r, tol)


def models(nphis, cross, nt):
    opts = {"num-echoes": str(nphis), "ar1-cross-terms": cross}
    return JAr1(JOptions(opts), nt), Ar1NoiseModel(RunOptions(opts), nt)


def random_state(jm, nv, rng):
    """An AR posterior off the initial one: alpha means in (-0.5, 0.5),
    an SPD alpha covariance per voxel, phi b and c of a few decades."""
    a, q = jm.nalphas, jm.nphis
    am = rng.uniform(-0.5, 0.5, (a, nv))
    l = rng.uniform(-0.1, 0.1, (a, a, nv))
    ac = np.einsum("ikv,jkv->ijv", l, l) + 0.05 * np.eye(a)[:, :, None]
    ap = np.moveaxis(np.linalg.inv(np.moveaxis(ac, -1, 0)), 0, -1)
    b = 10.0 ** rng.uniform(-1, 1, (q, nv))
    c = rng.uniform(5.0, 20.0, (q, nv))
    return type(jm.initial_state(1, jnp.float64)[1])(
        *(jnp.asarray(x) for x in (am, ac, ap, b, c)))


def problem(jm, nv=12, p=3, seed=0):
    """A scaled poly design [T,P], AR(1) data [T,V], a posterior over P
    (means, prec, cov), priors, and a noise state, as JAX arrays."""
    rng = np.random.default_rng(seed)
    nt = jm.nt
    d = (np.arange(1, nt + 1.0)[:, None] / nt) ** np.arange(p)[None]
    e = rng.standard_normal((nt, nv))
    for k in range(jm.nphis, nt):
        e[k] += 0.4 * e[k - jm.nphis]
    y = d @ rng.uniform(-1, 1, (p, nv)) + 0.1 * e
    means = rng.uniform(-1, 1, (p, nv))
    l = rng.uniform(-0.2, 0.2, (p, p, nv))
    cov = np.einsum("ikv,jkv->ijv", l, l) + 0.01 * np.eye(p)[:, :, None]
    prec = np.moveaxis(np.linalg.inv(np.moveaxis(cov, -1, 0)), 0, -1)
    pm = rng.uniform(-0.2, 0.2, (p, nv))
    pp = 10.0 ** rng.uniform(-3, 0, (p, nv))
    arrays = dict(design=d, data=y, means=means, prec=prec, cov=cov, pm=pm,
                  pp=pp)
    return dict({k: jnp.asarray(v) for k, v in arrays.items()},
                state=random_state(jm, nv, rng), rng=rng)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("nphis,cross", CASES, ids=IDS)
def test_statistics_route_matches_jax(nphis, cross):
    jm, tm = models(nphis, cross, 24)
    c = problem(jm)
    jprior, _ = jm.initial_state(1, jnp.float64)
    tprior, _ = tm.initial_state(1, torch.float64)
    close_tuple(tprior, jprior)
    js = jm.make_design_stats(jnp.asarray(c["design"]),
                              jnp.asarray(c["data"]))
    ts = tm.make_design_stats(t(c["design"]), t(c["data"]), chunk=5)
    close_tuple(ts, js)
    # from here on both sides read the same statistics
    ts = design_stats_from_numpy(js)
    jstate, tstate = c["state"], noise_state_from_numpy(c["state"])
    close_tuple(tm.update_theta_stats(tstate, t(c["pm"]), t(c["pp"]), ts),
                jm.update_theta_stats(jstate, c["pm"], c["pp"], js))
    close_tuple(tm.update_noise_stats(tstate, tprior, t(c["means"]),
                                      t(c["cov"]), ts),
                jm.update_noise_stats(jstate, jprior, c["means"], c["cov"],
                                      js))
    close(tm.free_energy_stats(tstate, tprior, t(c["means"]), t(c["prec"]),
                               t(c["cov"]), t(c["pm"]), t(c["pp"]), ts),
          jm.free_energy_stats(jstate, jprior, c["means"], c["prec"],
                               c["cov"], c["pm"], c["pp"], js))


@pytest.mark.parametrize("nphis,cross", CASES, ids=IDS)
def test_generic_route_matches_jax(nphis, cross):
    """update_theta / update_noise / free_energy on Jacobian planes."""
    jm, tm = models(nphis, cross, 24)
    c = problem(jm, seed=1)
    p, nv, nt = 3, c["means"].shape[1], jm.nt
    jac = jnp.asarray(c["rng"].uniform(-1, 1, (p, nt, nv)))
    offset = jnp.asarray(c["rng"].uniform(-1, 1, (nt, nv)))
    centre = c["means"] + 0.1
    jprior, _ = jm.initial_state(1, jnp.float64)
    tprior, _ = tm.initial_state(1, torch.float64)
    jstate, tstate = c["state"], noise_state_from_numpy(c["state"])
    args = (centre, offset, jac, c["data"])
    targs = tuple(t(x) for x in args)
    close_tuple(tm.update_theta(tstate, t(c["means"]), t(c["pm"]),
                                t(c["pp"]), *targs),
                jm.update_theta(jstate, c["means"], c["pm"], c["pp"], *args))
    close_tuple(tm.update_noise(tstate, tprior, t(c["means"]), t(c["cov"]),
                                *targs),
                jm.update_noise(jstate, jprior, c["means"], c["cov"], *args))
    close(tm.free_energy(tstate, tprior, t(c["means"]), t(c["prec"]),
                         t(c["cov"]), t(c["pm"]), t(c["pp"]), *targs),
          jm.free_energy(jstate, jprior, c["means"], c["prec"], c["cov"],
                         c["pm"], c["pp"], *args))


@pytest.mark.parametrize("nphis,cross", CASES, ids=IDS)
def test_initial_state_and_mvn_round_trip_match_jax(nphis, cross):
    jm, tm = models(nphis, cross, 16)
    close_tuple(tm.initial_state(6, torch.float64)[1],
                jm.initial_state(6, jnp.float64)[1])
    assert tm.num_params == jm.num_params == jm.nalphas + nphis
    state = random_state(jm, 6, np.random.default_rng(2))
    jmeans, jcov = jm.state_to_mvn(state)
    tmeans, tcov = tm.state_to_mvn(noise_state_from_numpy(state))
    close(tmeans, jmeans)
    close(tcov, jcov)
    close_tuple(tm.state_from_mvn(jmeans, jcov),
                jm.state_from_mvn(jmeans, jcov))
    back = tm.state_from_mvn(tmeans, tcov)
    close_tuple(back, state, 1e-9)


def run_engine(data, opts_dict, device="cpu"):
    options = RunOptions(opts_dict)
    model = get_model_class(options.get_string("model"))(options)
    eng = VBInference(model, options, data, device=device)
    return eng, eng.run()


def ar_data(nv, nt, alpha, noise_sd, seed, nphis=1):
    """Linear-trend signal + AR(1) noise per echo (tests/test_ar1.py)."""
    rng = np.random.default_rng(seed)
    t_ = np.arange(1, nt + 1)
    c0 = rng.uniform(0.5, 1.5, nv)
    c1 = rng.uniform(-0.1, 0.1, nv)
    noise = np.zeros((nv, nt))
    per = nt // nphis
    for v in range(nv):
        for q in range(nphis):
            e = rng.normal(0, noise_sd, per)
            for i in range(1, per):
                e[i] += alpha * e[i - 1]
            noise[v, q::nphis] = e
    return c0[:, None] + c1[:, None] * t_[None, :] + noise, c0, c1


@pytest.mark.parametrize("nphis,cross", CASES, ids=IDS)
def test_engine_matches_dense_oracle(nphis, cross):
    """The engine (float64: the 'xla' statistics route) against the
    numpy oracle of dense T x T alpha matrices, at tests/test_ar1.py's
    bounds."""
    nt = 20 * nphis
    nalphas = {"none": 2, "same": 3, "dual": 4}[cross]
    data, _, _ = ar_data(5, nt, alpha=0.4, noise_sd=0.3, seed=0,
                         nphis=nphis)
    eng, res = run_engine(data, {
        "model": "poly", "degree": "1", "noise": "ar",
        "num-echoes": str(nphis), "ar1-cross-terms": cross,
        "max-iterations": "5", "save-free-energy": True})
    assert eng.route == "xla"
    design = np.arange(1, nt + 1, dtype=float)[:, None] ** np.arange(2)
    for v in range(data.shape[0]):
        ref = oracle_ar.ar_vb_voxel(
            data[v], design, prior_mean=np.zeros(2),
            prior_prec=np.full(2, 1e-12), niter=5, nphis=nphis,
            nalphas=nalphas, compute_f=True)
        np.testing.assert_allclose(res.means[v], ref["means"], rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(res.cov[v], ref["cov"], rtol=1e-7,
                                   atol=1e-12)
        np.testing.assert_allclose(res.noise_means[v, :nalphas],
                                   ref["alpha_means"], rtol=1e-7,
                                   atol=1e-10)
        np.testing.assert_allclose(res.noise_means[v, nalphas:],
                                   ref["phi_b"] * ref["phi_c"], rtol=1e-7)
        np.testing.assert_allclose(res.free_energy[v], ref["F"], rtol=1e-8)


@pytest.mark.parametrize("dtype,route", [("double", "xla"),
                                         ("single", "pallas-loop-ar")])
def test_recovers_ar_coefficient(dtype, route):
    """alpha_1 near the injected 0.5 and the slope near the truth, on the
    statistics route and on the AR(1) kernel's route (its plain version
    here)."""
    data, _, c1 = ar_data(40, 120, alpha=0.5, noise_sd=0.2, seed=1)
    eng, res = run_engine(data.astype(np.float32), {
        "model": "poly", "degree": "1", "noise": "ar", "num-echoes": "1",
        "max-iterations": "15", "dtype": dtype})
    assert eng.route == route
    assert abs(res.noise_means[:, 0].mean() - 0.5) < 0.12
    np.testing.assert_allclose(res.means[:, 1], c1, atol=0.05)
    assert not res.bad_voxels.any()


@pytest.mark.parametrize("extra", [
    {"num-echoes": "1", "ar1-cross-terms": "dual"},
    {"num-echoes": "3"},
    {"num-echoes": "2", "ar1-cross-terms": "bogus"},
    {"num-echoes": "1", "mt1": "3"},
    {"num-echoes": "2"},   # 13 samples: not divisible by 2 echoes
], ids=["cross-one-echo", "three-echoes", "bogus-cross", "masked",
        "odd-length"])
def test_option_validation(extra):
    nt = 13 if extra == {"num-echoes": "2"} else 12
    with pytest.raises(InvalidOptionValue):
        run_engine(np.zeros((2, nt)), {"model": "poly", "degree": "1",
                                       "noise": "ar", **extra})


def test_registry_has_ar():
    assert get_noise_class("ar") is Ar1NoiseModel
    opts = {o.name: o.default for o in Ar1NoiseModel.get_options()}
    assert opts == {o.name: o.default for o in JAr1.get_options()}
