"""The port's plane algebra, transforms, Gamma helpers and spectral
host math against the JAX package's, at float64 (bound 1e-12: the same
operation order on the same inputs, so only the last bits may differ).
Inputs come from numpy and are handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.core import dists as jdists
from fabber_core_tpu.core import transforms as jtr
from fabber_core_tpu.ops import smallmat as jsm
from fabber_core_tpu.ops import spectral as jspec
from fabber_core_tpu_torch.core import dists as tdists
from fabber_core_tpu_torch.core import transforms as ttr
from fabber_core_tpu_torch.ops import smallmat as tsm
from fabber_core_tpu_torch.ops import spectral as tspec

torch.set_num_threads(1)
TOL = dict(rtol=1e-12, atol=1e-12)


def spd_planes(p, nv=37, seed=0):
    """[P,P,V] symmetric positive-definite planes."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((nv, p, p))
    a = m @ np.swapaxes(m, 1, 2) + p * np.eye(p)
    return np.moveaxis(a, 0, -1).copy()


def both(x):
    return jnp.asarray(x), torch.as_tensor(x)


def close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("fn", ["cholesky_planes", "cholesky_jittered",
                                "logdet", "solve", "inverse", "matvec"])
def test_smallmat_matches_jax(fn, p):
    a = spd_planes(p, seed=p)
    b = np.random.default_rng(p + 10).standard_normal((p, a.shape[-1]))
    ja, ta = both(a)
    jb, tb = both(b)
    if fn == "cholesky_planes":
        close(jsm.cholesky_planes(ja), tsm.cholesky_planes(ta))
    elif fn == "cholesky_jittered":
        (jl, jok), (tl, tok) = jsm.cholesky_jittered(ja), \
            tsm.cholesky_jittered(ta)
        close(jl, tl)
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    elif fn == "logdet":
        close(jsm.logdet_from_chol(jsm.cholesky_planes(ja)),
              tsm.logdet_from_chol(tsm.cholesky_planes(ta)))
    elif fn == "solve":
        close(jsm.solve_chol_vec(jsm.cholesky_planes(ja), jb),
              tsm.solve_chol_vec(tsm.cholesky_planes(ta), tb))
    elif fn == "inverse":
        close(jsm.inverse_from_chol(jsm.cholesky_planes(ja)),
              tsm.inverse_from_chol(tsm.cholesky_planes(ta)))
    else:
        close(jsm.matvec_planes(ja, jb), tsm.matvec_planes(ta, tb))


def test_smallmat_jitter_retry_matches_jax():
    """A singular lane is refactorized with +1e-10 on the diagonal; a
    lane that stays non-finite is flagged not ok."""
    a = spd_planes(3, nv=4)
    a[:, :, 1] = 0.0                 # singular: factorizes only jittered
    a[0, 0, 2] = -1.0                # indefinite: fails even jittered
    (jl, jok), (tl, tok) = jsm.cholesky_jittered(jnp.asarray(a)), \
        tsm.cholesky_jittered(torch.as_tensor(a))
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert tok.tolist() == [True, True, False, True]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), equal_nan=True,
                               **TOL)


@pytest.mark.parametrize("fn", ["diag_planes", "add_diag", "diag_of"])
def test_smallmat_diag_helpers_match_jax(fn):
    rng = np.random.default_rng(3)
    d = rng.standard_normal((4, 11))
    a = spd_planes(4, nv=11)
    if fn == "diag_planes":
        close(jsm.diag_planes(jnp.asarray(d)), tsm.diag_planes(torch.as_tensor(d)))
    elif fn == "add_diag":
        close(jsm.add_diag(jnp.asarray(a), jnp.asarray(d)),
              tsm.add_diag(torch.as_tensor(a), torch.as_tensor(d)))
    else:
        close(jsm.diag_of(jnp.asarray(a)), tsm.diag_of(torch.as_tensor(a)))


_DOMAIN = {"I": (-3, 3), "L": (0.1, 5), "S": (-3, 14), "F": (0.05, 0.95),
           "A": (-3, 3)}


@pytest.mark.parametrize("code", ["I", "L", "S", "F", "A"])
def test_transforms_match_jax(code):
    jt, tt = jtr.get_transform(code), ttr.get_transform(code)
    assert tt.code == code and tt.is_identity == jt.is_identity
    lo, hi = _DOMAIN[code]
    x = np.random.default_rng(7).uniform(lo, hi, 29)
    v = np.random.default_rng(8).uniform(0.01, 2.0, 29)
    for meth, arg in (("to_model", x), ("to_latent", x),
                      ("to_model_var", v), ("to_latent_var", v)):
        j = getattr(jt, meth)(jnp.asarray(arg))
        t = getattr(tt, meth)(torch.as_tensor(arg))
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL,
                                   err_msg=f"{code}.{meth}")


def test_transform_float_inputs_are_double():
    """Host-side prior setup passes Python floats; they stay float64."""
    m, v = ttr.TRANSFORM_LOG.to_latent_moments(2.0, 0.5)
    assert m.dtype == torch.float64 and v.dtype == torch.float64
    assert float(m) == pytest.approx(np.log(2.0), rel=1e-15)


def test_unknown_transform_raises():
    from fabber_core_tpu_torch.exceptions import InvalidOptionValue
    with pytest.raises(InvalidOptionValue):
        ttr.get_transform("Q")


def test_gamma_helpers_match_jax():
    rng = np.random.default_rng(5)
    b, c = rng.uniform(0.1, 3, 13), rng.uniform(0.5, 60, 13)
    for fn in ("gamma_mean", "gamma_var"):
        close(getattr(jdists, fn)(jnp.asarray(b), jnp.asarray(c)),
              getattr(tdists, fn)(torch.as_tensor(b), torch.as_tensor(c)))
    jb, jc = jdists.gamma_from_mean_var(jnp.asarray(b), jnp.asarray(c))
    tb, tc = tdists.gamma_from_mean_var(torch.as_tensor(b), torch.as_tensor(c))
    close(jb, tb)
    close(jc, tc)


def _designs():
    t = np.arange(1, 31, dtype=np.float64)
    poly = t[:, None] ** np.arange(3)[None, :]
    lin = np.stack([np.ones(30), t / 30, np.sin(t / 4), np.cos(t / 9)], 1)
    return {"poly3": (poly, np.full(3, 1e-12)), "lin4": (lin, np.full(4, 0.5))}


@pytest.mark.parametrize("name", ["poly3", "lin4"])
@pytest.mark.parametrize("masked", [False, True])
def test_spectral_basis_matches_jax(name, masked):
    d, pp = _designs()[name]
    q = np.ones(30)
    if masked:
        q[[2, 16]] = 0.0
    for j, t in zip(jspec.spectral_basis(d, q, pp),
                    tspec.spectral_basis(d, q, pp)):
        np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("p", [1, 3, 4])
def test_eigen_elbo_const_matches_jax(p):
    q = np.ones(106)
    q[5] = 0.0
    c_post = 52.000001
    assert tspec.eigen_elbo_const(q, c_post, 1e-6, 1e6, p) == \
        pytest.approx(jspec.eigen_elbo_const(q, c_post, 1e-6, 1e6, p),
                      rel=1e-15)


@pytest.mark.parametrize("n_iters", [1, 4, 10])
def test_make_spectral_loop_matches_jax(n_iters):
    """The plain-torch spectral loop against the JAX XLA loop at
    float64, same stats in."""
    d, pp = _designs()["lin4"]
    q = np.ones(30)
    rng = np.random.default_rng(n_iters)
    nv = 23
    m0 = rng.standard_normal((4, nv))
    rtqr = rng.uniform(1, 5, (1, nv))
    dtqr = 1e-3 * rng.standard_normal((4, nv))
    pm = rng.standard_normal((4, nv))
    args = (d, q, pp, n_iters, 1e-8, 50.0, 1e-6, 14.5)
    jout = jspec.make_spectral_loop(*args, jnp.float64)(
        *(jnp.asarray(x) for x in (m0, rtqr, dtqr, pm)))
    tout = tspec.make_spectral_loop(*args)(
        *(torch.as_tensor(x) for x in (m0, rtqr, dtqr, pm)))
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9,
                                   atol=1e-12)
