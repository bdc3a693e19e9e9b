"""The NLLS kernel's plain version (ops/fused_nlls.py
fused_nlls_loop_plain, what the wrapper runs on CPU tensors) against the
JAX package's Pallas kernel make_fused_nlls_loop run interpreted, on
the same inputs: data = model(truth) + N(0, 0.02^2) and a start at the
latent truth + N(0, 0.2^2), from one numpy seed; one masked timepoint;
exp (P=2), biexp (P=4, rates a decade apart) and poly degree 1 with a
log-transformed c0; Levenberg and Marquardt damping; the fresh mode,
and phase 1 followed by the resumed mode.

Both sides run at float64 (the interpreted factory takes it; the JAX
package enables x64). Tolerances: params, cost, prec and cov within
1e-9 in each lane's own scale (|x| floored at 1); iteration counts
equal in every lane except where an accept decision is a float64 tie:
at poly's optimum a Gauss-Newton step moves the cost by ~1e-16 of
itself, so summation order alone accepts or rejects it. There the
counts may differ by at most 2 where the final costs agree to 1e-12.
One float32 case is held by tests/test_nlls_stats.py's kernel bounds
(params rtol 2e-3 / atol 2e-4, cov rtol 5e-3 / atol 1e-5, iteration
counts within 30 and their median difference within 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.models.base import resolve_parameters as jresolve
from fabber_core_tpu.ops import fused_nlls as jfn
from fabber_core_tpu.ops import fused_vb as jfv
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.models import get_model_class, resolve_parameters
from fabber_core_tpu_torch.ops import fused_nlls as fn
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc

torch.set_num_threads(1)

NT, NV, DT, MAX_ITS = 24, 128, 0.1, 50

CASES = {
    # name: (model, extra options, true model-space parameters)
    "exp": ("exp", {}, [1.5, 2.0]),
    "biexp": ("biexp", {}, [1.5, 0.5, 1.5, 5.0]),
    "poly-log": ("poly", {"degree": "1", "PSP_byname1": "c0",
                          "PSP_byname1_transform": "L"}, [2.0, 0.05]),
    # num-exps 3: P = 6, the ExpSum<3> instance
    "triexp": ("exp", {"num-exps": "3"}, [1.5, 0.3, 1.0, 1.5, 0.75, 6.0]),
}


def make_case(name, dtype=np.float64, seed=0):
    model, extra, truth = CASES[name]
    o = {"model": model, "dt": str(DT), **extra}
    jm = jmodel(model)(JOptions(o))
    tm = get_model_class(model)(RunOptions(o))
    params = resolve_parameters(tm, RunOptions(o))
    rng = np.random.default_rng(seed)
    p = len(truth)
    mtruth = np.asarray(truth)[None] * rng.uniform(0.7, 1.3, (NV, p))
    t = fv.time_index(NT, torch.float64, "cpu")
    sig = tm.time_signal([torch.as_tensor(mtruth[:, i][None])
                          for i in range(p)], t).expand(NT, NV).numpy()
    latent = np.stack([np.asarray(pr.transform.to_latent(
        torch.as_tensor(mtruth[:, i]))) for i, pr in enumerate(params)])
    tmask = np.ones(NT)
    tmask[5] = 0.0
    return dict(
        jm=jm, tm=tm, p=p, tmask=tmask, dtype=dtype,
        jtr=[x.transform for x in jresolve(jm, JOptions(o))],
        tr=[x.transform for x in params],
        data=(sig + 0.02 * rng.standard_normal((NT, NV))).astype(dtype),
        p0=(latent + 0.2 * rng.standard_normal((p, NV))).astype(dtype))


def run_jax(c, max_its, marquardt, p0=None, state=None, posterior=True):
    """The interpreted Pallas kernel (its padded time axis: edge rows of
    weight 0; one block of NV voxels)."""
    tp = jfv.pad_time(NT)
    data = jnp.pad(jnp.asarray(c["data"]), ((0, tp - NT), (0, 0)),
                   mode="edge")
    run = jfn.make_fused_nlls_loop(
        c["jm"].time_signal, c["jtr"], c["p"], NT, max_its, NV,
        jnp.dtype(c["dtype"]).type, c["tmask"], marquardt=marquardt,
        block=NV, interpret=True, time_signal_jac=c["jm"].time_signal_jac,
        resume=state is not None, posterior=posterior)
    p0 = c["p0"] if p0 is None else p0
    args = (jnp.asarray(p0), data)
    if state is not None:
        args += (jnp.asarray(state),)
    return [np.asarray(x) for x in run(*args)]


def run_port(c, max_its, marquardt, p0=None, state=None, posterior=True):
    p0 = c["p0"] if p0 is None else p0
    out = fn.fused_nlls_loop(
        c["tm"], c["tr"], torch.from_numpy(np.array(p0)),
        torch.from_numpy(c["data"]), c["tmask"], max_its, marquardt,
        None if state is None else torch.from_numpy(np.array(state)),
        posterior)
    return [x.numpy() for x in out]


def lane_err(got, ref):
    """Largest error over |ref| floored at 1."""
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)))


def assert_f64_match(got, ref, its_row=2, cost_row=1, max_cond=None):
    """params/cost/prec/cov to 1e-9; iteration counts per the module
    docstring's tie rule. max_cond: cov (row 4) only on the lanes whose
    precision (row 3) has a condition number at most max_cond; on the
    rest the inverse turns float64 rounding into errors of that
    condition's order, on both sides (a sum of three exponentials: lanes
    of condition 3e7-4e8 had covariances 0.1-15 of their sd apart, each
    as far from numpy's inverse of the same precision), so prec holds
    them."""
    keep = slice(None)
    if max_cond is not None:
        p = ref[3].shape[0]
        pr = np.asarray(ref[3]).reshape(p, p, -1)
        keep = np.array([np.linalg.cond(pr[:, :, v]) <= max_cond
                         for v in range(pr.shape[-1])])
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        if k == 4:
            g, r = g[..., keep], r[..., keep]
        if k != its_row:
            assert lane_err(g, r) < 1e-9
    its_g, its_r = got[its_row], ref[its_row]
    tie = its_g != its_r
    assert np.all(np.abs(its_g - its_r)[tie] <= 2)
    cost_g, cost_r = got[cost_row], ref[cost_row]
    assert np.all(np.abs(cost_g - cost_r)[tie]
                  <= 1e-12 * np.abs(cost_r)[tie])


@pytest.mark.parametrize("name,marquardt", [
    ("exp", False), ("biexp", False), ("biexp", True), ("poly-log", True),
    ("triexp", False)],
    ids=["exp-L", "biexp-L", "biexp-LM", "poly-log-LM", "triexp-L"])
def test_fresh_matches_jax_kernel_float64(name, marquardt):
    c = make_case(name)
    ref = run_jax(c, MAX_ITS, marquardt)
    before = fn.fused_nlls_loop.launches
    got = run_port(c, MAX_ITS, marquardt)
    assert fn.fused_nlls_loop.launches == before   # plain on the CPU
    assert_f64_match(got, ref, max_cond=1e6 if name == "triexp" else None)
    assert np.isfinite(got[0]).all()
    # lanes differ in optimizer effort; none exceeds the budget
    assert len(np.unique(got[2])) > 1 and got[2].max() <= MAX_ITS
    if name != "poly-log":
        np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("marquardt", [False, True], ids=["L", "LM"])
def test_phase1_and_resume_match_jax_kernel_float64(marquardt):
    """Phase 1 capped at 3 steps (some lanes done, most not), then the
    resumed mode from the JAX kernel's phase-1 state on both sides; and
    the port's phase 1 + resume equal to its fresh run bit for bit (each
    lane's carry continues exactly; the two-pass form recomputes the
    statistics the one-pass form carried, in the same order)."""
    c = make_case("biexp", seed=3)
    cap = 3
    j1 = run_jax(c, cap, marquardt, posterior=False)
    t1 = run_port(c, cap, marquardt, posterior=False)
    assert lane_err(t1[0], j1[0]) < 1e-9
    np.testing.assert_array_equal(t1[1][2:], j1[1][2:])     # done, its
    assert lane_err(t1[1][:2], j1[1][:2]) < 1e-9             # lam, cost
    assert 0.0 < j1[1][2].mean() < 0.7   # phase 1 leaves lanes unfinished
    j2 = run_jax(c, MAX_ITS - cap, marquardt, p0=j1[0], state=j1[1])
    t2 = run_port(c, MAX_ITS - cap, marquardt, p0=j1[0], state=j1[1])
    assert_f64_match(t2, j2)
    np.testing.assert_array_equal(t2[2], j2[2])

    fresh = run_port(c, MAX_ITS, marquardt)
    two = run_port(c, MAX_ITS - cap, marquardt, p0=t1[0], state=t1[1])
    for a, b in zip(two, fresh):
        np.testing.assert_array_equal(a, b)


def test_float32_matches_jax_kernel():
    c = make_case("exp", np.float32, seed=1)
    ref = run_jax(c, MAX_ITS, False)
    got = run_port(c, MAX_ITS, False)
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got[4], ref[4].reshape(got[4].shape),
                               rtol=5e-3, atol=1e-5)
    diff = np.abs(got[2] - ref[2])
    assert diff.max() <= 30 and np.median(diff) <= 4
    assert got[0].dtype == np.float32


def test_constants_match_jax():
    for name in ("LAMBDA_INIT", "LAMBDA_GROW", "LAMBDA_SHRINK",
                 "LAMBDA_MAX", "PREC_DIAG_FLOOR", "CFTOL",
                 "PLATEAU_LAMBDA"):
        assert getattr(fn, name) == getattr(jfn, name), name


def test_wrapper_checks_its_arguments():
    c = make_case("exp")
    p0 = torch.from_numpy(c["p0"])
    data = torch.from_numpy(c["data"])
    with pytest.raises(ValueError, match="resume"):
        fn.fused_nlls_loop(c["tm"], c["tr"], p0, data, c["tmask"], 5,
                           state=torch.zeros(4, NV), posterior=False)
    with pytest.raises(ValueError, match="tmask"):
        fn.fused_nlls_loop(c["tm"], c["tr"], p0, data, c["tmask"][:-1], 5)
    with pytest.raises(ValueError, match="max_its"):
        fn.fused_nlls_loop(c["tm"], c["tr"], p0, data, c["tmask"], -1)


# -- the kernel's device code on the host ---------------------------------

FUNCTORS = {"exp": "ExpSum<1>", "biexp": "ExpSum<2>",
            "poly-log": "PolyModel<2>", "triexp": "ExpSum<3>"}


@pytest.fixture
def gxx():
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")


def host_args(c):
    km = c["tm"].kernel_model()
    consts = [fn.LAMBDA_INIT, fn.LAMBDA_GROW, fn.LAMBDA_SHRINK,
              fn.LAMBDA_MAX, fn.PREC_DIAG_FLOOR, fn.CFTOL,
              fn.PLATEAU_LAMBDA]
    return ([fv.TRANSFORM_CODES[tr.code] for tr in c["tr"]], km.dt, consts,
            float(c["tmask"].sum() - c["p"]))


@pytest.mark.parametrize("name,marquardt", [
    ("exp", False), ("biexp", False), ("biexp", True), ("poly-log", True),
    ("triexp", True)],
    ids=["exp-L", "biexp-L", "biexp-LM", "poly-log-LM", "triexp-LM"])
def test_kernel_on_host_matches_plain_float64(name, marquardt, tmp_path,
                                               gxx):
    """csrc/fused_nlls.cu compiled as host C++ at double (one block of
    one lane per voxel, tests/torch_hostcc.py), in its staged and
    streamed forms: the fresh launch against the plain version at
    float64 (assert_f64_match), phase 1 (3 steps) + resume equal to the
    fresh launch, and the two forms equal bit for bit in every mode."""
    c = make_case(name, seed=3)
    tc, dt, consts, dof = host_args(c)
    runs = {}
    for staged in (True, False):
        k = torch_hostcc.nlls_kernel_fn(FUNCTORS[name], tmp_path, staged)
        fresh = k(0, marquardt, tc, dt, consts, MAX_ITS, dof, c["p0"],
                  c["data"], c["tmask"], None)
        p1 = k(1, marquardt, tc, dt, consts, 3, dof, c["p0"], c["data"],
               c["tmask"], None)
        res = k(2, marquardt, tc, dt, consts, MAX_ITS - 3, dof, p1[0],
                c["data"], c["tmask"], p1[5])
        runs[staged] = (fresh, p1, res)
        for a, b in zip(res[:5], fresh[:5]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(runs[True], runs[False]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    fresh = runs[True][0]
    ref = run_port(c, MAX_ITS, marquardt)
    got = [fresh[0], fresh[1], fresh[2], fresh[3], fresh[4]]
    assert_f64_match(got, [ref[0], ref[1], ref[2],
                           ref[3].reshape(got[3].shape),
                           ref[4].reshape(got[4].shape)],
                     max_cond=1e6 if name == "triexp" else None)
    assert 0.0 < p1_done_share(runs[True][1]) < 1.0


def p1_done_share(p1):
    return float(p1[5][2].mean())
