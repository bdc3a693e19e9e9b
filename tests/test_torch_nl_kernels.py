"""The plain versions of the port's nonlinear kernels against the JAX
package's Pallas kernels run interpreted, on the same inputs:

  fused_nl_loop_plain   vs make_fused_nl_loop   (the whole maxits loop)
  fused_iteration_plain vs make_fused_iteration (one VB iteration)

Inputs come from one numpy seed. The linearization centre starts near
the truth (its latent values plus a small perturbation), so both sides
iterate on the same well-determined fixed point; biexp's two rates are
kept a decade apart (0.5 and 5) for the same reason: where they meet its fixed
point is ill-conditioned and float32 summation order alone moves it
(tests/test_fused_loop_nl.py compares biexp routes by canonical sort
for that reason). Tolerances are those of tests/test_fused_loop_nl.py:
means within 5e-3 posterior sd and rtol 3e-4 (atol 1e-5); noise
(b, c and the k'Qk, trace quadratics) rtol 2e-3; the free-energy
quadratics rtol 1e-4 / atol 2e-3. prec and cov are held at rtol 2e-3.

Kernel 7 itself, compiled as host C++ at double (tests/torch_hostcc.py;
skipped without g++): its staged and streamed forms bit for bit, both
within 1e-10 of the plain version at float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.models.base import resolve_parameters as jresolve
from fabber_core_tpu.ops import fused_loop_nl as jnl
from fabber_core_tpu.ops import fused_vb as jfv
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.convert import nl_consts_from_numpy
from fabber_core_tpu_torch.models import get_model_class, resolve_parameters
from fabber_core_tpu_torch.ops import fused_loop_nl as nl
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc

torch.set_num_threads(1)

NT, NV, DT, BLOCK = 40, 200, 0.1, 128

CASES = {
    # name: (model, extra options, true model-space parameters)
    "exp": ("exp", {}, [1.5, 2.0]),
    "biexp": ("biexp", {}, [1.5, 0.5, 1.5, 5.0]),
    "poly-log": ("poly", {"degree": "1", "PSP_byname1": "c0",
                          "PSP_byname1_transform": "L"}, [2.0, 0.05]),
    # num-exps 3: P = 6, the ExpSum<3> instance
    "triexp": ("exp", {"num-exps": "3"}, [1.5, 0.3, 1.0, 1.5, 0.75, 6.0]),
}


def make_case(name, pattern="1", seed=0):
    model, extra, truth = CASES[name]
    o = {"model": model, "dt": str(DT), "noise": "white",
         "noise-pattern": pattern, **extra}
    jm = jmodel(model)(JOptions(o))
    pm_ = get_model_class(model)(RunOptions(o))
    params = resolve_parameters(pm_, RunOptions(o))
    jparams = jresolve(jm, JOptions(o))
    rng = np.random.default_rng(seed)
    p = len(truth)
    scale = rng.uniform(0.7, 1.3, (NV, p))
    mtruth = np.asarray(truth)[None, :] * scale               # [V,P] model
    t = fv.time_index(NT, torch.float64, "cpu")
    sig = pm_.time_signal([torch.as_tensor(mtruth[:, i][None, :])
                           for i in range(p)], t).expand(NT, NV).numpy()
    data = (sig + 0.02 * rng.standard_normal((NT, NV))).astype(np.float32)
    latent = np.stack([np.asarray(pr.transform.to_latent(
        torch.as_tensor(mtruth[:, i]))) for i, pr in enumerate(params)])
    centre = (latent + 0.05 * rng.standard_normal((p, NV))).astype(
        np.float32)
    nq = int(pattern[-1])
    q = np.zeros((nq, NT))
    for i in range(NT):
        q[int(pattern[i % len(pattern)]) - 1, i] = 1.0
    q[:, 5] = 0.0                                  # one masked sample
    pm = np.zeros((p, NV), np.float32)
    pp = np.full((p, NV), 1e-5, np.float32)
    return dict(jm=jm, pm_=pm_, jtr=[x.transform for x in jparams],
                tr=[x.transform for x in params], p=p, nq=nq, q=q,
                data=data, centre=centre, pm=pm, pp=pp)


def _pad(c):
    """JAX kernel inputs: edge-padded time axis and voxel axis."""
    tp = jfv.pad_time(NT)
    vp = -(-NV // BLOCK) * BLOCK

    def padv(x):
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, vp - NV)), mode="edge")

    data = jnp.pad(jnp.asarray(c["data"]), ((0, tp - NT), (0, 0)),
                   mode="edge")
    return padv, padv(data), vp


def assert_posterior(got, ref, sd):
    means, prec, cov = (np.asarray(x) for x in got[:3])
    rmeans, rprec, rcov = (np.asarray(x)[..., :NV] for x in ref[:3])
    assert np.max(np.abs(means - rmeans) / sd) < 5e-3
    np.testing.assert_allclose(means, rmeans, rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(prec.reshape(rprec.shape), rprec, rtol=2e-3,
                               atol=1e-6 * np.abs(rprec).max())
    np.testing.assert_allclose(cov.reshape(rcov.shape), rcov, rtol=2e-3,
                               atol=1e-6 * np.abs(rcov).max())


def posterior_sd(cov):
    """[P,V] posterior sd from a [P,P,V] covariance."""
    return np.sqrt(np.diagonal(np.asarray(cov), axis1=0, axis2=1)).T[:, :NV]


@pytest.mark.parametrize("need_f", [True, False])
@pytest.mark.parametrize("name,pattern,locked", [
    ("exp", "1", -1.0), ("exp", "12", -1.0), ("biexp", "1", -1.0),
    ("biexp", "12", -1.0), ("poly-log", "1", -1.0), ("exp", "1", 0.05),
], ids=["exp", "exp-12", "biexp", "biexp-12", "poly-log", "exp-locked"])
def test_nl_loop_plain_matches_jax_kernel(name, pattern, locked, need_f):
    c = make_case(name, pattern)
    p, nq, q = c["p"], c["nq"], c["q"]
    padv, jdata, vp = _pad(c)
    n_iters = 10
    ntg = q.sum(axis=1)
    jconsts = jnl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6), ntg,
                                 1e-8, 50.0, jnp.float32, nq)
    run = jnl.make_fused_nl_loop(
        c["jm"].time_signal, c["jtr"], p, NT, n_iters, vp, jnp.float32,
        need_f, q, locked_noise_stdev=locked, block=BLOCK, interpret=True,
        time_signal_jac=c["jm"].time_signal_jac)
    ref = run(padv(c["centre"]), padv(c["pm"]), padv(c["pp"]), jdata,
              jconsts)
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6), ntg,
                               1e-8, 50.0, nq)
    np.testing.assert_allclose(consts.numpy(),
                               nl_consts_from_numpy(jconsts).numpy(),
                               rtol=1e-7)
    got = nl.fused_nl_loop(
        c["pm_"], c["tr"], torch.from_numpy(c["centre"]),
        torch.from_numpy(c["pm"]), torch.from_numpy(c["pp"]),
        torch.from_numpy(c["data"]), q, consts, n_iters, need_f, locked)
    assert nl.fused_nl_loop.launches == 0
    assert_posterior(got, ref, posterior_sd(ref[2]))
    for k in (3, 4):   # b, c
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(ref[k])[:, :NV], rtol=2e-3)
    for k in (5, 6):   # F quadratics (zeros without need_f)
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(ref[k])[:, :NV], rtol=1e-4,
                                   atol=2e-3)


@pytest.mark.parametrize("need_f", [True, False])
@pytest.mark.parametrize("name,pattern", [
    ("exp", "1"), ("exp", "12"), ("biexp", "1"), ("biexp", "12"),
    ("poly-log", "1")], ids=["exp", "exp-12", "biexp", "biexp-12",
                             "poly-log"])
def test_fused_iteration_plain_matches_jax_kernel(name, pattern, need_f):
    c = make_case(name, pattern, seed=1)
    p, nq, q = c["p"], c["nq"], c["q"]
    padv, jdata, vp = _pad(c)
    rng = np.random.default_rng(2)
    phi = rng.uniform(1000.0, 3000.0, (nq, NV)).astype(np.float32)
    run = jfv.make_fused_iteration(
        c["jm"].time_signal, c["jtr"], p, NT, vp, jnp.float32, need_f, q,
        block=BLOCK, interpret=True,
        time_signal_jac=c["jm"].time_signal_jac)
    ref = run(padv(c["centre"]), padv(c["pm"]), padv(c["pp"]), padv(phi),
              jdata)
    got = fv.fused_iteration(
        c["pm_"], c["tr"], torch.from_numpy(c["centre"]),
        torch.from_numpy(c["pm"]), torch.from_numpy(c["pp"]),
        torch.from_numpy(phi), torch.from_numpy(c["data"]), q, need_f)
    assert fv.fused_iteration.launches == 0
    assert_posterior(got, ref, posterior_sd(ref[2]))
    for k in (3, 4):   # k'Qk and trace for the phi update
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(ref[k])[:, :NV], rtol=2e-3)
    for k in (5, 6):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(ref[k])[:, :NV], rtol=1e-4,
                                   atol=2e-3)


@pytest.mark.parametrize("code,x", [
    ("I", [-3.0, 0.0, 2.0]), ("L", [-3.0, 0.0, 2.0]),
    ("S", [-3.0, 0.0, 9.5, 10.0, 12.0]), ("F", [-3.0, 0.0, 2.0]),
    ("A", [-3.0, 0.0, 2.0])])
def test_chain_factor_matches_jax_jvp(code, x):
    """d to_model / d latent as jax.jvp gives it, edges included."""
    import jax
    from fabber_core_tpu.core import transforms as jt
    from fabber_core_tpu_torch.core import transforms as tt
    xs = np.asarray(x)
    _, ref = jax.jvp(jt.get_transform(code).to_model, (jnp.asarray(xs),),
                     (jnp.ones_like(jnp.asarray(xs)),))
    got = fv.chain_factor(tt.get_transform(code), torch.as_tensor(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def test_block_eval_matches_jacfwd():
    """block_eval's analytic Jacobian against autodiff of evaluate."""
    c = make_case("biexp")
    lat = torch.from_numpy(c["centre"][:, :5]).double()
    t = fv.time_index(NT, torch.float64, "cpu")
    sig, jac = fv.block_eval(c["pm_"].time_signal_jac, c["tr"], lat, t)
    from fabber_core_tpu_torch.inference.linearize import Linearizer
    params = resolve_parameters(c["pm_"], RunOptions(
        {"model": "biexp", "dt": str(DT)}))
    off, jref = Linearizer(c["pm_"], params, NT)(
        lat, torch.zeros(NT, 5, dtype=torch.float64),
        torch.zeros(3, 5, dtype=torch.float64))
    np.testing.assert_allclose(sig.numpy(), off.numpy(), rtol=1e-12)
    np.testing.assert_allclose(jac.numpy(), jref.numpy(), rtol=1e-10,
                               atol=1e-14)


def test_signal_jac_fn_differentiates_time_signal():
    """A model with a time_signal alone gets its Jacobian by
    forward-mode autodiff, equal to biexp's analytic one."""
    c = make_case("biexp")

    class SignalOnly:
        time_signal = staticmethod(c["pm_"].time_signal)

    assert fv.signal_jac_fn(c["pm_"]) == c["pm_"].time_signal_jac
    lat = torch.from_numpy(c["centre"][:, :7]).double()
    t = fv.time_index(NT, torch.float64, "cpu")
    got = fv.block_eval(fv.signal_jac_fn(SignalOnly()), c["tr"], lat, t)
    ref = fv.block_eval(c["pm_"].time_signal_jac, c["tr"], lat, t)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-13,
                                   atol=1e-15)


def well_conditioned(prec, max_cond=1e6):
    """[V] bool: lanes whose [P,P,V] precision has a condition number at
    most max_cond (where float64's covariance is determined to ~1e-10)."""
    prec = np.asarray(prec, np.float64)
    return np.array([np.linalg.cond(prec[:, :, v]) <= max_cond
                     for v in range(prec.shape[-1])])


def test_triexp_plain_matches_jax_kernels_float64():
    """exp with num-exps 3 (P = 6, the card's ExpSum<3> instance) at
    float64 and short horizons (ROADMAP Queue 3 item 7: a sum of
    exponentials is chaotic at float32, and over 10 iterations at
    float64 too, a few lanes going apart): kernel 6's plain version over
    3 iterations and kernel 7's over one, pattern 12, against the JAX
    kernels interpreted at float64. Means, precision, noise and F quadratics within 1e-9 of
    each output's max; the covariance too on the lanes whose precision
    has a condition number <= 1e6 (beyond it the inverse turns float64
    rounding into errors of the condition's order on both sides; the
    precision holds those lanes)."""
    c = make_case("triexp", "12", seed=4)
    p, nq, q = c["p"], c["nq"], c["q"]
    for k in ("data", "centre", "pm", "pp"):
        c[k] = c[k].astype(np.float64)
    padv, jdata, vp = _pad(c)
    ntg = q.sum(axis=1)
    jconsts = jnl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6), ntg,
                                 1e-8, 50.0, jnp.float64, nq)
    run = jnl.make_fused_nl_loop(
        c["jm"].time_signal, c["jtr"], p, NT, 3, vp, jnp.float64, True, q,
        block=BLOCK, interpret=True, time_signal_jac=c["jm"].time_signal_jac)
    nl_ref = run(padv(c["centre"]), padv(c["pm"]), padv(c["pp"]), jdata,
                 jconsts)
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6), ntg,
                               1e-8, 50.0, nq)
    x = {k: torch.from_numpy(c[k]) for k in ("centre", "pm", "pp", "data")}
    nl_got = nl.fused_nl_loop(c["pm_"], c["tr"], x["centre"], x["pm"],
                              x["pp"], x["data"], q, consts, 3, True)
    rng = np.random.default_rng(5)
    phi = rng.uniform(1000.0, 3000.0, (nq, NV))
    run = jfv.make_fused_iteration(
        c["jm"].time_signal, c["jtr"], p, NT, vp, jnp.float64, True, q,
        block=BLOCK, interpret=True, time_signal_jac=c["jm"].time_signal_jac)
    it_ref = run(padv(c["centre"]), padv(c["pm"]), padv(c["pp"]), padv(phi),
                 jdata)
    it_got = fv.fused_iteration(c["pm_"], c["tr"], x["centre"], x["pm"],
                                x["pp"], torch.from_numpy(phi), x["data"], q,
                                True)
    for got, ref in ((nl_got, nl_ref), (it_got, it_ref)):
        ref = [np.asarray(r)[..., :NV] for r in ref]
        keep = well_conditioned(ref[1])
        assert keep.mean() > 0.5
        for k, (g, r) in enumerate(zip(got, ref)):
            g = g.numpy().reshape(r.shape)
            if k == 2:
                g, r = g[..., keep], r[..., keep]
            assert np.abs(g - r).max() <= 1e-9 * np.abs(r).max(), k


def test_kernel_instances_and_wrapper_refusals():
    """A model without a functor has no instance (the instance list of
    csrc/vb_device.cuh is asked of the built library, on the card:
    tests/test_torch_cuda.py); the wrappers refuse what no kernel
    takes before they touch the library."""
    c = make_case("exp")
    assert not fv.kernel_instantiated(None, 1)
    with pytest.raises(ValueError, match="n_iters"):
        nl.fused_nl_loop(c["pm_"], c["tr"], torch.zeros(2, 4),
                         torch.zeros(2, 4), torch.ones(2, 4),
                         torch.zeros(NT, 4), c["q"], torch.zeros(4), 0,
                         False)
    with pytest.raises(ValueError, match="no kernel"):
        fv.kernel_args(c["pm_"], c["tr"], 1, torch.device("meta"), "vb_iter")


# -- detector modes (the whole-loop kernel's in-kernel detectors, the
#    fused iteration's LM branch) ------------------------------------------

def det_dicts(kind, n_iters, nq, extra=None):
    """The port's and the JAX package's whole-loop detector arguments for
    the same options and host ELBO constants (VBInference._nl_fdet_consts
    layout: the white ELBO at T=40, one masked sample)."""
    from fabber_core_tpu.inference.convergence import \
        get_detector_class as jget
    from fabber_core_tpu_torch.inference.convergence import \
        get_detector_class as tget
    o = {"max-iterations": str(n_iters), "max-trials": "3", **(extra or {})}
    td, jd = tget(kind)(RunOptions(dict(o))), jget(kind)(JOptions(dict(o)))
    n_q = (NT - 1) / nq
    consts = {"lb_coeff": [n_q * 0.5 + 1e-6] * nq,
              "f_const": -1.5 * NT, "f_const_init": -2.5 * NT}
    jdet = {"tol": float(getattr(jd, "min_fchange",
                                 getattr(jd, "max_fchange", 0.01))),
            "max_its": int(jd.max_iterations), "kind": kind,
            "det_obj": jd, "init_save": bool(np.asarray(
                jd.init_state(1, jnp.float32).save)[0]), **consts}
    return {"det": td, **consts}, jdet, int(td.max_iterations)


NL_DET_KINDS = ["pointzeroone", "freduce", "trialmode", "lm"]


@pytest.mark.parametrize("kind", NL_DET_KINDS)
@pytest.mark.parametrize("name,pattern", [("exp", "1"), ("exp", "12")],
                         ids=["exp", "exp-12"])
def test_nl_loop_detector_plain_matches_jax_kernel(name, pattern, kind):
    """The detector modes of the whole loop at float32 against the TPU
    kernel interpreted: per-lane iteration counts (and freduce's revert
    flags) equal; posterior, noise and per-lane F at the tolerances of
    the module docstring."""
    c = make_case(name, pattern, seed=4)
    p, nq, q = c["p"], c["nq"], c["q"]
    padv, jdata, vp = _pad(c)
    det, jdet, n_iters = det_dicts(kind, 8, nq)
    ntg = q.sum(axis=1)
    pd0 = np.random.default_rng(5).uniform(0.5, 2.0, (p, NV)).astype(
        np.float32)
    jconsts = jnl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6), ntg,
                                 1e-8, 50.0, jnp.float32, nq)
    run = jnl.make_fused_nl_loop(
        c["jm"].time_signal, c["jtr"], p, NT, n_iters, vp, jnp.float32,
        True, q, block=BLOCK, interpret=True,
        time_signal_jac=c["jm"].time_signal_jac, detector=jdet)
    ref = run(padv(c["centre"]), padv(c["pm"]), padv(c["pp"]), jdata,
              jconsts, post_var0=padv(pd0))
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6), ntg,
                               1e-8, 50.0, nq)
    got = nl.fused_nl_loop(
        c["pm_"], c["tr"], torch.from_numpy(c["centre"]),
        torch.from_numpy(c["pm"]), torch.from_numpy(c["pp"]),
        torch.from_numpy(c["data"]), q, consts, n_iters, True,
        detector=det, post_var0=torch.from_numpy(pd0))
    assert nl.fused_nl_loop.det_launches == 0
    its, jits = got[6][0].numpy(), np.asarray(ref[6])[0, :NV]
    np.testing.assert_array_equal(its, jits)
    if kind == "freduce":
        np.testing.assert_array_equal(got[5][1].numpy(),
                                      np.asarray(ref[5])[1, :NV])
    assert_posterior(got, ref, posterior_sd(ref[2]))
    for k in (3, 4):   # b, c
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(ref[k])[:, :NV], rtol=2e-3)
    np.testing.assert_allclose(got[5][0].numpy(),
                               np.asarray(ref[5])[0, :NV], rtol=1e-4,
                               atol=2e-3)


@pytest.mark.parametrize("name,pattern", [
    ("exp", "1"), ("exp", "12"), ("biexp", "1"), ("poly-log", "1")],
    ids=["exp", "exp-12", "biexp", "poly-log"])
def test_fused_iteration_lm_plain_matches_jax_kernel(name, pattern):
    """The fused iteration's LM branch (with_lm) at float32 against the
    TPU kernel interpreted: alpha 0 (the plain step) in a quarter of the
    voxels, 1e-6..1e2 elsewhere; the tolerances of the module
    docstring."""
    c = make_case(name, pattern, seed=6)
    p, nq, q = c["p"], c["nq"], c["q"]
    padv, jdata, vp = _pad(c)
    rng = np.random.default_rng(7)
    phi = rng.uniform(1000.0, 3000.0, (nq, NV)).astype(np.float32)
    alpha = (10.0 ** rng.uniform(-6, 2, NV)).astype(np.float32)
    alpha[::4] = 0.0
    run = jfv.make_fused_iteration(
        c["jm"].time_signal, c["jtr"], p, NT, vp, jnp.float32, True, q,
        block=BLOCK, with_lm=True, interpret=True,
        time_signal_jac=c["jm"].time_signal_jac)
    ref = run(padv(c["centre"]), padv(c["pm"]), padv(c["pp"]), padv(phi),
              jdata, jnp.pad(jnp.asarray(alpha), (0, vp - NV)))
    got = fv.fused_iteration(
        c["pm_"], c["tr"], torch.from_numpy(c["centre"]),
        torch.from_numpy(c["pm"]), torch.from_numpy(c["pp"]),
        torch.from_numpy(phi), torch.from_numpy(c["data"]), q, True,
        torch.from_numpy(alpha))
    assert fv.fused_iteration.lm_launches == 0
    assert_posterior(got, ref, posterior_sd(ref[2]))
    for k in (3, 4):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(ref[k])[:, :NV], rtol=2e-3)
    for k in (5, 6):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(ref[k])[:, :NV], rtol=1e-4,
                                   atol=2e-3)


# -- kernel 7 compiled as host C++ (tests/torch_hostcc.py) ------------------

FUNCTORS = {"exp": "ExpSum<1>", "biexp": "ExpSum<2>",
            "poly-log": "PolyModel<2>", "triexp": "ExpSum<3>"}


@pytest.fixture(scope="module")
def iter_host(tmp_path_factory):
    """(case name, Q) -> kernel 7 at double on the host, both forms
    (built once per module; skipped without g++)."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    libs = {}

    def get(name, nq):
        if (name, nq) not in libs:
            libs[name, nq] = torch_hostcc.vb_iter_kernel_fn(
                FUNCTORS[name], nq,
                tmp_path_factory.mktemp(f"iter{len(libs)}"))
        return libs[name, nq]
    return get


ITER_HOST = [("biexp", "1", False), ("biexp", "1", True),
             ("exp", "12", False), ("exp", "12", True),
             ("poly-log", "1", True), ("triexp", "12", True)]


@pytest.mark.parametrize("name,pattern,lm", ITER_HOST,
                         ids=[f"{n}-{p}{'-lm' if lm else ''}"
                              for n, p, lm in ITER_HOST])
def test_iteration_kernel_on_host_staged_equals_streamed(name, pattern, lm,
                                                         iter_host):
    """Kernel 7's staged form (the block's tile and weights in shared
    memory, csrc/tile.cuh) equals its streamed form bit for bit at
    double, with (LM=1: alpha 0 in a quarter of the voxels, 1e-6..1e2
    elsewhere) and without its LM branch, and both match the plain
    version at float64 within 1e-10 of each output's max."""
    c = make_case(name, pattern, seed=8)
    nq = c["nq"]
    rng = np.random.default_rng(9)
    phi = rng.uniform(1000.0, 3000.0, (nq, NV))
    alpha = None
    if lm:
        alpha = 10.0 ** rng.uniform(-6, 2, NV)
        alpha[::4] = 0.0
    km = c["pm_"].kernel_model()
    tcodes = [fv.TRANSFORM_CODES[tr.code] for tr in c["tr"]]
    f64 = [c[k].astype(np.float64) for k in ("centre", "pm", "pp")]
    fn = iter_host(name, nq)
    args = (tcodes, km.dt, True, *f64, phi, c["data"], c["q"].T, alpha)
    staged, streamed = fn(True, *args), fn(False, *args)
    for a, b in zip(staged, streamed):
        assert np.array_equal(a, b)
    ref = fv.fused_iteration_plain(
        fv.signal_jac_fn(c["pm_"]), c["tr"],
        *(torch.from_numpy(x) for x in f64), torch.from_numpy(phi),
        torch.from_numpy(c["data"]).double(), c["q"], True,
        None if alpha is None else torch.from_numpy(alpha))
    for a, r in zip(staged, ref):
        r = r.numpy()
        assert np.abs(a.reshape(r.shape) - r).max() <= \
            1e-10 * max(np.abs(r).max(), 1e-30)
