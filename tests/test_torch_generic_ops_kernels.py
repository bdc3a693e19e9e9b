"""The kernels with the functors of tests/torch_generic_ops_models.py as
host C++ at double (tests/torch_hostcc.py), against their plain versions
at float64, to 1e-9 of each output's scale:

  kernel 6  pairs-test's full-time functor (a contraction of two
            parameter planes, an extremum over time and a stacking axis,
            values with two time axes reduced over one or both, one of
            them a constant's) in the full-time form (full_kernel_fn, a
            block's 32 threads as host threads), and mixed-test's
            per-sample functor (a constant matrix times the parameters)
            in the per-lane form (kernel_fn), each in MODEs 0-2 (maxits,
            pointzeroone, trialmode);
  kernel 7  stacked-test's functor generated from its time_signal (the
            stacked parameter planes contracted with a constant matrix),
            with and without its LM branch;
  kernel 8  the same functor, Levenberg and Marquardt, fresh, its
            iteration counts equal to the plain version's.

T=30, 96 voxels (kernel 6's detector runs and the plain versions take
most of the time). torch.set_num_threads(1), as the other port tests.
"""

import numpy as np
import pytest
import torch

from fabber_core_tpu_torch.models import base as tbase
from fabber_core_tpu_torch.models.kernelgen import (
    derive_time_local_eval, derive_time_signal_functor)
from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.ops import fused_nlls as fn
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc
from test_torch_fulltime import assert_outputs, consts, detector_dicts, \
    run_plain
from test_torch_generic_ops import JBase, JPairs
from torch_generic_models import restored

with restored(tbase._MODELS):
    import torch_generic_ops_models as om

torch.set_num_threads(1)

NT, NV = 30, 96


class JMixed(JBase):
    """om.Mixed's JAX twin (for the detectors' constants)."""

    def evaluate(self, params, ctx, key=""):
        import jax.numpy as jnp
        q = jnp.asarray(om.MIX, params.dtype) @ params
        return q[0] * jnp.exp(-q[1] * jnp.arange(ctx.nt, dtype=params.dtype)
                              * om.DT)


def case(name, seed, nq=1):
    """test_torch_fulltime.kernel_case's inputs for a model of
    torch_generic_ops_models.py (Q = 1, or Q = 2 on alternate samples;
    one masked sample)."""
    jm, tm = {"pairs-test": (JPairs(), om.Pairs()),
              "mixed-test": (JMixed(), om.Mixed())}[name]
    rng = np.random.default_rng(seed)
    m = np.stack([rng.uniform(0.5, 1.5, NV), rng.uniform(0.5, 2.0, NV)])
    sig = om.signal(name, m, NT)
    q = np.ones((1, NT)) if nq == 1 else np.stack(
        [np.arange(NT) % 2 == g for g in range(nq)]).astype(float)
    q[:, 4] = 0.0
    return dict(jm=jm, tm=tm, p=2, ns=0, nq=nq, q=q,
                data=sig + 0.02 * rng.standard_normal(sig.shape),
                supp=None,
                centre=np.log(m) + 0.05 * rng.standard_normal(m.shape),
                pm=np.zeros((2, NV)), pp=np.full((2, NV), 1e-2),
                pd0=rng.uniform(0.5, 2.0, (2, NV)),
                tle=derive_time_local_eval(tm, NT, 2))


@pytest.fixture
def gxx():
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")


KINDS = ["maxits", "pointzeroone", "trialmode"]


@pytest.mark.parametrize("name", ["pairs-test", "mixed-test"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel6_on_host_matches_plain(name, kind, tmp_path, gxx):
    """Kernel 6 with the model's generated functor (pairs-test: the
    full-time form; mixed-test: the per-lane form) at
    double against the plain version at float64, to 1e-9, 5
    iterations."""
    check_kernel6(case(name, seed=11), kind, tmp_path)


@pytest.mark.parametrize("name", ["pairs-test", "mixed-test"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel6_two_groups_on_host_matches_plain(name, kind, tmp_path,
                                                  gxx):
    """The same at Q = 2 (noise groups on alternate samples)."""
    check_kernel6(case(name, seed=12, nq=2), kind, tmp_path)


def check_kernel6(c, kind, tmp_path):
    assert c["tle"].full_time == (c["tm"].name != "mixed-test")
    _, tdet = detector_dicts(c, kind)
    if tdet is None:
        det, dcs = (0, 0.0, 0, 0, 0), np.zeros(c["nq"] + 2)
    else:
        det = _cuda.detector_args(tdet["det"])
        dcs = np.array(list(tdet["lb_coeff"])
                       + [tdet["f_const"], tdet["f_const_init"]])
    make = torch_hostcc.full_kernel_fn if c["tle"].full_time \
        else torch_hostcc.kernel_fn
    k = make(c["tle"], c["nq"], tmp_path)
    got = k([1] * c["p"], 5, True, consts(c).numpy(), det, dcs, c["centre"],
            c["pm"], c["pp"], c["pd0"], c["data"], c["supp"],
            np.ascontiguousarray(c["q"].T))
    if c["tle"].full_time:
        assert k.smem == _cuda.fulltime_smem(c["p"], c["nq"], NT,
                                             c["tle"].smem_floats)
    assert_outputs(got, run_plain(c, kind, 5))


@pytest.fixture(scope="module")
def stacked():
    model = om.Stacked()
    tle = derive_time_signal_functor(model, 2)
    assert tle is not None
    tr = [p.transform for p in tbase.resolve_parameters(model,
                                                        RunOptions({}))]
    return {"model": model, "tle": tle, "tr": tr,
            "tcodes": [fv.TRANSFORM_CODES[t.code] for t in tr]}


def stacked_case(seed):
    rng = np.random.default_rng(seed)
    m = np.stack([rng.uniform(0.5, 1.5, NV), rng.uniform(0.5, 2.0, NV)])
    data = om.signal("stacked-test", m, NT) + rng.normal(0, 0.02, (NT, NV))
    centre = np.log(m) + rng.normal(0, 0.1, m.shape)
    return {"data": data, "centre": centre, "pm": np.zeros_like(centre),
            "pp": np.full_like(centre, 1e-2)}


def near(got, ref, rel):
    ref = np.asarray(ref)
    got = np.asarray(got).reshape(ref.shape)
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("lm", [False, True], ids=["plain", "lm"])
def test_kernel7_stacked_on_host_matches_plain(lm, stacked, tmp_path, gxx):
    """Kernel 7 with the functor generated from stacked-test's
    time_signal at double: within 1e-9 of the plain version at float64,
    with and without its LM branch."""
    c = stacked_case(21)
    rng = np.random.default_rng(22)
    phi = rng.uniform(1000.0, 3000.0, (1, NV))
    q = np.ones((1, NT))
    alpha = None
    if lm:
        alpha = 10.0 ** rng.uniform(-6, 2, NV)
        alpha[::4] = 0.0
    k = torch_hostcc.vb_iter_kernel_fn(stacked["tle"], 1, tmp_path)
    got = k(True, stacked["tcodes"], om.DT, True, c["centre"], c["pm"],
            c["pp"], phi, c["data"], q.T, alpha)
    ref = fv.fused_iteration_plain(
        fv.signal_jac_fn(stacked["model"]), stacked["tr"],
        *(torch.from_numpy(c[k]) for k in ("centre", "pm", "pp")),
        torch.from_numpy(phi), torch.from_numpy(c["data"]), q, True,
        None if alpha is None else torch.from_numpy(alpha))
    for a, r in zip(got, ref):
        near(a, r.numpy(), 1e-9)


NLLS_CONSTS = [fn.LAMBDA_INIT, fn.LAMBDA_GROW, fn.LAMBDA_SHRINK,
               fn.LAMBDA_MAX, fn.PREC_DIAG_FLOOR, fn.CFTOL,
               fn.PLATEAU_LAMBDA]


@pytest.mark.parametrize("marquardt", [False, True], ids=["L", "LM"])
def test_kernel8_stacked_on_host_matches_plain(marquardt, stacked, tmp_path,
                                               gxx):
    """Kernel 8 (fresh) with the same functor at double: within 1e-9 of
    the plain version at float64, the iteration counts equal."""
    c = stacked_case(31 + marquardt)
    tmask = np.ones(NT)
    tmask[5] = 0.0
    k = torch_hostcc.nlls_kernel_fn(stacked["tle"], tmp_path)
    got = k(0, marquardt, stacked["tcodes"], om.DT, NLLS_CONSTS, 40,
            float(tmask.sum() - 2), c["centre"], c["data"], tmask, None)
    ref = fn.fused_nlls_loop_plain(
        fv.signal_jac_fn(stacked["model"]), stacked["tr"],
        torch.from_numpy(c["centre"]), torch.from_numpy(c["data"]), tmask,
        40, marquardt)
    np.testing.assert_array_equal(got[2], ref[2].numpy())
    for a, r in zip(got[:5], ref):
        near(a, r.numpy(), 1e-9)
