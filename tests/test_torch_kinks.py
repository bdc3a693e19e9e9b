"""Derivatives at kinks follow jax's rules in the port, as in the JAX
package (fabber_core_tpu_torch/models/kinks.py, csrc/dual.cuh).

  twins     AbsAmp (a |p1| exp(-t dt), p1 starting on abs's kink at 0),
            ClampOffset (a exp(-t dt) + clamp(c, 0, 2), c starting on
            the lower bound) and MaxTie (amax over (a, b, b), tied at
            a == b), torch models in tests/torch_generic_models.py and
            their jax twins here;
  jacobian  the port's generic linearization (Linearizer), the generic
            plain whole loop's evaluator (ops/fused_vb.py full_eval) and
            a time_signal model's forward-mode Jacobian (signal_jac_fn)
            at the kink against jax.jacfwd of the twin, at float64;
  api       run_with_data of both packages at float64 (xla-generic: the
            Linearizer) on data from the twin: means, sds and noise
            within 1e-9;
  functor   the functor generated from the torch twin's evaluate
            (models/kernelgen.py), compiled as host C++ at double
            (tests/torch_hostcc.py, skipped without g++): its Jacobian
            at the kink equals jax.jvp's;
  remainder a model that does not trace keeps torch's rule, and
            differentiates as before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.api import FabberTpu as JFabber
from fabber_core_tpu.models import register_model as jregister
from fabber_core_tpu.models.base import DistParams as JDist
from fabber_core_tpu.models.base import Model as JModel
from fabber_core_tpu.models.base import ParamSpec as JSpec
from fabber_core_tpu_torch.api import FabberTpu
from fabber_core_tpu_torch.inference.linearize import Linearizer
from fabber_core_tpu_torch.models import register_model, resolve_parameters
from fabber_core_tpu_torch.models.kernelgen import derive_time_local_eval
from fabber_core_tpu_torch.models.kinks import JaxKinks, rewrite_kinks
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc
from torch_generic_models import AbsAmp, ClampOffset, MaxTie

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

NT = 30


class JTwin(JModel):
    dt = 0.1

    def __init__(self, options=None):
        pass

    def param_defaults(self):
        return [JSpec(i, n, JDist(m, 10), JDist(m, 5))
                for i, (n, m) in enumerate(self.PARAMS)]


class JAbsAmp(JTwin):
    name = "absamp-test"
    PARAMS = [("a", 1.0), ("p1", 0.0)]

    def evaluate(self, params, ctx, key=""):
        t = jnp.arange(ctx.nt, dtype=params.dtype) * self.dt
        return params[0] * jnp.abs(params[1]) * jnp.exp(-t)


class JClampOffset(JTwin):
    name = "clampoff-test"
    PARAMS = [("a", 1.0), ("c", 0.0)]

    def evaluate(self, params, ctx, key=""):
        t = jnp.arange(ctx.nt, dtype=params.dtype) * self.dt
        return params[0] * jnp.exp(-t) + jnp.clip(params[1], 0.0, 2.0)


class JMaxTie(JTwin):
    name = "maxtie-test"
    PARAMS = [("a", 1.0), ("b", 1.0)]

    def evaluate(self, params, ctx, key=""):
        t = jnp.arange(ctx.nt, dtype=params.dtype) * self.dt
        top = jnp.stack([params[0], params[1], params[1]]).max(0)
        return top * jnp.exp(-t) + params[1]


TWINS = {"abs": (AbsAmp, JAbsAmp), "clamp": (ClampOffset, JClampOffset),
         "amax": (MaxTie, JMaxTie)}
# a point on each twin's kink (its initial centre for abs and clamp),
# and the jax tangent of the kinked column there (at every t)
KINKS = {"abs": [1.0, 0.0], "clamp": [1.0, 0.0], "amax": [1.0, 1.0]}


def jax_jacobian(name, pvec):
    jm = TWINS[name][1]()

    class Ctx:
        nt = NT
    return np.asarray(jax.jacfwd(lambda p: jm.evaluate(p, Ctx))(
        jnp.asarray(pvec, jnp.float64)))                       # [T,P]


@pytest.mark.parametrize("name", ["abs", "clamp"])
def test_jax_twin_has_the_kink(name):
    """jax's rules at the kink differ from torch.func's there, so the
    tests below tell the two apart (amax's ties torch.func shares as jax
    does; only a pairwise fold, which the generated functor had, does
    not)."""
    tm = TWINS[name][0]()
    from fabber_core_tpu_torch.models.base import EvalContext
    p = torch.tensor(KINKS[name], dtype=torch.float64)
    tj = torch.func.jacfwd(
        lambda x: tm.evaluate(x, EvalContext(nt=NT)))(p).numpy()
    assert not np.allclose(tj, jax_jacobian(name, KINKS[name]))


@pytest.mark.parametrize("name", list(TWINS))
def test_linearizer_jacobian_at_kink_matches_jax(name):
    tm = TWINS[name][0]()
    params = resolve_parameters(tm, RunOptions({}))
    lin = Linearizer(tm, params, NT)
    nv = 3
    means = torch.tensor(KINKS[name], dtype=torch.float64)[:, None].repeat(
        1, nv)
    data = torch.zeros(NT, nv, dtype=torch.float64)
    coords = torch.zeros(3, nv, dtype=torch.float64)
    _, jac = lin(means, data, coords)
    assert lin.jacobian_fn(means, data, coords) is not lin._eval_one
    ref = jax_jacobian(name, KINKS[name])
    np.testing.assert_allclose(jac[:, :, 0].numpy().T, ref, rtol=1e-14,
                               atol=1e-14)


@pytest.mark.parametrize("name", list(TWINS))
def test_full_eval_jacobian_at_kink_matches_jax(name):
    """The generic plain whole loop's evaluator (identity transforms)."""
    tm = TWINS[name][0]()
    tle = derive_time_local_eval(tm, NT, 2)
    assert tle is not None
    params = resolve_parameters(tm, RunOptions({}))
    ev = fv.full_eval(tle.fn, [p.transform for p in params])
    latent = torch.tensor(KINKS[name], dtype=torch.float64)[:, None]
    _, jac = ev(latent)
    np.testing.assert_allclose(jac[:, :, 0].numpy().T,
                               jax_jacobian(name, KINKS[name]),
                               rtol=1e-14, atol=1e-14)


def test_time_signal_jacobian_at_kink_follows_jax():
    """signal_jac_fn's forward mode for a model with a time_signal and no
    time_signal_jac: |p1| at 0 has slope +1 (jax's), clamp at its bound
    1/2."""
    class TS:
        def time_signal(self, m, t):
            return m[0] * torch.abs(m[1]) * torch.exp(-0.1 * t) \
                + torch.clamp(m[2], min=0.0)
    fn = fv.signal_jac_fn(TS())
    rows = [torch.full((1, 4), v, dtype=torch.float64)
            for v in (2.0, 0.0, 0.0)]
    t = fv.time_index(NT, torch.float64, "cpu")
    _, jac = fn(rows, t)
    e = torch.exp(-0.1 * t)
    torch.testing.assert_close(jac[1], (2.0 * e).expand(NT, 4))
    torch.testing.assert_close(jac[2], torch.full((NT, 4), 0.5,
                                                  dtype=torch.float64))


@pytest.fixture
def registered_twins():
    for tm, jm in TWINS.values():
        register_model(tm)
        jregister(jm)


def twin_volume(name, shape=(4, 2, 2), seed=11):
    """The twin's signal at truths away from the kink (a in [0.8, 1.2];
    |p1| or c in [0.4, 0.9]; b in [0.5, 0.9]) plus N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    a = rng.uniform(0.8, 1.2, nv)
    x = rng.uniform(0.4, 0.9, nv) if name != "amax" \
        else rng.uniform(0.5, 0.9, nv)
    jm = TWINS[name][1]()

    class Ctx:
        nt = NT
    sig = np.stack([np.asarray(jm.evaluate(jnp.asarray([a[v], x[v]]), Ctx))
                    for v in range(nv)])
    return (sig + 0.02 * rng.standard_normal(sig.shape)).reshape(
        shape + (NT,))


@pytest.mark.parametrize("name", ["abs", "clamp"])
def test_kink_twins_api_match_jax_float64(name, registered_twins):
    """Both packages' run_with_data at float64 (the CLI default; the
    port's xla-generic route, the JAX package's xla route), from the
    twins' initial centre on the kink: means, sds and noise within 1e-9
    (with torch's rules the port's |p1| never leaves 0, and its clamped
    offset takes another path)."""
    vol = twin_volume(name)
    opts = {"model": TWINS[name][0].name, "method": "vb", "noise": "white",
            "max-iterations": "10", "save-mean": True, "save-std": True,
            "save-noise-mean": True}
    jd = JFabber().run_with_data(opts, {"data": vol}).data
    tfab = FabberTpu(device="cpu")
    td = tfab.run_with_data(opts, {"data": vol}).data
    keys = [k for k in jd if k.startswith(("mean_", "std_", "noise_"))]
    assert len(keys) >= 5 and sorted(td) == sorted(jd)
    for key in keys:
        np.testing.assert_allclose(td[key], jd[key], rtol=1e-9,
                                   atol=1e-9 * np.abs(jd[key]).max())
    # the kinked parameter moved off its start
    moved = jd["mean_p1" if name == "abs" else "mean_c"]
    assert np.abs(moved).min() > 0.1


@pytest.fixture
def gxx():
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")


@pytest.mark.parametrize("name", list(TWINS))
def test_generated_functor_jacobian_at_kink_matches_jax(name, tmp_path, gxx):
    tle = derive_time_local_eval(TWINS[name][0](), NT, 2)
    assert tle is not None
    fn = torch_hostcc.functor_fn(tle, tmp_path)
    ref = jax_jacobian(name, KINKS[name])
    for t in range(NT):
        _, jac = fn(np.asarray(KINKS[name]), None, t)
        np.testing.assert_allclose(jac, ref[t], rtol=1e-14, atol=1e-14)


def test_untraceable_model_keeps_torch_rule():
    """A value-dependent branch fails the fake-tensor trace: the function
    is differentiated as it is (torch's rule, ROADMAP Queue 3 item 20)."""
    def f(p):
        if bool(p[0] > 0):
            return torch.abs(p[1]) * p[0]
        return p[1]

    p = torch.tensor([2.0, 0.0], dtype=torch.float64)
    g = JaxKinks(f).at(p)
    assert g is f
    jac = torch.func.jacfwd(g)(p)
    torch.testing.assert_close(jac, torch.tensor([0.0, 0.0],
                                                 dtype=torch.float64))


def test_rewrite_keeps_values():
    """The rewritten graph computes the traced function's values (away
    from -0.0) and counts what it rewrote."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def f(x):
        return (torch.abs(x) + torch.clamp(x, -0.5, 0.5)
                + torch.clamp_min(x, 0.1) + torch.clamp_max(x, 0.2))

    gm = make_fx(f, tracing_mode="fake")(torch.zeros(5))
    assert rewrite_kinks(gm) == 4
    x = torch.tensor([-1.0, -0.5, 0.0, 0.3, 2.0])
    torch.testing.assert_close(gm(x), f(x), rtol=0, atol=0)
