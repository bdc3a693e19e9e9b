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
            differentiates as before;
  in place  AbsInPlace and ClampInPlace (abs_ and clamp_ on a copy of
            the parameter: the functionalized trace sees abs and clamp)
            and HardTanhOffset (hardtanh(c) starting on its upper bound,
            where jax.nn.hard_tanh's tangent is 1 and torch's 0): the
            Linearizer's and full_eval's Jacobians at the kink against
            jax.jacfwd of the twin, and run_with_data of both packages,
            as above. The generic probe refuses these ops, so such a
            model runs xla-generic (the Linearizer) on every device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.api import FabberTpu as JFabber
from fabber_core_tpu.models import known_models as jknown_models
from fabber_core_tpu.models import register_model as jregister
from fabber_core_tpu.models import base as jbase
from fabber_core_tpu.models.base import DistParams as JDist
from fabber_core_tpu.models.base import Model as JModel
from fabber_core_tpu.models.base import ParamSpec as JSpec
from fabber_core_tpu_torch.api import FabberTpu
from fabber_core_tpu_torch.inference.linearize import Linearizer
from fabber_core_tpu_torch.models import (known_models, register_model,
                                          resolve_parameters)
from fabber_core_tpu_torch.models import base as tbase
from fabber_core_tpu_torch.models.kernelgen import derive_time_local_eval
from fabber_core_tpu_torch.models.kinks import JaxKinks, rewrite_kinks
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc
from torch_generic_models import (AbsAmp, AbsInPlace, ClampInPlace,
                                  ClampOffset, HardTanhOffset, MaxTie,
                                  restored)

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


class JAbsInPlace(JAbsAmp):
    name = "absinplace-test"


class JClampInPlace(JClampOffset):
    name = "clampinplace-test"


class JHardTanhOffset(JTwin):
    name = "hardtanh-test"
    PARAMS = [("a", 1.0), ("c", 1.0)]

    def evaluate(self, params, ctx, key=""):
        t = jnp.arange(ctx.nt, dtype=params.dtype) * self.dt
        return params[0] * jnp.exp(-t) + jax.nn.hard_tanh(params[1])


TWINS = {"abs": (AbsAmp, JAbsAmp), "clamp": (ClampOffset, JClampOffset),
         "amax": (MaxTie, JMaxTie)}
# twins whose kink the probe refuses (in-place ops, hardtanh): reached
# through the functionalized trace of models/kinks.py
UNPROBED = {"abs_": (AbsInPlace, JAbsInPlace),
            "clamp_": (ClampInPlace, JClampInPlace),
            "hardtanh": (HardTanhOffset, JHardTanhOffset)}
ALL_TWINS = {**TWINS, **UNPROBED}
# a point on each twin's kink (its initial centre for abs, clamp and
# hardtanh), and the jax tangent of the kinked column there (at every t)
KINKS = {"abs": [1.0, 0.0], "clamp": [1.0, 0.0], "amax": [1.0, 1.0],
         "abs_": [1.0, 0.0], "clamp_": [1.0, 0.0], "hardtanh": [1.0, 1.0]}


def jax_jacobian(name, pvec):
    jm = ALL_TWINS[name][1]()

    class Ctx:
        nt = NT
    return np.asarray(jax.jacfwd(lambda p: jm.evaluate(p, Ctx))(
        jnp.asarray(pvec, jnp.float64)))                       # [T,P]


@pytest.mark.parametrize("name", ["abs", "clamp", *UNPROBED])
def test_jax_twin_has_the_kink(name):
    """jax's rules at the kink differ from torch.func's there, so the
    tests below tell the two apart (amax's ties torch.func shares as jax
    does; only a pairwise fold, which the generated functor had, does
    not)."""
    tm = ALL_TWINS[name][0]()
    from fabber_core_tpu_torch.models.base import EvalContext
    p = torch.tensor(KINKS[name], dtype=torch.float64)
    tj = torch.func.jacfwd(
        lambda x: tm.evaluate(x, EvalContext(nt=NT)))(p).numpy()
    assert not np.allclose(tj, jax_jacobian(name, KINKS[name]))


@pytest.mark.parametrize("name", list(ALL_TWINS))
def test_linearizer_jacobian_at_kink_matches_jax(name):
    tm = ALL_TWINS[name][0]()
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


@pytest.mark.parametrize("name", list(UNPROBED))
def test_unprobed_full_eval_jacobian_at_kink_matches_jax(name):
    """full_eval of the model's evaluate itself (the probe refuses
    abs_, clamp_ and hardtanh, so there is no generated functor): the
    functionalized trace gives jax's tangent at the kink."""
    from fabber_core_tpu_torch.models.base import EvalContext
    tm = UNPROBED[name][0]()
    assert derive_time_local_eval(tm, NT, 2) is None
    params = resolve_parameters(tm, RunOptions({}))
    ev = fv.full_eval(lambda p: tm.evaluate(p, EvalContext(nt=NT)),
                      [p.transform for p in params])
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


def register_twins():
    for tm, jm in ALL_TWINS.values():
        register_model(tm)
        jregister(jm)


@pytest.fixture
def registered_twins():
    """The twins in both packages' model registries for one test; both
    registries hold what they held before once it is done."""
    with restored(tbase._MODELS, jbase._MODELS):
        register_twins()
        yield


def test_registered_twins_leave_both_registries_as_they_were():
    """The registered_twins fixture itself, driven through its set-up and
    tear-down: the twins are listed while it is set up, and afterwards
    the port lists its four built-in models again and the JAX package
    its own list (a twin left behind would be printed by the CLI's
    --listmodels in a later test of the same process)."""
    jbefore = jknown_models()
    names = {tm.name for tm, _ in ALL_TWINS.values()}
    run = registered_twins.__wrapped__()   # the fixture's own generator
    next(run)
    assert names <= set(known_models())
    assert names <= set(jknown_models())
    with pytest.raises(StopIteration):
        next(run)
    assert known_models() == ["biexp", "exp", "linear", "poly"]
    assert jknown_models() == jbefore


def twin_volume(name, shape=(4, 2, 2), seed=11):
    """The twin's signal at truths away from the kink (a in [0.8, 1.2];
    |p1| or c in [0.4, 0.9]; b in [0.5, 0.9]) plus N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    a = rng.uniform(0.8, 1.2, nv)
    x = rng.uniform(0.4, 0.9, nv) if name != "amax" \
        else rng.uniform(0.5, 0.9, nv)
    jm = ALL_TWINS[name][1]()

    class Ctx:
        nt = NT
    sig = np.stack([np.asarray(jm.evaluate(jnp.asarray([a[v], x[v]]), Ctx))
                    for v in range(nv)])
    return (sig + 0.02 * rng.standard_normal(sig.shape)).reshape(
        shape + (NT,))


@pytest.mark.parametrize("name", ["abs", "clamp", *UNPROBED])
def test_kink_twins_api_match_jax_float64(name, registered_twins):
    """Both packages' run_with_data at float64 (the CLI default; the
    port's xla-generic route, the JAX package's xla route), from the
    twins' initial centre on the kink: means, sds and noise within 1e-9
    (with torch's rules the port's |p1| never leaves 0, and its clamped
    offset takes another path)."""
    vol = twin_volume(name)
    opts = {"model": ALL_TWINS[name][0].name, "method": "vb",
            "noise": "white",
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
    moved = jd["mean_p1" if name.startswith("abs") else "mean_c"]
    assert np.abs(moved - KINKS[name][1]).min() > 0.1


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


def test_rewrite_hardtanh_at_default_bounds_only():
    """hardtanh(x) (bounds -1, 1, as jax.nn.hard_tanh) is rewritten with
    its values kept; hardtanh at other bounds has no jax counterpart and
    is left to torch's rule."""
    from torch.fx.experimental.proxy_tensor import make_fx
    f_nn = torch.nn.functional

    def f(x):
        return f_nn.hardtanh(x) + 3.0 * f_nn.hardtanh(x, -0.5, 2.0)

    gm = make_fx(f, tracing_mode="fake")(torch.zeros(6))
    assert rewrite_kinks(gm) == 1
    x = torch.tensor([-2.0, -1.0, -0.25, 0.5, 1.0, 3.0])
    torch.testing.assert_close(gm(x), f(x), rtol=0, atol=0)
    x = torch.tensor([-1.0, 1.0], dtype=torch.float64)
    g = JaxKinks(f).at(x)
    assert g is not f
    # jax's slope 1 at both of hardtanh's bounds; the (-0.5, 2) one
    # clips -1 (slope 0) and passes 1 (slope 3)
    torch.testing.assert_close(torch.func.jacfwd(g)(x).diagonal(),
                               torch.tensor([1.0, 4.0], dtype=torch.float64))
