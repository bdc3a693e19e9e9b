"""The probe and the functor generator of the whole-loop kernel's
generic mode (fabber_core_tpu_torch/models/kernelgen.py).

  probe     the torch twins of tests/test_fused_loop_generic.py's
            models: GaussianAct, the stripped exp (scalar and strided
            parameter indexing) and SuppScaled are admitted, with the
            JAX probe (derive_time_local_eval) admitting them too;
            DataUsing, a coords user, a `ctx.data is None` presence
            check and UnsafeOp (sort) are rejected by both; cumsum is
            rejected by both; a flip and a sum over time are rejected by
            the per-sample walk and admitted by the full-time walk, as the
            JAX probe admits them (tests/test_torch_fulltime.py holds
            those functors);
  functor   the generated C++ compiled as host C++ with g++ at double
            (tests/torch_hostcc.py; skipped without g++): its signal
            and model-space Jacobian against the model's evaluate and
            torch.func.jacfwd at float64, to 1e-12 relative, for the
            admitted models, for a model using most of the allowlist
            away from its kinks, and for a functor generated from a
            time_signal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.models import base as jbase
from fabber_core_tpu.models.base import derive_time_local_eval as jderive
from fabber_core_tpu_torch.models import base as tbase
from fabber_core_tpu_torch.models.base import EvalContext
from fabber_core_tpu_torch.models.kernelgen import (
    derive_time_local_eval, derive_time_signal_functor)
from fabber_core_tpu_torch.options import RunOptions

import test_fused_loop_generic as jgen
import torch_hostcc
from torch_generic_models import (CoordsUsing, CumSum, DataUsing, Flip,
                                  GaussianAct, KitchenSink, PresenceCheck,
                                  StridedExp, SumOverTime, SuppScaled,
                                  UnsafeOp, restored, stripped_exp)

torch.set_num_threads(1)

NT = 30


def supp_probe_args(nsupp):
    return [jnp.float32] + ([nsupp] if nsupp else [])


@pytest.mark.parametrize("cls,nsupp", [
    (GaussianAct, 0), (SuppScaled, 2), (StridedExp, 0), ("stripped", 0)],
    ids=["gaussact", "suppscaled", "strided", "stripped-exp"])
def test_probe_admits_time_local_models(cls, nsupp):
    model = stripped_exp() if cls == "stripped" else cls()
    tle = derive_time_local_eval(model, NT, 4, nsupp)
    assert tle is not None and tle.nsupp == nsupp and tle.nparams == 4
    assert "struct GenModel" in tle.source and tle.value_ops > 0
    rng = np.random.default_rng(0)
    pvec = torch.as_tensor(rng.uniform(0.5, 1.5, 4))
    supp = [torch.as_tensor(rng.uniform(0.8, 1.2, nsupp))] if nsupp else []
    expect = model.evaluate(pvec, EvalContext(
        suppdata=supp[0] if supp else None, nt=NT))
    np.testing.assert_array_equal(tle(pvec, *supp).numpy(), expect.numpy())
    if cls in (GaussianAct, SuppScaled):
        jm = {GaussianAct: jgen.GaussianActModel,
              SuppScaled: jgen.SuppScaledModel}[cls]()
        assert jderive(jm, NT, 4, *supp_probe_args(nsupp)) is not None


@pytest.mark.parametrize("cls,jcls", [
    (DataUsing, jgen.DataUsingModel), (CoordsUsing, None),
    (PresenceCheck, None), (UnsafeOp, jgen.UnsafeOpModel), (CumSum, None),
    (Flip, None), (SumOverTime, None)],
    ids=["data", "coords", "presence", "sort", "cumsum", "flip",
         "sum-over-time"])
def test_probe_rejects(cls, jcls):
    """Rejected by both probes; a time-mixing model (a flip, a sum over
    time) is rejected by the per-sample walk alone, and takes the
    full-time walk's functor."""
    tle = derive_time_local_eval(cls(), NT, 4)
    if cls in (Flip, SumOverTime):
        assert tle is not None and tle.full_time
    else:
        assert tle is None
    if jcls is not None:
        assert jderive(jcls(), NT, 4, jnp.float32) is None


def test_probe_time_mixing_against_jax():
    """The JAX probe admits what Mosaic lowers (rev, reduce_sum), so a
    flip or a sum over time is admitted by both, the port's as a
    full-time functor with the JAX count of time planes; cumsum is
    refused by both."""
    import jax.numpy as jnp_

    class JFlip(jgen.GaussianActModel):
        def evaluate(self, params, ctx, key=""):
            return super().evaluate(params, ctx)[::-1]

    class JSum(jgen.GaussianActModel):
        def evaluate(self, params, ctx, key=""):
            s = super().evaluate(params, ctx)
            return s - jnp_.mean(s)

    class JCum(jgen.GaussianActModel):
        def evaluate(self, params, ctx, key=""):
            return jnp_.cumsum(super().evaluate(params, ctx))

    for jm, tm in ((JFlip(), Flip()), (JSum(), SumOverTime())):
        jf = jderive(jm, NT, 4, jnp.float32)
        tle = derive_time_local_eval(tm, NT, 4)
        assert jf is not None and tle is not None and tle.full_time
        assert tle.time_planes == jf.time_planes
    assert jderive(JCum(), NT, 4, jnp.float32) is None
    assert derive_time_local_eval(CumSum(), NT, 4) is None


@pytest.fixture
def gxx():
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")


def check_functor(tle, model_fn, nsupp, tmp_path, pvecs):
    fn = torch_hostcc.functor_fn(tle, tmp_path)
    rng = np.random.default_rng(3)
    for pvec in pvecs:
        supp = rng.uniform(0.8, 1.2, nsupp) if nsupp else None
        p = torch.as_tensor(pvec, dtype=torch.float64)
        extra = [torch.as_tensor(supp)] if nsupp else []
        sig = model_fn(p, *extra).numpy()
        jac = torch.func.jacfwd(model_fn)(p, *extra).numpy()    # [T,P]
        for t in range(NT):
            s, j = fn(pvec, supp, t)
            scale = max(1.0, abs(sig[t]))
            assert abs(s - sig[t]) <= 1e-12 * scale, (t, s, sig[t])
            np.testing.assert_allclose(
                j, jac[t], rtol=1e-12,
                atol=1e-12 * max(1.0, np.abs(jac[t]).max()))


@pytest.mark.parametrize("cls,nsupp", [
    (GaussianAct, 0), (SuppScaled, 2), (StridedExp, 0),
    ("stripped", 0), (KitchenSink, 0)],
    ids=["gaussact", "suppscaled", "strided", "stripped-exp",
         "kitchen-sink"])
def test_generated_functor_matches_jacfwd(cls, nsupp, tmp_path, gxx):
    model = stripped_exp() if cls == "stripped" else cls()
    tle = derive_time_local_eval(model, NT, 4, nsupp)
    assert tle is not None
    rng = np.random.default_rng(1)
    check_functor(tle, tle.fn, nsupp, tmp_path,
                  [rng.uniform(0.6, 1.4, 4) for _ in range(3)])


def test_time_signal_functor_matches_jacfwd(tmp_path, gxx):
    """A functor generated from a time_signal (P scalar planes and a
    scalar t): the torch myexp plugin at two components (its import
    registers myexp: both registries are put back)."""
    with restored(tbase._MODELS, jbase._MODELS):
        from fabber_core_tpu_torch.examples.fwdmodel_exp import MyExpModel
    model = MyExpModel(RunOptions({"dt": "0.05", "num-exps": "2"}))
    tle = derive_time_signal_functor(model, 4)
    assert tle is not None and tle.fn is None

    def signal(p):
        t = torch.arange(NT, dtype=p.dtype)[:, None]
        return model.time_signal([p[i].reshape(1, 1) for i in range(4)],
                                 t)[:, 0]

    check_functor(tle, signal, 0, tmp_path,
                  [np.array([1.5, 0.5, 1.0, 5.0])])
