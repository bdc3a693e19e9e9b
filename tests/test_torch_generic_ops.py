"""Kernel 6's generic mode over the JAX probe's allowlist
(fabber_core_tpu/models/base.py _KERNEL_SAFE_PRIMITIVES): one small twin
(a JAX and a torch model, P = 2, T = 30) per family of primitives, through
both probes and both engines' route gates.

  probe     admission and time_planes equal to the JAX probe's
            (derive_time_local_eval) on every case: each reduce_* over
            time, over a non-time axis and over both; dot_general as
            time . time, time . constant, parameters . constant,
            parameters . parameters and two time axes reduced over one;
            rev, pad, slice, concatenate, select_n, clamp, integer_pow,
            erf, logistic, and constants built from iota (a rounding
            division of the index); the walk each takes (per sample or
            full time);
  route     VBInference's route against the JAX engine's with
            jax.default_backend patched to "tpu" (test_route_matches_jax's
            check): pallas-loop-nl wherever the JAX engine runs kernel 6;
  jacobian  full_eval's signal and Jacobian (the plain version kernel 6
            is held to) against the JAX twin's evaluate and jax.jacfwd at
            float64, to 1e-9;
  engine    the pairs-test model (tests/torch_generic_ops_models.py: the
            full-time forms in one evaluate) on the engine's
            auto route against the JAX engine's interpreted kernel 6 (96
            voxels, maxits, 3 iterations, test_fused_loop_nl.py's
            assert_match).

The JAX twins use lax forms where jnp wraps a jit the JAX probe refuses
(ROADMAP Queue 3 item 34). Host C++ checks of the new functors are in
tests/test_torch_fulltime.py's style at the end: the functor alone
(tests/torch_hostcc.py full_functor_fn and functor_fn) against full_eval
at float64, to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fabber_core_tpu.inference import vb as jvb_module
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models.base import DistParams as JDist
from fabber_core_tpu.models.base import Model as JModel
from fabber_core_tpu.models.base import ParamSpec as JSpec
from fabber_core_tpu.models.base import derive_time_local_eval as jderive
from fabber_core_tpu.core.transforms import TRANSFORM_LOG as JLOG
from fabber_core_tpu.ops.fused_loop_nl import pick_nl_block as jpick_nl_block
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.core.transforms import get_transform
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.models import base as tbase
from fabber_core_tpu_torch.models.base import EvalContext
from fabber_core_tpu_torch.models.kernelgen import derive_time_local_eval
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.ops.fused_loop_nl import pick_nl_block
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc
from test_fused_loop_nl import assert_match
from torch_generic_models import restored

with restored(tbase._MODELS):
    import torch_generic_ops_models as om

torch.set_num_threads(1)

NT, DT = 30, 0.05
W = np.linspace(0.5, 1.5, NT).astype(np.float32)
KMAT = np.random.default_rng(7).uniform(-0.5, 0.5, (NT, NT)).astype(
    np.float32)
MIX = om.MIX.astype(np.float32)
TW, TK, TMIX = (torch.as_tensor(x) for x in (W, KMAT, MIX))


def js(p, n):
    return p[0] * jnp.exp(-p[1] * (jnp.arange(n, dtype=p.dtype) * DT))


def ts(p, n):
    return p[0] * torch.exp(-p[1] * (torch.arange(n, dtype=p.dtype) * DT))


def _c(x, p):
    return x.to(p.dtype) if torch.is_tensor(x) else jnp.asarray(x, p.dtype)


def _rev(x):
    return lax.rev(x, (0,))


def _flip(x):
    return torch.flip(x, [0])


# name -> (JAX evaluate, torch evaluate, walk: "sample" or "full"), each
# evaluate of (params, nt); W and KMAT are for nt = NT only
CASES = {
    # reduce_sum
    "sum-time": (lambda p, n: js(p, n) * jnp.sum(js(p, n)),
                 lambda p, n: ts(p, n) * ts(p, n).sum(), "full"),
    "sum-axis": (lambda p, n: jnp.sum(jnp.stack([js(p, n), 2 * js(p, n)]), 0),
                 lambda p, n: torch.stack([ts(p, n), 2 * ts(p, n)]).sum(0),
                 "sample"),
    "sum-both": (
        lambda p, n: js(p, n) * jnp.sum(jnp.stack([js(p, n), js(p, n) ** 2])),
        lambda p, n: ts(p, n) * torch.stack([ts(p, n), ts(p, n) ** 2]).sum(),
        "full"),
    # reduce_max
    "max-time": (lambda p, n: js(p, n) - jnp.max(js(p, n)),
                 lambda p, n: ts(p, n) - ts(p, n).max(), "full"),
    "max-axis": (
        lambda p, n: jnp.max(jnp.stack([js(p, n), _rev(js(p, n))]), 0),
        lambda p, n: torch.stack([ts(p, n), _flip(ts(p, n))]).amax(0),
        "full"),
    "max-both": (
        lambda p, n: js(p, n) - jnp.max(jnp.stack([js(p, n), 2 * js(p, n)])),
        lambda p, n: ts(p, n) - torch.stack([ts(p, n), 2 * ts(p, n)]).amax(),
        "full"),
    # reduce_min
    "min-time": (lambda p, n: js(p, n) - jnp.min(js(p, n)),
                 lambda p, n: ts(p, n) - ts(p, n).amin(), "full"),
    "min-axis": (
        lambda p, n: jnp.min(jnp.stack([js(p, n), 0.5 + 0 * js(p, n)]), 0),
        lambda p, n: torch.stack([ts(p, n), 0.5 + 0 * ts(p, n)]).amin(0),
        "sample"),
    "min-both": (
        lambda p, n: js(p, n) - jnp.min(jnp.stack([js(p, n),
                                                  0.5 * _rev(js(p, n))])),
        lambda p, n: ts(p, n) - torch.stack([ts(p, n),
                                            0.5 * _flip(ts(p, n))]).min(),
        "full"),
    # reduce_prod
    "prod-time": (lambda p, n: js(p, n) * jnp.prod(1 + 0.01 * js(p, n)),
                  lambda p, n: ts(p, n) * (1 + 0.01 * ts(p, n)).prod(),
                  "full"),
    "prod-axis": (
        lambda p, n: jnp.prod(jnp.stack([js(p, n), 1 + js(p, n)]), 0),
        lambda p, n: torch.stack([ts(p, n), 1 + ts(p, n)]).prod(0), "sample"),
    "prod-both": (
        lambda p, n: js(p, n) * jnp.prod(jnp.stack([1 + 0.01 * js(p, n),
                                                   1 - 0.01 * js(p, n)])),
        lambda p, n: ts(p, n) * torch.stack([1 + 0.01 * ts(p, n),
                                            1 - 0.01 * ts(p, n)]).prod(),
        "full"),
    # dot_general
    "dot-time-time": (
        lambda p, n: js(p, n) / jnp.sqrt(jnp.dot(js(p, n), js(p, n))),
        lambda p, n: ts(p, n) / torch.sqrt(torch.dot(ts(p, n), ts(p, n))),
        "full"),
    "dot-time-const": (
        lambda p, n: js(p, n) * jnp.dot(js(p, n), _c(W, p)),
        lambda p, n: ts(p, n) * torch.dot(ts(p, n), _c(TW, p)), "full"),
    "matmul-time-const": (lambda p, n: js(p, n) @ _c(KMAT, p),
                          lambda p, n: ts(p, n) @ _c(TK, p), "full"),
    "dot-param-const": (
        lambda p, n: (lambda q: q[0] * jnp.exp(
            -q[1] * jnp.arange(n, dtype=p.dtype) * DT))(_c(MIX, p) @ p),
        lambda p, n: (lambda q: q[0] * torch.exp(
            -q[1] * torch.arange(n, dtype=p.dtype) * DT))(_c(TMIX, p) @ p),
        "sample"),
    "dot-param-param": (lambda p, n: js(p, n) * jnp.dot(p, p),
                        lambda p, n: ts(p, n) * torch.dot(p, p), "sample"),
    "outer-sum": (lambda p, n: jnp.sum(jnp.outer(js(p, n), js(p, n)), 0),
                  lambda p, n: torch.outer(ts(p, n), ts(p, n)).sum(0),
                  "full"),
    "pairs-mean": (
        lambda p, n: jnp.mean(jnp.exp(
            -(js(p, n)[:, None] - js(p, n)[None, :]) ** 2), 1),
        lambda p, n: torch.exp(
            -(ts(p, n)[:, None] - ts(p, n)[None, :]) ** 2).mean(1),
        "full"),
    "pairs-max": (
        lambda p, n: jnp.max(js(p, n)[:, None] * _rev(js(p, n))[None, :], 0),
        lambda p, n: (ts(p, n)[:, None] * _flip(ts(p, n))[None, :]).amax(0),
        "full"),
    "pairs-max-both": (
        lambda p, n: js(p, n) * jnp.max(js(p, n)[:, None]
                                        * _rev(js(p, n))[None, :]),
        lambda p, n: ts(p, n) * (ts(p, n)[:, None]
                                 * _flip(ts(p, n))[None, :]).amax(),
        "full"),
    "pairs-weights": (
        lambda p, n: jnp.sum(js(p, n)[:, None] * _c(W, p)[None, :]
                             + js(p, n)[None, :], 1),
        lambda p, n: (ts(p, n)[:, None] * _c(TW, p)[None, :]
                      + ts(p, n)[None, :]).sum(1),
        "full"),
    "pairs-const": (lambda p, n: jnp.sum(js(p, n)[:, None] * _c(KMAT, p), 0),
                    lambda p, n: (ts(p, n)[:, None] * _c(TK, p)).sum(0),
                    "full"),
    # index maps and the rest
    "rev": (lambda p, n: js(p, n) + _rev(js(p, n)),
            lambda p, n: ts(p, n) + _flip(ts(p, n)), "full"),
    "pad": (lambda p, n: lax.pad(js(p, n)[2:], jnp.asarray(0.5, p.dtype),
                                 ((1, 1, 0),)),
            lambda p, n: torch.nn.functional.pad(ts(p, n)[2:], (1, 1),
                                                 value=0.5),
            "full"),
    "slice-concat": (
        lambda p, n: jnp.concatenate([js(p, n)[n // 2:], js(p, n)[:n // 2]]),
        lambda p, n: torch.cat([ts(p, n)[n // 2:], ts(p, n)[:n // 2]]),
        "full"),
    "select": (lambda p, n: lax.select(js(p, n) > 0.5, js(p, n),
                                       jnp.full(n, 0.5, p.dtype)),
               lambda p, n: torch.where(ts(p, n) > 0.5, ts(p, n),
                                        torch.full((n,), 0.5,
                                                   dtype=p.dtype)),
               "sample"),
    "clamp": (lambda p, n: lax.clamp(jnp.asarray(0.2, p.dtype), js(p, n),
                                     jnp.asarray(0.9, p.dtype)),
              lambda p, n: torch.clamp(ts(p, n), 0.2, 0.9), "sample"),
    "integer-pow": (lambda p, n: lax.integer_pow(js(p, n), 3),
                    lambda p, n: ts(p, n) ** 3, "sample"),
    "erf": (lambda p, n: lax.erf(js(p, n)),
            lambda p, n: torch.erf(ts(p, n)), "sample"),
    "logistic": (lambda p, n: lax.logistic(js(p, n)),
                 lambda p, n: torch.sigmoid(ts(p, n)), "sample"),
    "iota-floordiv": (
        lambda p, n: js(p, n) * lax.convert_element_type(
            1 + lax.div(lax.iota(jnp.int32, n), jnp.int32(4)), p.dtype),
        lambda p, n: ts(p, n) * (1 + torch.arange(n) // 4).to(p.dtype),
        "sample"),
}


class JBase(JModel):
    names = ("amp", "r")

    def __init__(self, options=None):
        pass

    def param_defaults(self):
        return [JSpec(i, n, JDist(1, 1e5), JDist(1, 1.5), transform=JLOG)
                for i, n in enumerate(self.names)]


class TBase(om._Base):
    name = "generic-ops-test"


def twin(name):
    """(JAX model, torch model) whose evaluate is CASES[name]'s."""
    jf, tf, _ = CASES[name]
    jm = type("J", (JBase,), {"evaluate": lambda s, p, c, key="":
                              jf(p, c.nt)})
    tm = type("T", (TBase,), {"evaluate": lambda s, p, c, key="":
                              tf(p, c.nt)})
    return jm(), tm()


@pytest.mark.parametrize("name", CASES)
def test_probe_matches_jax(name):
    """Both probes admit, with equal time_planes (the JAX picker's VMEM
    measure, which the port's copy of pick_nl_block reads), and the
    port's functor comes from the walk the case names."""
    jm, tm = twin(name)
    jf = jderive(jm, NT, 2, jnp.float32, 0)
    tle = derive_time_local_eval(tm, NT, 2)
    assert jf is not None and tle is not None
    assert tle.time_planes == jf.time_planes
    assert tle.full_time == (CASES[name][2] == "full")


def test_motivating_forms_at_t100():
    """The four forms the JAX probe admitted and the port refused, at
    T=100: admitted with the JAX probe's time_planes (16, 14, 20, 5)."""
    for name, planes in (("dot-time-time", 16), ("outer-sum", 14),
                         ("max-both", 20), ("dot-param-const", 5)):
        jm, tm = twin(name)
        jfn = jderive(jm, 100, 2, jnp.float32, 0)
        tle = derive_time_local_eval(tm, 100, 2)
        assert jfn is not None and tle is not None
        assert jfn.time_planes == tle.time_planes == planes


def test_rounding_division_keeps_per_sample_functor():
    """A time-local model that builds an index map from arange with a
    rounding division (floor_divide, div with rounding_mode floor and
    trunc) keeps the per-sample functor, its divisions folded or emitted
    per sample."""
    for f in (lambda p: ts(p, NT) * (1 + torch.arange(NT) // 4),
              lambda p: ts(p, NT) * torch.div(
                  torch.arange(NT, dtype=p.dtype), 3.0,
                  rounding_mode="floor"),
              lambda p: ts(p, NT) + torch.div(torch.arange(4.0) - 1.5, 2.0,
                                             rounding_mode="trunc").sum()):
        tm = type("T", (TBase,), {"evaluate": lambda s, p, c, key="", f=f:
                                  f(p)})()
        tle = derive_time_local_eval(tm, NT, 2)
        assert tle is not None and not tle.full_time
        assert tle.kernel == "nl_loop" and tle.consts is None


# -- the route against the JAX engine's ---------------------------------------

ROUTE_CASES = [n for n in CASES]


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_route_matches_jax(name, monkeypatch):
    """The port's route is the JAX engine's (its backend patched to
    "tpu", so it takes kernel 6 wherever its gate fits): pallas-loop-nl
    with the generic functor, never xla-generic."""
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    jm, tm = twin(name)
    nv = 8
    data = np.random.default_rng(0).uniform(0.5, 1.5, (nv, NT)).astype(
        np.float32)
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    o = {"model": "generic-ops-test", "noise": "white",
         "max-iterations": "10", "dtype": "single"}
    jeng = JVB(jm, JOptions({**o, "engine-kernel": "auto"}), data, coords)
    teng = VBInference(tm, RunOptions(o), data, device="cpu", coords=coords)
    assert jeng.use_nl_loop and jeng._generic_eval_fn is not None
    assert teng.route == "pallas-loop-nl", teng.route_description()
    assert teng.generic is not None
    assert teng.generic.full_time == (CASES[name][2] == "full")


# -- full_eval's Jacobian against jax.jacfwd ----------------------------------

@pytest.mark.parametrize("name", CASES)
def test_full_eval_matches_jacfwd(name):
    """full_eval (the plain version kernel 6's generic mode is held to)
    at float64: its signal the JAX twin's evaluate, its Jacobian
    jax.jacfwd's, to 1e-9 of their scale."""
    jax.config.update("jax_enable_x64", True)
    jf, tf, _ = CASES[name]
    at = np.array([1.2, 0.7])
    ref_sig = np.asarray(jf(jnp.asarray(at), NT))
    ref_jac = np.asarray(jax.jacfwd(lambda p: jf(p, NT))(
        jnp.asarray(at)))                                       # [T,P]
    ev = fv.full_eval(lambda p: tf(p, NT), [get_transform("I")] * 2)
    sig, jac = ev(torch.as_tensor(at)[:, None])
    for got, ref in ((sig[:, 0].numpy(), ref_sig),
                     (jac[:, :, 0].numpy().T, ref_jac)):
        np.testing.assert_allclose(got, ref, rtol=1e-9,
                                   atol=1e-9 * max(1.0, np.abs(ref).max()))


# -- the functors as host C++, at double --------------------------------------

@pytest.fixture
def gxx():
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")


HOST_CASES = ["dot-time-time", "dot-time-const", "matmul-time-const",
              "max-both", "min-both", "outer-sum", "pairs-mean", "pairs-max",
              "pairs-max-both", "pairs-weights", "pairs-const",
              "dot-param-const", "dot-param-param", "iota-floordiv",
              "sum-both"]


@pytest.mark.parametrize("name", HOST_CASES)
def test_functor_on_host_matches_full_eval(name, tmp_path, gxx):
    """The generated functor (a full-time one run by one host thread, a
    per-sample one sample by sample) at double against full_eval at
    float64, to 1e-9: signal and model-space Jacobian."""
    _, tf, _ = CASES[name]
    tm = twin(name)[1]
    tle = derive_time_local_eval(tm, NT, 2)
    at = np.array([1.2, 0.7])
    ev = fv.full_eval(lambda p: tf(p, NT), [get_transform("I")] * 2)
    sig, jac = ev(torch.as_tensor(at)[:, None])
    sig, jac = sig[:, 0].numpy(), jac[:, :, 0].numpy()
    if tle.full_time:
        hs, hj = torch_hostcc.full_functor_fn(tle, tmp_path)(at)
    else:
        fn = torch_hostcc.functor_fn(tle, tmp_path)
        got = [fn(at, None, t) for t in range(NT)]
        hs = np.array([g[0] for g in got])
        hj = np.array([g[1] for g in got]).T
    for got, ref in ((hs, sig), (hj, jac)):
        np.testing.assert_allclose(got, ref, rtol=1e-9,
                                   atol=1e-9 * max(1.0, np.abs(ref).max()))


# -- pairs-test on the engine against the JAX engine's kernel 6 ---------------

class JPairs(JBase):
    """om.Pairs' JAX twin."""

    def evaluate(self, params, ctx, key=""):
        t = jnp.arange(ctx.nt, dtype=params.dtype) * om.DT
        s = params[0] * jnp.exp(-params[1] * t)
        norm = s / jnp.sqrt(jnp.dot(s, s))
        top = jnp.max(jnp.stack([s, 0.5 * s]))
        dens = jnp.sum(jnp.exp(-(s[:, None] - s[None, :]) ** 2), 1)
        top2 = jnp.max(s[:, None] * lax.rev(s, (0,))[None, :])
        w = 0.5 + jnp.arange(ctx.nt, dtype=params.dtype) / (ctx.nt - 1)
        mix = jnp.sum(s[:, None] * w[None, :], 0)
        return (s + 0.2 * top * norm + 0.002 * dens + 0.1 * top2
                + 0.01 * mix)


@pytest.mark.parametrize("nt,fits", [(NT, True), (64, True), (100, False)])
def test_pairs_probe_matches_jax(nt, fits):
    """Both probes admit pairs-test with 35 time planes at every T; the
    JAX picker fits that up to T = 64, so both engines' route gates take
    kernel 6 at T=30 and 64 (chip_smoke.py's) and not at T=100."""
    tle = derive_time_local_eval(om.Pairs(), nt, 2)
    jf = jderive(JPairs(), nt, 2, jnp.float32, 0)
    assert tle is not None and tle.full_time and jf is not None
    assert tle.time_planes == jf.time_planes == 35
    for nq in (1, 2):
        for pick in (pick_nl_block, jpick_nl_block):
            assert (pick(1000, 2, nt, nq, full_eval=True, eval_planes=35)
                    is not None) == fits


def test_pairs_engine_matches_jax():
    """pairs-test on auto (pallas-loop-nl, its full-time functor, the
    plain version on the CPU) against the JAX engine's interpreted kernel
    6 in full-time mode, at float32 with test_fused_loop_nl.py's
    tolerances: 96 voxels, maxits, 3 iterations."""
    nv = 96
    rng = np.random.default_rng(2)
    m = np.stack([rng.uniform(0.5, 1.5, nv), rng.uniform(0.5, 2.0, nv)])
    sig = om.signal("pairs-test", m, NT)
    data = (sig + 0.02 * rng.standard_normal(sig.shape)).T.astype(
        np.float32)
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    o = {"model": "pairs-test", "noise": "white", "max-iterations": "3",
         "dtype": "single", "save-free-energy": True}
    jeng = JVB(JPairs(), JOptions({**o, "engine-kernel": "pallas-loop"}),
               data, coords)
    teng = VBInference(om.Pairs(), RunOptions(o), data, device="cpu",
                       coords=coords)
    assert jeng.use_nl_loop and jeng._generic_eval_fn is not None
    assert teng.route == "pallas-loop-nl" and teng.generic.full_time
    assert_match(jeng.run(), teng.run(), mean_rtol=1e-3)
