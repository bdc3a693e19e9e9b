"""Kernel 6's full-time form in the port: models that mix the time axis
(tests/torch_fulltime_models.py) on the whole-loop route through a
functor of models/kernelgen.py's full-time walk
(csrc/fused_nl_loop.cuh fused_nl_loop_full_kernel, csrc/fulltime.cuh).

  probe    the port's walk admits exactly where the JAX probe
           (derive_time_local_eval) does, with equal time_planes: the
           centred biexponential (P=4), the convolution (P=2) with the
           matrix it closes over and with one built from the sample index
           (conviota: the form whose JAX twin the JAX kernel can run, its
           pallas_call refusing a constant the model closes over), the
           convolution and the shift (P=2) scaled by suppdata, a flip
           (lax.rev) and a pad (lax.pad) are admitted, as full-time
           functors; cumsum, sort, a gather by a tensor index, a conv1d and
           a data-using model are refused by both;
  gate     the route against the JAX engine's flags (use_nl_loop,
           _generic_eval_fn) with jax.default_backend patched to "tpu",
           over the detectors and Q 1-2;
  plain    fused_nl_loop's plain version on a full-time functor against
           the JAX make_fused_nl_loop(evaluate_fn=..., interpret=True) at
           float64, to 1e-9;
  host     the full-time kernel compiled as host C++ at double
           (tests/torch_hostcc.py full_kernel_fn: a block's 32 threads as
           host threads) against the plain version at float64, to 1e-9 in
           MODEs 0-2, and its block's bytes against ops/_cuda.py
           fulltime_smem;
  engine   VBInference(device="cpu") on auto against the JAX engine on
           engine-kernel=pallas-loop (its kernel 6 interpreted, full-time
           mode) at float32 with test_fused_loop_nl.py's assert_match:
           maxits, pointzeroone, trialmode with suppdata, noise-pattern=12,
           the centred biexponential at 3 iterations;
  card     the card's gate with the device stood in: the full-time build
           ("nl_loop_full") at construction, nothing built for a refused
           model, and a block past shared memory raising before any build;
  kinks    full_eval's Jacobian of time-mixing models at jax's kinks (an
           amax tie over time, abs at 0 under a convolution) against
           jax.jacfwd of the JAX twins.

Shapes: 96 voxels, T=30 (the JAX kernel's interpreted runs take most of
the time). torch.set_num_threads(1), as the other port tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fabber_core_tpu.inference import vb as jvb_module
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import base as jbase
from fabber_core_tpu.models.base import DistParams as JDist
from fabber_core_tpu.models.base import Model as JModel
from fabber_core_tpu.models.base import ParamSpec as JSpec
from fabber_core_tpu.models.base import derive_time_local_eval as jderive
from fabber_core_tpu.core.transforms import TRANSFORM_LOG as JLOG
from fabber_core_tpu.ops import fused_loop_nl as jnl
from fabber_core_tpu.ops import fused_vb as jfv
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.models import base as tbase
from fabber_core_tpu_torch.models.base import EvalContext
from fabber_core_tpu_torch.models.kernelgen import derive_time_local_eval
from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.ops import fused_loop_nl as nl
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc
from test_fused_loop_nl import assert_match
from torch_generic_models import restored

with restored(tbase._MODELS):
    import torch_fulltime_models as fm

torch.set_num_threads(1)

NT, NV = 30, 96
DT = fm.DT


# -- the JAX twins ------------------------------------------------------------

class JBase(JModel):
    names = ()

    def __init__(self, options=None):
        pass

    def param_defaults(self):
        return [JSpec(i, n, JDist(1, 1e5), JDist(1, 1.5), transform=JLOG)
                for i, n in enumerate(self.names)]

    @staticmethod
    def time(params, ctx):
        return jnp.arange(ctx.nt, dtype=params.dtype) * DT


class JCentred(JBase):
    names = ("amp1", "r1", "amp2", "r2")

    def evaluate(self, params, ctx, key=""):
        t = self.time(params, ctx)
        s = (params[0] * jnp.exp(-params[1] * t)
             + params[2] * jnp.exp(-params[3] * t))
        return s - jnp.mean(s)


class JConv(JBase):
    names = ("ktrans", "kep")

    def evaluate(self, params, ctx, key=""):
        t = self.time(params, ctx)
        return jnp.asarray(fm.conv_matrix(ctx.nt)) @ (
            params[0] * jnp.exp(-params[1] * t))


class JSuppConv(JConv):
    def evaluate(self, params, ctx, key=""):
        return ctx.suppdata[0] * super().evaluate(params, ctx) \
            + ctx.suppdata[1]


class JConvIota(JConv):
    """JConv with its matrix built from iota: the form the JAX kernel runs
    (its pallas_call refuses the constant JConv closes over)."""

    def evaluate(self, params, ctx, key=""):
        k = jnp.arange(ctx.nt, dtype=params.dtype)
        lag = (k[:, None] - k[None, :]) * DT
        x = jnp.maximum(lag, 0.0) / 0.5
        # lax.select: jnp.where traces to a jit the JAX probe refuses
        lmat = lax.select(lag >= 0, DT * x * jnp.exp(1.0 - x),
                          jnp.zeros_like(lag))
        return lmat @ (params[0] * jnp.exp(-params[1] * k * DT))


class JShift(JBase):
    names = ("amp", "r")

    def evaluate(self, params, ctx, key=""):
        s = params[0] * jnp.exp(-params[1] * self.time(params, ctx))
        return jnp.concatenate([jnp.zeros(fm.SHIFT, s.dtype),
                                s[:ctx.nt - fm.SHIFT]])


class JSuppShift(JShift):
    def evaluate(self, params, ctx, key=""):
        return ctx.suppdata[0] * super().evaluate(params, ctx) \
            + ctx.suppdata[1]


class SuppShift(fm.Shifted):
    name = "suppshift-fulltime"

    def evaluate(self, params, ctx, key=""):
        return ctx.suppdata[0] * super().evaluate(params, ctx) \
            + ctx.suppdata[1]


def _jexp(params, ctx):
    return params[0] * jnp.exp(-params[1] * JBase.time(params, ctx))


def _texp(params, ctx):
    t = torch.arange(ctx.nt, dtype=params.dtype) * DT
    return params[0] * torch.exp(-params[1] * t)


def twin(name, jfn, tfn):
    """A JAX and a torch model (P = 2) whose evaluate is jfn / tfn."""
    jcls = type(f"J{name}", (JBase,), {"names": ("amp", "r"),
                                       "evaluate": lambda s, p, c, key="":
                                       jfn(p, c)})
    tcls = type(f"T{name}", (fm.Shifted,), {"name": f"{name}-fulltime",
                                            "evaluate": lambda s, p, c,
                                            key="": tfn(p, c)})
    return jcls(), tcls()


IDX = np.arange(NT)[::-1].copy()
# a constant weight per sample (made here: a tensor made inside a trace
# would be a fake one)
WEIGHTS = {nt: np.linspace(0.5, 1.5, nt).astype(np.float32)
           for nt in (NT, 100)}
TWEIGHTS = {nt: torch.as_tensor(w) for nt, w in WEIGHTS.items()}
EXTRA_TWINS = {
    "flip": (lambda p, c: _jexp(p, c) + lax.rev(_jexp(p, c), (0,)),
             lambda p, c: _texp(p, c) + torch.flip(_texp(p, c), [0])),
    "pad": (lambda p, c: lax.pad(_jexp(p, c)[2:], jnp.float32(0.5),
                                 ((1, 1, 0),)),
            lambda p, c: torch.nn.functional.pad(_texp(p, c)[2:], (1, 1),
                                                 value=0.5)),
    "first": (lambda p, c: _jexp(p, c) / _jexp(p, c)[:1],
              lambda p, c: _texp(p, c) / _texp(p, c)[:1]),
    "weights": (lambda p, c: _jexp(p, c) * jnp.asarray(WEIGHTS[c.nt]),
                lambda p, c: _texp(p, c) * TWEIGHTS[c.nt]),
    "fill": (lambda p, c: jnp.concatenate([p[0] * jnp.ones(3, p.dtype),
                                           _jexp(p, c)[:c.nt - 3]]),
             lambda p, c: torch.cat([p[0] * torch.ones(3, dtype=p.dtype),
                                     _texp(p, c)[:c.nt - 3]])),
    "amax": (lambda p, c: _jexp(p, c) - jnp.max(_jexp(p, c)),
             lambda p, c: _texp(p, c) - _texp(p, c).amax()),
    "cumsum": (lambda p, c: jnp.cumsum(_jexp(p, c)),
               lambda p, c: torch.cumsum(_texp(p, c), 0)),
    "sort": (lambda p, c: jnp.sort(_jexp(p, c)),
             lambda p, c: torch.sort(_texp(p, c)).values),
    "gather": (lambda p, c: _jexp(p, c)[jnp.asarray(IDX)],
               lambda p, c: _texp(p, c)[torch.as_tensor(IDX)]),
    "conv1d": (lambda p, c: jnp.convolve(_jexp(p, c), jnp.ones(3),
                                         mode="same"),
               lambda p, c: torch.nn.functional.conv1d(
                   _texp(p, c)[None, None], torch.ones(1, 1, 3),
                   padding=1)[0, 0]),
    "data": (lambda p, c: _jexp(p, c) + 0.0 * c.data,
             lambda p, c: _texp(p, c) + 0.0 * c.data),
}
ADMITTED = ("flip", "pad", "first", "weights", "fill", "amax")


def twins(name):
    """(JAX model, torch model, P, S suppdata values)."""
    if name in EXTRA_TWINS:
        return (*twin(name, *EXTRA_TWINS[name]), 2, 0)
    return {"centred": (JCentred(), fm.CentredBiexp(), 4, 0),
            "conv": (JConv(), fm.ToftsConv(), 2, 0),
            "conviota": (JConvIota(), fm.ToftsConvIota(), 2, 0),
            "suppconv": (JSuppConv(), fm.SuppConv(), 2, 2),
            "shift": (JShift(), fm.Shifted(), 2, 0),
            "suppshift": (JSuppShift(), SuppShift(), 2, 2)}[name]


MODELS = ("centred", "conv", "conviota", "suppconv", "shift", "suppshift")


@pytest.mark.parametrize("name", MODELS + tuple(EXTRA_TWINS))
@pytest.mark.parametrize("nt", [NT, 100])
def test_probe_matches_jax(name, nt):
    jm, tm, p, ns = twins(name)
    jf = jderive(jm, nt, p, jnp.float32, ns)
    tle = derive_time_local_eval(tm, nt, p, ns)
    assert (tle is not None) == (jf is not None)
    assert (tle is not None) == (name in MODELS + ADMITTED)
    if tle is None:
        return
    assert tle.full_time and tle.kernel == "nl_loop_full"
    assert tle.time_planes == jf.time_planes
    rng = np.random.default_rng(0)
    pv = torch.as_tensor(rng.uniform(0.5, 1.5, p))
    sv = [torch.as_tensor(rng.uniform(0.8, 1.2, ns))] if ns else []
    expect = tm.evaluate(pv, EvalContext(suppdata=sv[0] if sv else None,
                                         nt=nt))
    np.testing.assert_array_equal(tle(pv, *sv).numpy(), expect.numpy())


def test_time_local_models_keep_per_sample_functor():
    """The per-sample walk comes first: a time-local evaluate keeps its
    per-sample functor and kernel."""
    from torch_generic_models import GaussianAct
    tle = derive_time_local_eval(GaussianAct(), NT, 4)
    assert not tle.full_time and tle.kernel == "nl_loop"
    assert "signal(const S* m" in tle.source and tle.consts is None


# -- the route gate -------------------------------------------------------------

def model_data(name, nv=NV, seed=0, nt=NT):
    """(data [V,T] float32, suppdata [V,2] or None, truths [P,V]) of a
    model from a numpy seed: its signal at drawn parameters plus noise of
    sd 0.02."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi: rng.uniform(lo, hi, nv)  # noqa: E731
    if name == "centred":
        m = np.stack([u(0.8, 1.2), u(3.0, 5.0), u(0.4, 0.6), u(0.3, 0.6)])
    elif name in ("conv", "conviota", "suppconv"):
        m = np.stack([u(0.5, 1.5), u(0.5, 2.0)])
    else:
        m = np.stack([u(0.5, 1.5), u(0.5, 2.0)])
    supp = np.stack([u(0.8, 1.2), u(-0.1, 0.1)]) \
        if name.startswith("supp") else None
    sig = fm.signal(twins(name)[1].name, m, nt, supp)
    data = sig + 0.02 * rng.standard_normal(sig.shape)
    return (data.T.astype(np.float32),
            None if supp is None else supp.T.astype(np.float32), m)


def engines(name, extra, mode="pallas-loop", nv=NV, seed=0, nt=NT,
            dtype="single"):
    jm, tm, _, _ = twins(name)
    data, supp, _ = model_data(name, nv, seed, nt)
    coords = np.stack([np.arange(nv), np.zeros(nv), np.zeros(nv)], 1)
    o = {"model": "fulltime-test", "noise": "white", "max-iterations": "10",
         "dtype": dtype, "save-free-energy": True, **extra}
    jeng = JVB(jm, JOptions({**o, "engine-kernel": mode}), data, coords,
               suppdata=supp)
    teng = VBInference(tm, RunOptions(o), data, device="cpu", coords=coords,
                       suppdata=supp)
    return jeng, teng


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("extra", [
    {}, {"noise-pattern": "12"}, {"convergence": "pointzeroone"},
    {"convergence": "freduce"}, {"convergence": "trialmode"},
    {"convergence": "lm"}, {"dtype": "double"}, {"engine-kernel": "xla"}],
    ids=["maxits", "pattern-12", "pointzeroone", "freduce", "trialmode",
         "lm", "double", "xla"])
def test_route_matches_jax(name, extra, monkeypatch):
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    jeng, teng = engines(name, extra, extra.get("engine-kernel", "auto"),
                         nv=8)
    jroute = "pallas-loop-nl" if jeng.use_nl_loop else (
        "pallas" if jeng.use_fused else "xla-generic")
    assert teng.route == jroute, teng.route_description()
    assert (teng.generic is not None) == (jeng._generic_eval_fn is not None)
    if teng.route == "pallas-loop-nl":
        assert teng.generic.full_time
        assert "generic full-time mode" in teng.route_description()


@pytest.mark.parametrize("nt", [30, 100, 400, 1000])
@pytest.mark.parametrize("name", MODELS)
def test_gate_grid_matches_jax(name, nt):
    """The JAX picker (pick_nl_block) on the full-time time_planes: the
    port's copy decides as the JAX one over P 1-12 x Q 1-8 x the detector
    classes, the same time_planes given."""
    jm, tm, p, ns = twins(name)
    tle = derive_time_local_eval(tm, nt, p, ns)
    tp = jfv.pad_time(nt)
    for pp in range(1, 13):
        for q in range(1, 9):
            for fdet, best in ((False, False), (True, False), (True, True)):
                args = (1024, pp, tp, q, fdet, True, tle.time_planes, ns)
                assert (nl.pick_nl_block(*args, tracks_best=best)
                        == jnl.pick_nl_block(*args, tracks_best=best))


# -- the plain version against the JAX kernel, at float64 -------------------------

def kernel_case(name, seed=1, q_pattern="12"):
    jm, tm, p, ns = twins(name)
    data, supp, m = model_data(name, NV, seed)
    rng = np.random.default_rng(seed + 1)
    nq = int(q_pattern[-1])
    q = np.zeros((nq, NT))
    for i in range(NT):
        q[int(q_pattern[i % len(q_pattern)]) - 1, i] = 1.0
    q[:, 4] = 0.0
    return dict(jm=jm, tm=tm, p=p, ns=ns, nq=nq, q=q,
                data=data.T.astype(np.float64),
                supp=None if supp is None else supp.T.astype(np.float64),
                centre=np.log(m) + 0.05 * rng.standard_normal(m.shape),
                pm=np.zeros((p, NV)), pp=np.full((p, NV), 1e-2),
                pd0=rng.uniform(0.5, 2.0, (p, NV)),
                tle=derive_time_local_eval(tm, NT, p, ns))


def detector_dicts(c, kind):
    if kind == "maxits":
        return None, None
    o = {"noise": "white", "noise-pattern": "12"[:c["nq"]],
         "convergence": kind, "max-iterations": "10", "max-trials": "3",
         "dtype": "double"}
    data = np.ones((8, NT))
    supp = None if not c["ns"] else np.ones((8, c["ns"]))
    jeng = JVB(c["jm"], JOptions(o), data, np.zeros((8, 3)), suppdata=supp)
    jeng._ensure_noise_prior()
    teng = VBInference(c["tm"], RunOptions(o), data, device="cpu",
                       suppdata=supp)
    return jeng._nl_fdet_consts(10), teng._nl_fdet_consts()


def consts(c):
    return nl.pack_nl_consts(np.full(c["nq"], 1e6), np.full(c["nq"], 1e-6),
                             c["q"].sum(axis=1), 1e-8, 50.0, c["nq"])


def run_plain(c, kind, its=10):
    _, tdet = detector_dicts(c, kind)
    t = torch.as_tensor
    tr = [x.transform for x in tbase.resolve_parameters(
        c["tm"], RunOptions({}))]
    before = nl.fused_nl_loop.launches
    outs = nl.fused_nl_loop(
        c["tm"], tr, t(c["centre"]), t(c["pm"]), t(c["pp"]), t(c["data"]),
        c["q"], consts(c), its, True, detector=tdet,
        post_var0=t(c["pd0"]), functor=c["tle"],
        supp=None if c["supp"] is None else t(c["supp"]))
    assert nl.fused_nl_loop.launches == before
    return [o.numpy() for o in outs]


def run_jax_kernel(c, kind, its=10):
    jdet, _ = detector_dicts(c, kind)
    jfn = jderive(c["jm"], NT, c["p"], jnp.float64, c["ns"])
    jtr = [x.transform for x in jbase.resolve_parameters(c["jm"],
                                                         JOptions({}))]
    run = jnl.make_fused_nl_loop(
        None, jtr, c["p"], NT, its, NV, jnp.float64, True, c["q"],
        block=NV, interpret=True, detector=jdet, evaluate_fn=jfn,
        nsupp=c["ns"])
    tp = jfv.pad_time(NT)
    data = np.pad(c["data"], ((0, tp - NT), (0, 0)), mode="edge")
    jc = jnl.pack_nl_consts(np.full(c["nq"], 1e6), np.full(c["nq"], 1e-6),
                            c["q"].sum(axis=1), 1e-8, 50.0, jnp.float64,
                            c["nq"])
    outs = run(c["centre"], c["pm"], c["pp"], data, jc, supp=c["supp"],
               post_var0=c["pd0"])
    return [np.asarray(o) for o in outs]


def assert_outputs(got, ref, rtol=1e-9):
    p = got[0].shape[0]
    for g, r in zip(got, ref):
        r = np.asarray(r)
        g = g.reshape(r.shape) if g.size == r.size else g
        if r.ndim == 2 and r.shape[0] == p * p:
            g = g.reshape(r.shape)
        np.testing.assert_allclose(
            g, r, rtol=rtol, atol=rtol * max(1.0, np.abs(r).max()))


PLAIN_CASES = [("conviota", "maxits"), ("conviota", "freduce"),
               ("shift", "trialmode"), ("centred", "maxits")]


@pytest.mark.parametrize("name,kind", PLAIN_CASES,
                         ids=["-".join(c) for c in PLAIN_CASES])
def test_plain_matches_jax_kernel(name, kind):
    jax.config.update("jax_enable_x64", True)
    c = kernel_case(name)
    its = 3 if name == "centred" else 10
    assert_outputs(run_plain(c, kind, its), run_jax_kernel(c, kind, its))


# -- the kernel as host C++, at double ------------------------------------------------

@pytest.fixture
def gxx():
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")


def run_host(c, kind, tmp_path, its=10):
    _, tdet = detector_dicts(c, kind)
    fn = torch_hostcc.full_kernel_fn(c["tle"], c["nq"], tmp_path)
    if tdet is None:
        det, dcs = (0, 0.0, 0, 0, 0), np.zeros(c["nq"] + 2)
    else:
        det = _cuda.detector_args(tdet["det"])
        dcs = np.array(list(tdet["lb_coeff"])
                       + [tdet["f_const"], tdet["f_const_init"]])
    out = fn([1] * c["p"], its, True, consts(c).numpy(), det, dcs,
             c["centre"], c["pm"], c["pp"], c["pd0"], c["data"], c["supp"],
             np.ascontiguousarray(c["q"].T))
    return out, fn


HOST_CASES = [("conv", "maxits"), ("conv", "pointzeroone"),
              ("suppconv", "freduce"), ("suppconv", "trialmode"),
              ("shift", "lm"), ("centred", "maxits"), ("centred", "lm")]


@pytest.mark.parametrize("name,kind", HOST_CASES,
                         ids=["-".join(c) for c in HOST_CASES])
def test_full_kernel_on_host_matches_plain(name, kind, tmp_path, gxx):
    """The full-time kernel (a block's 32 threads as host threads) at
    double against the plain version at float64, to 1e-9: its sums run in
    another order (a chunk's blocks of kTB samples, a fixed-order time
    sum) and its square roots are the host's (ROADMAP Queue 3 item 22:
    torch's CPU sqrt need not round correctly), well inside the bound. The
    centred biexponential runs 3 iterations (it is chaotic further out,
    Queue 3 item 7)."""
    c = kernel_case(name, seed=3)
    its = 3 if name == "centred" else 10
    got, fn = run_host(c, kind, tmp_path, its)
    assert fn.smem == _cuda.fulltime_smem(c["p"], c["nq"], NT,
                                          c["tle"].smem_floats)
    assert_outputs(got, run_plain(c, kind, its))


class FullKitchen(fm.Shifted):
    """Most of the full-time walk in one model: a flip, a pad, a first-
    sample baseline (a time axis of one sample), amax, amin, select, a
    stack's mean, a weight per sample, a contraction through einsum (bmm
    on a batch of one), a product over time, a rotation by slices and a
    concatenation, and a delay filled with a parameter."""
    name = "kitchen-fulltime"

    def evaluate(self, params, ctx, key=""):
        nt = ctx.nt
        s = _texp(params, ctx)
        a = torch.flip(s, [0]) * 0.5 + torch.nn.functional.pad(
            s[2:], (1, 1), value=0.25)
        b = (s / s[:1] + s.amax() - s.amin() + s[3]
             + torch.stack([s, a]).mean(0))
        e = torch.einsum("ts,s->t", fm.conv_constant(nt).to(s.dtype), s)
        q = (1.0 + 0.01 * s).prod()
        fill = torch.cat([params[1] * torch.ones(2, dtype=s.dtype),
                          s[:nt - 2]])
        return (a + b + s * TWEIGHTS[nt] + e + 0.1 * q + fill
                + torch.cat([s[nt // 2:], s[:nt // 2]]))


class SuppKitchen(FullKitchen):
    """FullKitchen plus time-mixing ops on values that depend on the
    suppdata alone (planes of reals: no tangents)."""
    name = "suppkitchen-fulltime"

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype) * DT
        r = ctx.suppdata[0] * t
        return (super().evaluate(params, ctx)
                + params[0] * torch.flip(r, [0]) + (ctx.suppdata[1] * r).mean()
                + torch.cat([r[1:], r[:1]]) * params[1])


@pytest.mark.parametrize("kind", ["maxits", "trialmode"])
def test_full_kernel_on_host_kitchen_sink(kind, tmp_path, gxx):
    """FullKitchen's full-time functor (several loops and planes, maps,
    reductions and a contraction in one source) in the host-built kernel
    against the plain version at float64, to 1e-9."""
    c = kernel_case("shift", seed=4)
    c["tm"] = FullKitchen()
    c["tle"] = derive_time_local_eval(c["tm"], NT, 2)
    assert c["tle"].full_time and c["tle"].consts is not None
    got, _ = run_host(c, kind, tmp_path, 5)
    assert_outputs(got, run_plain(c, kind, 5))


@pytest.mark.parametrize("kind", ["maxits", "lm"])
def test_full_kernel_on_host_supp_kitchen(kind, tmp_path, gxx):
    """SuppKitchen (time-mixing ops on real planes, the suppdata's) in the
    host-built kernel against the plain version at float64, to 1e-9."""
    c = kernel_case("suppshift", seed=5)
    c["tm"] = SuppKitchen()
    c["tle"] = derive_time_local_eval(c["tm"], NT, 2, 2)
    assert c["tle"].full_time and "sh[" in c["tle"].source
    got, _ = run_host(c, kind, tmp_path, 5)
    assert_outputs(got, run_plain(c, kind, 5))


# -- the engine against the JAX engine ------------------------------------------------

ENGINE_CASES = [("conviota", {}),
                ("shift", {"convergence": "pointzeroone"}),
                ("suppshift", {"convergence": "trialmode",
                               "max-trials": "3"}),
                ("conviota", {"noise-pattern": "12"}),
                ("centred", {"max-iterations": "3"})]


@pytest.mark.parametrize("name,extra", ENGINE_CASES,
                         ids=["conviota-maxits", "shift-pointzeroone",
                              "suppshift-trialmode", "conviota-pattern-12",
                              "centred-3its"])
def test_engine_matches_jax(name, extra):
    """The engine on auto (pallas-loop-nl, full-time functor, its plain
    version on the CPU) against the JAX engine's interpreted kernel 6 in
    full-time mode, at float32, with test_fused_loop_nl.py's tolerances
    (those of test_engine_generic_route_matches_jax). The centred
    biexponential runs 3 iterations (chaotic at float32 further out)."""
    jeng, teng = engines(name, extra, seed=2)
    assert jeng.use_nl_loop and jeng._generic_eval_fn is not None
    assert teng.route == "pallas-loop-nl" and teng.generic.full_time
    before = nl.fused_nl_loop.launches
    rt = teng.run()
    assert nl.fused_nl_loop.launches == before
    assert_match(jeng.run(), rt, mean_rtol=1e-3)


# -- the card's gate, the device stood in -------------------------------------------------

def test_card_builds_full_time_kernel_at_construction(monkeypatch):
    built = []
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda *a: built.append(a) or "lib")
    _, teng = engines("conv", {}, "auto", nv=8)
    teng.device = torch.device("cuda")
    teng._require_kernel_instance()
    assert [(p, q, k) for _, p, q, k in built] == [(2, 1, "nl_loop_full")]
    assert teng.functor is teng.generic
    assert teng.generic.libs[("nl_loop_full", 1)] == "lib"


def test_card_refused_model_builds_nothing(monkeypatch):
    built = []
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda *a: built.append(a))
    _, teng = engines("conv", {"convergence": "lm", "dtype": "double"},
                      "auto", nv=8)
    teng.device = torch.device("cuda")
    teng._require_kernel_instance()
    assert teng.route == "xla-generic" and built == []


def test_card_block_past_shared_memory_raises(monkeypatch):
    built = []
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda *a: built.append(a))
    _, teng = engines("conv", {}, "auto", nv=8)
    need = _cuda.fulltime_smem(2, 1, NT, teng.generic.smem_floats)
    monkeypatch.setattr(_cuda, "MAX_BLOCK_SMEM", need - 4)
    teng.device = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="Queue 3 item 35"):
        teng._require_kernel_instance()
    assert built == []


def test_fulltime_smem_counts_the_layout():
    """fulltime_smem's floats: the state, the chunk, the samples, the
    model's (P+1) x T planes and the functor's own."""
    tle = derive_time_local_eval(fm.CentredBiexp(), 100, 4)
    assert tle.smem_floats == 5 * 100      # one S plane: s, for its mean
    b = _cuda.fulltime_smem(4, 1, 100, tle.smem_floats)
    assert b == 4 * (15 + 4 * 33 + 32 + 32 + 50 + 36 + 4 + 100 + 500 + 500)
    assert b <= _cuda.MAX_BLOCK_SMEM


@pytest.mark.parametrize("name", ["conv", "conviota", "shift"])
def test_needed_ops_leave_out_known_zeros(name):
    """needed_ops: the generated code's operations less the products of a
    contraction by its matrix's known zeros, 2 (P + 1) a zero for an S
    value (the convolution's strictly lower triangle is non-zero: aif(0)
    is 0); without a contraction, all of them."""
    _, tm, p, ns = twins(name)
    tle = derive_time_local_eval(tm, 100, p, ns)
    dense = tle.value_ops + tle.tangent_ops
    if name == "shift":
        assert tle.needed_ops == dense
        return
    nnz = int(np.count_nonzero(fm.conv_matrix(100)))
    assert nnz == 100 * 99 // 2
    assert tle.needed_ops == dense - 2 * (100 * 100 - nnz) * (p + 1)


# -- kinks ------------------------------------------------------------------------------------

class _KinkBase(fm.Shifted):
    name = "kink-fulltime"


@pytest.mark.parametrize("case", ["amax-tie", "abs-conv"])
def test_full_eval_keeps_jax_rules_at_kinks(case):
    """An amax over samples that all tie (a flat signal), and abs at 0
    under a convolution by a constant matrix: full_eval's Jacobian is
    jax.jacfwd's of the JAX twin (jax's rules: ties share the tangent,
    abs has slope +1 at 0)."""
    lmat = fm.conv_matrix(NT, np.float64)
    if case == "amax-tie":
        def tf(p):
            flat = p[0] * torch.ones(NT, dtype=p.dtype)
            return flat.amax() * torch.exp(-p[1] * torch.arange(
                NT, dtype=p.dtype) * DT)

        def jf(p):
            flat = p[0] * jnp.ones(NT, p.dtype)
            return jnp.max(flat) * jnp.exp(-p[1] * jnp.arange(
                NT, dtype=p.dtype) * DT)
        at = np.array([1.0, 1.0])
    else:
        lt = torch.as_tensor(lmat)

        def tf(p):
            t = torch.arange(NT, dtype=p.dtype) * DT
            return lt @ (torch.abs(p[0]) * torch.exp(-p[1] * t))

        def jf(p):
            t = jnp.arange(NT, dtype=p.dtype) * DT
            return jnp.asarray(lmat) @ (jnp.abs(p[0]) * jnp.exp(-p[1] * t))
        at = np.array([0.0, 1.0])
    jax.config.update("jax_enable_x64", True)
    ref = np.asarray(jax.jacfwd(jf)(jnp.asarray(at)))           # [T,P]
    from fabber_core_tpu_torch.core.transforms import get_transform
    ev = fv.full_eval(tf, [get_transform("I")] * 2)
    _, jac = ev(torch.as_tensor(at)[:, None])
    np.testing.assert_allclose(jac[:, :, 0].numpy().T, ref, rtol=1e-12,
                               atol=1e-14)
