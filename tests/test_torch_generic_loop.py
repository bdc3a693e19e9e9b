"""The whole-loop kernel's generic full-time mode in the port (TPU
kernel 6g: ops/fused_loop_nl.py with ops/fused_vb.py full_eval, the
functor generated from evaluate by models/kernelgen.py), --suppdata
through both engines, and the torch myexp plugin.

  kernel    fused_nl_loop's plain version in generic mode against the
            JAX make_fused_nl_loop(None, ..., evaluate_fn=
            derive_time_local_eval(...), interpret=True) at float64, to
            1e-9 in means, prec, cov, noise and F (or the detector's F
            and iteration counts): maxits at Q=1 without and Q=2
            (noise-pattern=12) with suppdata, on the GaussianAct and
            SuppScaled twins and on the stripped exp (log transforms),
            and the four F detectors at Q=2 with suppdata; then the
            kernel itself (csrc/fused_nl_loop.cuh with the generated
            functor) compiled as host C++ at double (tests/
            torch_hostcc.py, skipped without g++) against the same plain
            version to 1e-9, and its streamed form equal to its staged
            one bit for bit;
  engine    VBInference(device="cpu") on generic pallas-loop-nl against
            the JAX engine's interpreted pallas-loop (and, once, its xla
            route) at float32 with tests/test_fused_loop_generic.py's
            tolerances; the route table against the JAX flags
            (use_nl_loop, _generic_eval_fn) with jax.default_backend
            patched to "tpu"; a rejected model takes xla-generic before
            any launch;
  suppdata  a SuppScaled plugin through runner.run of both packages at
            float64 on xla-generic (1e-9), and through both CLIs
            (--suppdata) and both APIs (float32 outputs: 1e-6);
  plugins   the torch myexp twin through --loadmodels and
            FabberTpu(model_files=...) against the JAX plugin
            (examples/fwdmodel_exp.py) at float64, and its evaluate-only
            variant on the generic route at float32.

Shapes follow tests/test_fused_loop_generic.py: 128 voxels, T=30.
"""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu import cli as jcli
from fabber_core_tpu import runner as jrunner
from fabber_core_tpu.api import FabberTpu as JFabber
from fabber_core_tpu.core.volume import (VolumeGeometry as JGeom,
                                         VoxelDataStore as JStore)
from fabber_core_tpu.inference import vb as jvb_module
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.io import nifti as jnifti
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.models.base import derive_time_local_eval as jderive
from fabber_core_tpu.ops import fused_loop_nl as jnl
from fabber_core_tpu.ops import fused_vb as jfv
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch import cli as tcli
from fabber_core_tpu_torch import runner as trunner
from fabber_core_tpu_torch.api import FabberTpu
from fabber_core_tpu_torch.core.volume import VolumeGeometry, VoxelDataStore
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.io import nifti
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.models.kernelgen import derive_time_local_eval
from fabber_core_tpu_torch.ops import fused_loop_nl as nl
from fabber_core_tpu_torch.options import RunOptions

import test_fused_loop_generic as jgen
import torch_hostcc
from torch_generic_models import (DataUsing, GaussianAct, SumOverTime,
                                  SuppScaled, UnsafeOp, stripped_exp)

torch.set_num_threads(1)

NT, NV = 30, 128
ROOT = Path(__file__).resolve().parents[1]


# -- kernel level ---------------------------------------------------------

def jax_stripped_exp(dt=0.05):
    base = jmodel("exp")

    class JStrippedExp(base):
        name = "exp-stripped-test"

        @property
        def time_signal(self):
            raise AttributeError("stripped: generic evaluate only")

    return JStrippedExp(JOptions({"model": "exp", "dt": str(dt)}))


def kernel_case(model, pattern, nsupp, seed=0):
    """Inputs of one loop from a numpy seed: the model's twins, the data
    [T,V] (its signal at perturbed truths, noise sd 0.02, scaled by the
    suppdata where the model reads it), one masked sample, the centre
    near the truth, weak priors."""
    rng = np.random.default_rng(seed)
    if model == "gauss":
        tm, jm = (SuppScaled(), jgen.SuppScaledModel()) if nsupp \
            else (GaussianAct(), jgen.GaussianActModel())
        truth = np.array([0.0, 1.0, 1.2, 0.6])
        mt = truth + rng.uniform(-0.2, 0.2, (NV, 4)) * [1, 1, 0.5, 0.3]
        latent = mt.T
        # the model's priors: N(default, 10)
        pm, pp = np.repeat(truth[:, None], NV, 1), np.full((4, NV), 0.1)
    else:
        tm, jm = stripped_exp(num=1), jax_stripped_exp()
        mt = np.stack([rng.uniform(0.5, 2.0, NV), rng.uniform(0.5, 2.0, NV)],
                      1)
        latent = np.log(mt).T
        pm, pp = np.zeros((2, NV)), np.full((2, NV), 1e-5)
    tle = derive_time_local_eval(tm, NT, mt.shape[1], nsupp)
    supp = np.stack([rng.uniform(0.8, 1.2, NV),
                     rng.uniform(-0.1, 0.1, NV)]) if nsupp else None
    sig = np.stack([tle.fn(torch.as_tensor(m), *(
        [torch.as_tensor(supp[:, v])] if nsupp else [])).numpy()
        for v, m in enumerate(mt)], 1)
    data = sig + 0.02 * rng.standard_normal((NT, NV))
    p = mt.shape[1]
    nq = int(pattern[-1])
    q = np.zeros((nq, NT))
    for i in range(NT):
        q[int(pattern[i % len(pattern)]) - 1, i] = 1.0
    q[:, 4] = 0.0
    tparams = resolve(tm, model)
    return dict(tm=tm, jm=jm, tle=tle, p=p, nq=nq, q=q, data=data,
                supp=supp, centre=latent + 0.05 * rng.standard_normal(
                    (p, NV)),
                pm=pm, pp=pp,
                pd0=rng.uniform(0.5, 2.0, (p, NV)),
                tr=[x.transform for x in tparams], pattern=pattern,
                model=model)


def resolve(tm, model):
    from fabber_core_tpu_torch.models import resolve_parameters
    return resolve_parameters(tm, RunOptions(
        {"model": "exp", "dt": "0.05"} if model == "exp" else {}))


def engine_options(model, pattern, kind, dtype="double"):
    o = {"noise": "white", "noise-pattern": pattern, "dtype": dtype,
         "convergence": kind, "max-iterations": "10", "max-trials": "3",
         "save-free-energy": True}
    if model == "exp":
        o.update(model="exp", dt="0.05")
    else:
        o.update(model="gaussact-test")
    return o


def detector_dicts(c, kind):
    """(the JAX kernel's detector dict, the port's) from engines with the
    same groups (their host ELBO constants)."""
    if kind == "maxits":
        return None, None
    o = engine_options(c["model"], c["pattern"], kind)
    data = np.ones((8, NT))
    jeng = JVB(c["jm"], JOptions(o), data, np.zeros((8, 3)),
               suppdata=None if c["supp"] is None else np.ones((8, 2)))
    jeng._ensure_noise_prior()
    teng = VBInference(c["tm"], RunOptions(o), data, device="cpu")
    return jeng._nl_fdet_consts(10), teng._nl_fdet_consts()


def run_jax_kernel(c, kind, need_f=True):
    jdet, _ = detector_dicts(c, kind)
    nsupp = 0 if c["supp"] is None else 2
    jfn = jderive(c["jm"], NT, c["p"], jnp.float64, nsupp)
    assert jfn is not None
    jtr = [x.transform for x in jresolve(c)]
    run = jnl.make_fused_nl_loop(
        None, jtr, c["p"], NT, 10, NV, jnp.float64, need_f, c["q"],
        block=NV, interpret=True, detector=jdet, evaluate_fn=jfn,
        nsupp=nsupp)
    tp = jfv.pad_time(NT)
    data = np.pad(c["data"], ((0, tp - NT), (0, 0)), mode="edge")
    consts = jnl.pack_nl_consts(np.full(c["nq"], 1e6),
                                np.full(c["nq"], 1e-6), c["q"].sum(axis=1),
                                1e-8, 50.0, jnp.float64, c["nq"])
    outs = run(c["centre"], c["pm"], c["pp"], data, consts,
               supp=c["supp"], post_var0=c["pd0"])
    return [np.asarray(o) for o in outs]


def jresolve(c):
    from fabber_core_tpu.models.base import resolve_parameters as jres
    return jres(c["jm"], JOptions(
        {"model": "exp", "dt": "0.05"} if c["model"] == "exp" else {}))


def port_args(c):
    t = torch.as_tensor
    consts = nl.pack_nl_consts(np.full(c["nq"], 1e6), np.full(c["nq"], 1e-6),
                               c["q"].sum(axis=1), 1e-8, 50.0, c["nq"])
    return (t(c["centre"]), t(c["pm"]), t(c["pp"]), t(c["data"]), c["q"],
            consts)


def run_port_plain(c, kind, need_f=True):
    _, tdet = detector_dicts(c, kind)
    before = nl.fused_nl_loop.launches
    outs = nl.fused_nl_loop(
        c["tm"], c["tr"], *port_args(c), 10, need_f, detector=tdet,
        post_var0=torch.as_tensor(c["pd0"]), functor=c["tle"],
        supp=None if c["supp"] is None else torch.as_tensor(c["supp"]))
    assert nl.fused_nl_loop.launches == before
    return [o.numpy() for o in outs]


def assert_outputs(got, ref, rtol=1e-9):
    p = got[0].shape[0]
    ref = list(ref)
    ref[1] = ref[1].reshape(p, p, -1)
    ref[2] = ref[2].reshape(p, p, -1)
    for g, r in zip(got, ref):
        g = g.reshape(r.shape)
        np.testing.assert_allclose(
            g, r, rtol=rtol, atol=rtol * max(1.0, np.abs(r).max()))


KERNEL_CASES = [("gauss", "1", 0, "maxits"), ("gauss", "12", 2, "maxits"),
                ("exp", "1", 0, "maxits"),
                ("gauss", "12", 2, "pointzeroone"),
                ("gauss", "12", 2, "freduce"),
                ("gauss", "12", 2, "trialmode"), ("gauss", "12", 2, "lm")]
KERNEL_IDS = ["-".join(map(str, k)) for k in KERNEL_CASES]


@pytest.mark.parametrize("model,pattern,nsupp,kind", KERNEL_CASES,
                         ids=KERNEL_IDS)
def test_generic_loop_plain_matches_jax_kernel(model, pattern, nsupp, kind):
    c = kernel_case(model, pattern, nsupp)
    assert_outputs(run_port_plain(c, kind), run_jax_kernel(c, kind))


@pytest.fixture
def gxx():
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")


@pytest.mark.parametrize("kind", ["maxits", "freduce", "trialmode", "lm"])
def test_generated_kernel_on_host_matches_plain(kind, tmp_path, gxx):
    """csrc/fused_nl_loop.cuh's kernel with the functor generated from
    SuppScaled's evaluate, compiled as host C++ at double, one call per
    voxel, against the plain generic loop at float64."""
    c = kernel_case("gauss", "12", 2, seed=1)
    got = run_host_kernel(c, kind, tmp_path, staged=True)
    ref = run_port_plain(c, kind)
    assert_outputs([g.reshape(r.shape) for g, r in zip(got, ref)], ref)


def run_host_kernel(c, kind, tmp_path, staged):
    """The host-compiled kernel (tests/torch_hostcc.py kernel_fn) on a
    kernel_case, in its staged or streamed form."""
    _, tdet = detector_dicts(c, kind)
    fn = torch_hostcc.kernel_fn(c["tle"], 2, tmp_path, staged)
    from fabber_core_tpu_torch.ops import _cuda
    consts = port_args(c)[5].numpy()
    if tdet is None:
        det, dcs = (0, 0.0, 0, 0, 0), np.zeros(4)
    else:
        det = _cuda.detector_args(tdet["det"])
        dcs = np.array(list(tdet["lb_coeff"])
                       + [tdet["f_const"], tdet["f_const_init"]])
    return fn([0] * 4, 10, True, consts, det, dcs, c["centre"], c["pm"],
              c["pp"], c["pd0"], c["data"], c["supp"],
              np.ascontiguousarray(c["q"].T))


@pytest.mark.parametrize("kind", ["maxits", "freduce", "lm"])
def test_generated_kernel_on_host_streamed_equals_staged(kind, tmp_path,
                                                         gxx):
    """The kernel's two forms (csrc/tile.cuh), compiled as host C++ at
    double: the streamed form reads the plane where the staged one reads
    its one-lane tile, and every output agrees bit for bit."""
    c = kernel_case("gauss", "12", 2, seed=1)
    staged = run_host_kernel(c, kind, tmp_path, staged=True)
    streamed = run_host_kernel(c, kind, tmp_path, staged=False)
    for a, b in zip(staged, streamed):
        np.testing.assert_array_equal(a, b)


# -- engine level -----------------------------------------------------------

def gauss_engine_data(nv=NV, seed=0, supp=False):
    data, coords = jgen._gauss_data(nv, NT, seed)
    sd = None
    if supp:
        rng = np.random.default_rng(seed + 100)
        sd = np.stack([rng.uniform(0.8, 1.2, nv),
                       rng.uniform(-0.1, 0.1, nv)], 1).astype(np.float32)
        data = data * sd[:, 0:1] + sd[:, 1:2]
    return data, coords, sd


def engines(extra, mode, jm=None, tm=None, supp=False, seed=0):
    data, coords, sd = gauss_engine_data(seed=seed, supp=supp)
    o = {"model": "gaussact-test", "noise": "white", "max-iterations": "10",
         "dtype": "single", "save-free-energy": True, **extra}
    jm = jm or (jgen.SuppScaledModel() if supp else jgen.GaussianActModel())
    tm = tm or (SuppScaled() if supp else GaussianAct())
    jeng = JVB(jm, JOptions({**o, "engine-kernel": mode}), data, coords,
               suppdata=sd)
    teng = VBInference(tm, RunOptions(o), data, device="cpu", coords=coords,
                       suppdata=sd)
    return jeng, teng


@pytest.mark.parametrize("extra,supp", [
    ({}, False), ({"convergence": "pointzeroone", "max-iterations": "15"},
                  False),
    ({"noise-pattern": "12"}, False), ({}, True),
    ({"convergence": "trialmode", "max-trials": "3"}, True)],
    ids=["maxits", "pointzeroone", "pattern-12", "suppdata",
         "trialmode-suppdata"])
def test_engine_generic_route_matches_jax(extra, supp):
    jeng, teng = engines(extra, "pallas-loop", supp=supp, seed=2)
    assert jeng.use_nl_loop and jeng._generic_eval_fn is not None
    assert teng.route == "pallas-loop-nl" and teng.generic is not None
    assert "generic full-time mode" in teng.route_description()
    before = nl.fused_nl_loop.generic_launches
    rt = teng.run()
    assert nl.fused_nl_loop.generic_launches == before
    jgen.assert_match(jeng.run(), rt, mean_rtol=1e-3)


def test_engine_generic_route_matches_jax_xla_route():
    jeng, teng = engines({}, "xla", seed=3)
    assert not jeng.use_nl_loop
    jgen.assert_match(jeng.run(), teng.run(), mean_rtol=1e-3)


ROUTE_TABLE = [
    # (model twins, extra options, suppdata)
    ("gauss", {}, False), ("gauss", {"engine-kernel": "pallas-loop"}, False),
    ("gauss", {"convergence": "lm"}, False),
    ("gauss", {"noise-pattern": "12"}, False), ("supp", {}, True),
    ("gauss", {}, True), ("stripped", {}, False),
    ("gauss", {"engine-kernel": "xla"}, False),
    ("gauss", {"engine-kernel": "pallas"}, False),
    ("gauss", {"dtype": "double"}, False),
    ("gauss", {"linearization": "fd"}, False),
    ("gauss", {"save-free-energy-history": True}, False),
    ("gauss", {"noise": "ar"}, False),
    ("data", {}, False), ("unsafe", {}, False)]


def route_models(name):
    if name == "stripped":
        return jax_stripped_exp(), stripped_exp(num=1)
    return {"gauss": (jgen.GaussianActModel(), GaussianAct()),
            "supp": (jgen.SuppScaledModel(), SuppScaled()),
            "data": (jgen.DataUsingModel(), DataUsing()),
            "unsafe": (jgen.UnsafeOpModel(), UnsafeOp())}[name]


@pytest.mark.parametrize("name,extra,supp", ROUTE_TABLE,
                         ids=[f"{n}-" + "-".join(f"{k}={v}" for k, v in
                                                 e.items()) + ("-supp" * s)
                              for n, e, s in ROUTE_TABLE])
def test_route_table_matches_jax(name, extra, supp, monkeypatch):
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    jm, tm = route_models(name)
    if name == "stripped":
        extra = {**extra, "model": "exp", "dt": "0.05"}
    jeng, teng = engines(extra, extra.get("engine-kernel", "auto"), jm=jm,
                         tm=tm, supp=supp)
    assert (teng.generic is not None) == (jeng._generic_eval_fn is not None)
    jroute = "pallas-loop-nl" if jeng.use_nl_loop else (
        "pallas" if jeng.use_fused else "xla-generic")
    assert teng.route == jroute, teng.route_description()


def test_time_mixing_model_keeps_generic_route(monkeypatch):
    """A sum over time: the JAX probe admits it (its kernel reduces the
    time axis), the port's time-locality rule does not (ROADMAP Queue 3
    item 19): the same results on another route."""
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")

    class JSum(jgen.GaussianActModel):
        def evaluate(self, params, ctx, key=""):
            s = super().evaluate(params, ctx)
            return s - jnp.mean(s)

    jeng, teng = engines({}, "auto", jm=JSum(), tm=SumOverTime())
    assert jeng.use_nl_loop and jeng._generic_eval_fn is not None
    assert teng.route == "xla-generic" and teng.generic is None


def test_rejected_model_takes_generic_route_before_any_launch(monkeypatch):
    """On the card a rejected model builds nothing: its route is
    xla-generic from construction."""
    from fabber_core_tpu_torch.ops import _cuda
    built = []
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda *a: built.append(a))
    _, teng = engines({}, "auto", jm=jgen.DataUsingModel(), tm=DataUsing())
    teng.device = torch.device("cuda")
    teng._require_kernel_instance()
    assert teng.route == "xla-generic" and built == []
    _, teng = engines({}, "auto")
    teng.device = torch.device("cuda")
    teng._require_kernel_instance()
    assert [(p, q) for _, p, q in built] == [(4, 1)]
    assert teng.functor is teng.generic


# -- suppdata end to end ------------------------------------------------------

SUPP_PLUGIN = '''
"""A suppdata-using plugin: the signal scaled and offset per voxel."""
import {lib}
from {pkg}.models.base import (DistParams, Model, ParamSpec,
                               register_model)


@register_model
class SuppScaledPlugin(Model):
    name = "suppscale-plugin"
    dt = 0.1

    def __init__(self, options):
        pass

    def param_defaults(self):
        return [ParamSpec(i, n, DistParams(m, 10), DistParams(m, 5))
                for i, (n, m) in enumerate(
                    [("off", 0.0), ("amp", 1.0), ("mu", 1.2),
                     ("width", 0.6)])]

    def evaluate(self, params, ctx, key=""):
        t = {lib}.arange(ctx.nt, dtype=params.dtype) * self.dt
        z = (t - params[2]) / params[3]
        sig = params[0] + params[1] * {lib}.exp(-0.5 * z * z)
        return ctx.suppdata[0] * sig + ctx.suppdata[1]
'''


@pytest.fixture
def supp_plugins(tmp_path):
    paths = {}
    for pkg, lib in (("fabber_core_tpu", "jax.numpy"),
                     ("fabber_core_tpu_torch", "torch")):
        path = tmp_path / f"{pkg}_supp_plugin.py"
        src = SUPP_PLUGIN.format(pkg=pkg, lib=lib)
        if lib == "jax.numpy":
            src = src.replace("import jax.numpy", "import jax.numpy as jnp")
            src = src.replace("jax.numpy.", "jnp.")
        path.write_text(src)
        paths[pkg] = str(path)
    return paths


def supp_volume(shape=(4, 4, 2), seed=5):
    nv = int(np.prod(shape))
    data, _, sd = gauss_engine_data(nv=nv, seed=seed, supp=True)
    return (data.astype(np.float64).reshape(shape + (NT,)),
            sd.astype(np.float64).reshape(shape + (2,)))


SUPP_OPTS = {"model": "suppscale-plugin", "method": "vb", "noise": "white",
             "max-iterations": "10", "save-mean": True, "save-std": True,
             "save-noise-mean": True, "save-model-fit": True}


def test_suppdata_runner_matches_jax_float64(supp_plugins):
    """runner.run of both packages with suppdata in the store, at
    float64 (xla-generic): every output within 1e-9."""
    from fabber_core_tpu.models import load_models_from_file as jload
    from fabber_core_tpu_torch.models import load_models_from_file as tload
    jload(supp_plugins["fabber_core_tpu"])
    tload(supp_plugins["fabber_core_tpu_torch"])
    vol, sv = supp_volume()
    outs = []
    for geom, store, run, opts, kw in (
            (JGeom, JStore, jrunner.run, JOptions, {}),
            (VolumeGeometry, VoxelDataStore, trunner.run, RunOptions,
             {"device": "cpu"})):
        g = geom(vol.shape[:3])
        s = store(g)
        s.set("data", vol)
        s.set("suppdata", sv)
        outs.append(run(opts(dict(SUPP_OPTS)), s, **kw).outputs)
    jo, to = outs
    assert sorted(jo) == sorted(to)
    for key in jo:
        np.testing.assert_allclose(to[key], jo[key], rtol=1e-9,
                                   atol=1e-9 * np.abs(jo[key]).max())
    # the model read the suppdata: the fit follows the scaled data
    vox = VolumeGeometry(vol.shape[:3]).to_voxels(vol)
    assert np.median(np.abs(to["modelfit"] - vox)) < 0.05


def test_suppdata_cli_and_api_match_jax(supp_plugins, tmp_path):
    """--suppdata through both CLIs and the suppdata key through both
    APIs (float32 outputs: within 1e-6 of each other)."""
    vol, sv = supp_volume(seed=6)
    data_f, supp_f = str(tmp_path / "d.nii.gz"), str(tmp_path / "s.nii.gz")
    nifti.save(nifti.NiftiImage(vol.astype(np.float32)), data_f)
    nifti.save(nifti.NiftiImage(sv.astype(np.float32)), supp_f)
    common = ["--model=suppscale-plugin", "--method=vb", "--noise=white",
              f"--data={data_f}", f"--suppdata={supp_f}", "--save-std",
              "--save-noise-mean"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.execute([f"--loadmodels={supp_plugins['fabber_core_tpu']}",
                         f"--output={jout}"] + common) == 0
    assert tcli.execute(
        [f"--loadmodels={supp_plugins['fabber_core_tpu_torch']}",
         f"--output={tout}", "--device=cpu"] + common) == 0
    for name in ("mean_amp", "std_amp", "mean_mu", "noise_means"):
        j = jnifti.load(os.path.join(jout, f"{name}.nii.gz")).data
        t = nifti.load(os.path.join(tout, f"{name}.nii.gz")).data
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    jd = JFabber(model_files=[supp_plugins["fabber_core_tpu"]]) \
        .run_with_data(SUPP_OPTS, {"data": vol, "suppdata": sv}).data
    td = FabberTpu(model_files=[supp_plugins["fabber_core_tpu_torch"]],
                   device="cpu").run_with_data(
        SUPP_OPTS, {"data": vol, "suppdata": sv}).data
    assert sorted(td) == sorted(jd)
    for key in jd:
        np.testing.assert_allclose(td[key], jd[key], rtol=1e-6, atol=1e-6)


# -- the myexp plugin ---------------------------------------------------------

TORCH_PLUGIN = ROOT / "fabber_core_tpu_torch" / "examples" / "fwdmodel_exp.py"
JAX_PLUGIN = ROOT / "examples" / "fwdmodel_exp.py"


def exp_volume(shape=(4, 4, 2), nt=40, seed=7):
    rng = np.random.default_rng(seed)
    nv = int(np.prod(shape))
    t = np.arange(nt) * 0.05
    amp = rng.uniform(0.5, 2.0, nv)
    vol = amp[:, None] * np.exp(-1.5 * t)[None] \
        + rng.normal(0, 0.02, (nv, nt))
    return vol.reshape(shape + (nt,))


MYEXP = {"model": "myexp", "dt": "0.05", "method": "vb", "noise": "white",
         "save-mean": True, "save-std": True, "save-noise-mean": True}


def test_myexp_plugin_api_and_cli_match_jax(tmp_path):
    vol = exp_volume()
    jd = JFabber(model_files=[str(JAX_PLUGIN)]).run_with_data(
        MYEXP, {"data": vol}).data
    tfab = FabberTpu(model_files=[str(TORCH_PLUGIN)], device="cpu")
    assert "myexp" in tfab.get_models()
    td = tfab.run_with_data(MYEXP, {"data": vol}).data
    assert sorted(td) == sorted(jd)
    for key in jd:
        np.testing.assert_allclose(td[key], jd[key], rtol=1e-6, atol=1e-6)
    data_f = str(tmp_path / "d.nii.gz")
    nifti.save(nifti.NiftiImage(vol.astype(np.float32)), data_f)
    common = ["--model=myexp", "--dt=0.05", "--method=vb", "--noise=white",
              f"--data={data_f}", "--save-std"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.execute([f"--loadmodels={JAX_PLUGIN}",
                         f"--output={jout}"] + common) == 0
    assert tcli.execute([f"--loadmodels={TORCH_PLUGIN}", f"--output={tout}",
                         "--device=cpu"] + common) == 0
    for name in ("mean_amp1", "std_amp1", "mean_r1"):
        np.testing.assert_allclose(
            nifti.load(os.path.join(tout, f"{name}.nii.gz")).data,
            jnifti.load(os.path.join(jout, f"{name}.nii.gz")).data,
            rtol=1e-6, atol=1e-6)


def test_myexp_evaluate_only_takes_generic_mode():
    """myexp with its time_signal stripped: at float32 the engine takes
    the whole-loop kernel's generic mode (its route line says so), and
    matches the plugin with its time_signal (time_signal mode) and the
    JAX plugin's xla route."""
    from fabber_core_tpu_torch.models import load_models_from_file
    load_models_from_file(str(TORCH_PLUGIN))
    base = get_model_class("myexp")

    class EvaluateOnly(base):
        @property
        def time_signal(self):
            raise AttributeError("evaluate only")

    vol = exp_volume(seed=8).reshape(-1, 40).astype(np.float32)
    o = {**MYEXP, "dtype": "single", "max-iterations": "10",
         "save-free-energy": True}
    gen = VBInference(EvaluateOnly(RunOptions(o)), RunOptions(o), vol,
                      device="cpu")
    ts = VBInference(base(RunOptions(o)), RunOptions(o), vol, device="cpu")
    assert gen.route == ts.route == "pallas-loop-nl"
    assert "generic full-time mode" in gen.route_description()
    assert "time_signal mode" in ts.route_description()
    rg = gen.run()
    jgen.assert_match(ts.run(), rg, mean_rtol=1e-3)
    from fabber_core_tpu.models import load_models_from_file as jload
    jload(str(JAX_PLUGIN))
    jo = JOptions({**o, "engine-kernel": "xla"})
    jeng = JVB(jmodel("myexp")(jo), jo, vol, np.zeros((vol.shape[0], 3)))
    jgen.assert_match(jeng.run(), rg, mean_rtol=1e-3)


def test_model_evaluate_takes_suppdata(supp_plugins):
    """The API's single-voxel evaluate hands suppdata to the model (the
    JAX API's has no suppdata argument: it binds None)."""
    fab = FabberTpu(model_files=[supp_plugins["fabber_core_tpu_torch"]],
                    device="cpu")
    values = {"off": 0.1, "amp": 1.2, "mu": 1.0, "width": 0.5}
    got = fab.model_evaluate({"model": "suppscale-plugin"}, values, NT,
                             suppdata=[1.5, -0.2])
    jfab = JFabber(model_files=[supp_plugins["fabber_core_tpu"]])
    t = np.arange(NT) * 0.1
    base = 0.1 + 1.2 * np.exp(-0.5 * ((t - 1.0) / 0.5) ** 2)
    np.testing.assert_allclose(got, 1.5 * base - 0.2, rtol=1e-12)
    with pytest.raises(TypeError):
        jfab.model_evaluate({"model": "suppscale-plugin"}, values, NT)
