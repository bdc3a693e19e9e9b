"""Kernels 7 (one VB iteration, csrc/fused_vb_iter.cuh) and 8 (the NLLS
loop, csrc/fused_nlls.cuh) with a model functor generated from a
model's time_signal (models/kernelgen.py), and the routes that launch
them for a time_signal plugin with no hand-written functor: the torch
myexp plugin (fabber_core_tpu_torch/examples/fwdmodel_exp.py).

  on the host  each kernel compiled as host C++ at double with the
               generated functor (tests/torch_hostcc.py): both forms,
               kernel 7 with and without its LM branch at Q 1 and 2,
               kernel 8 in every mode; against the plain versions
               (ops/fused_vb.py, ops/fused_nlls.py) at float64 within
               1e-9 of each output's scale, against the hand-written
               ExpSum<2> build on the same inputs, staged equal to
               streamed bit for bit, and kernel 8's fresh launch equal
               to its phase 1 + resume bit for bit;
  routes       myexp with engine-kernel=pallas (kernel 7's plain version
               on the CPU) against the JAX engine's kernel 7 interpreted,
               and method=nlls (kernel 8's plain version) against the
               JAX nlls-kernel interpreted, at float32 with the
               tolerances of tests/test_torch_nl_engine.py and
               tests/test_torch_nlls_engine.py;
  libraries    the generated builds' sources, flags and keys: one
               functor gives kernel 6's, kernel 7's and kernel 8's
               libraries under three keys, kernel 8's with -fmad=false.

The generated functor differs from ExpSum<2> in rounding only (its
Jacobian by dual numbers), so at double the two builds agree within
1e-10 of each output's scale (kernel 7's damped LM solve and its F
quadratics amplify the last bits to ~1.4e-12), the bound the hand-written
build keeps to the plain version (tests/test_torch_nl_kernels.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from fabber_core_tpu.inference.nlls import NLLSInference as JNLLS
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import base as jbase
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.models import load_models_from_file as jload
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.inference.nlls import NLLSInference
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.models import base as tbase
from fabber_core_tpu_torch.models import get_model_class, load_models_from_file
from fabber_core_tpu_torch.models.kernelgen import derive_time_signal_functor
from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.ops import fused_nlls as fn
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc
from torch_generic_models import restored

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TORCH_PLUGIN = ROOT / "fabber_core_tpu_torch" / "examples" / "fwdmodel_exp.py"
JAX_PLUGIN = ROOT / "examples" / "fwdmodel_exp.py"
NT, NV, DT = 24, 96, 0.1


@pytest.fixture(scope="module")
def myexp():
    """The torch myexp model (num-exps 2: biexp's signal, log transforms)
    and its functor generated from time_signal; both plugins' names
    removed from the registries afterwards."""
    with restored(tbase._MODELS, jbase._MODELS):
        load_models_from_file(str(TORCH_PLUGIN))
        jload(str(JAX_PLUGIN))
        o = RunOptions({"model": "myexp", "dt": str(DT), "num-exps": "2"})
        model = get_model_class("myexp")(o)
        tle = derive_time_signal_functor(model, 4)
        assert tle is not None and tle.fn is None
        yield {"model": model, "tle": tle,
               "tr": [p.transform for p in tbase.resolve_parameters(model,
                                                                    o)]}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """Host builds, made once per (kernel, functor, Q, form)."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    built = {}

    def get(kind, functor, q=None, staged=True):
        key = (kind, functor if isinstance(functor, str) else "gen", q,
               staged)
        if key not in built:
            d = tmp_path_factory.mktemp("host")
            built[key] = (torch_hostcc.vb_iter_kernel_fn(functor, q, d)
                          if kind == "iter" else
                          torch_hostcc.nlls_kernel_fn(functor, d, staged))
        return built[key]
    return get


def biexp_case(seed, nv=NV, nt=NT):
    """Latent (log) centres near the truth of a two-component decay, its
    noisy data [T,V] and loose priors, float64."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * DT
    a1, r1 = rng.uniform(0.8, 1.6, nv), rng.uniform(0.6, 1.2, nv)
    a2, r2 = rng.uniform(0.3, 0.8, nv), rng.uniform(3.0, 6.0, nv)
    data = (a1 * np.exp(-r1 * t[:, None]) + a2 * np.exp(-r2 * t[:, None])
            + rng.normal(0, 0.02, (nt, nv)))
    truth = np.log(np.stack([a1, r1, a2, r2]))
    centre = truth + rng.normal(0, 0.1, truth.shape)
    return {"data": data, "centre": centre, "pm": np.zeros_like(centre),
            "pp": np.full_like(centre, 1e-2)}


def near(got, ref, rel):
    ref = np.asarray(ref)
    got = np.asarray(got).reshape(ref.shape)
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


# -- kernel 7 on the host ----------------------------------------------------

ITER_CASES = [(1, False), (1, True), (2, False), (2, True)]


@pytest.mark.parametrize("nq,lm", ITER_CASES,
                         ids=[f"q{q}{'-lm' if lm else ''}"
                              for q, lm in ITER_CASES])
def test_iteration_kernel_generated_on_host(nq, lm, myexp, host):
    """Kernel 7 with the generated functor at double: staged equals
    streamed bit for bit; within 1e-9 of the plain version at float64;
    within 1e-10 of the hand-written ExpSum<2> build."""
    c = biexp_case(seed=10 + nq)
    rng = np.random.default_rng(20 + nq)
    phi = rng.uniform(1000.0, 3000.0, (nq, NV))
    q = np.zeros((nq, NT))
    for t in range(NT):
        q[t % nq, t] = 1.0
    alpha = None
    if lm:
        alpha = 10.0 ** rng.uniform(-6, 2, NV)
        alpha[::4] = 0.0
    tcodes = [fv.TRANSFORM_CODES[tr.code] for tr in myexp["tr"]]
    args = (tcodes, DT, True, c["centre"], c["pm"], c["pp"], phi, c["data"],
            q.T, alpha)
    gen = host("iter", myexp["tle"], nq)
    staged, streamed = gen(True, *args), gen(False, *args)
    for a, b in zip(staged, streamed):
        assert np.array_equal(a, b)
    hand = host("iter", "ExpSum<2>", nq)(True, *args)
    ref = fv.fused_iteration_plain(
        fv.signal_jac_fn(myexp["model"]), myexp["tr"],
        *(torch.from_numpy(c[k]) for k in ("centre", "pm", "pp")),
        torch.from_numpy(phi), torch.from_numpy(c["data"]), q, True,
        None if alpha is None else torch.from_numpy(alpha))
    for a, h, r in zip(staged, hand, ref):
        near(a, r.numpy(), 1e-9)
        near(a, h, 1e-10)


# -- kernel 8 on the host ----------------------------------------------------

NLLS_ITS = 40
CONSTS = [fn.LAMBDA_INIT, fn.LAMBDA_GROW, fn.LAMBDA_SHRINK, fn.LAMBDA_MAX,
          fn.PREC_DIAG_FLOOR, fn.CFTOL, fn.PLATEAU_LAMBDA]


@pytest.mark.parametrize("marquardt", [False, True], ids=["L", "LM"])
def test_nlls_kernel_generated_on_host(marquardt, myexp, host):
    """Kernel 8 with the generated functor at double, in both forms:
    fresh within 1e-9 of the plain version at float64 (iteration counts
    equal), phase 1 (3 steps) + resume equal to fresh bit for bit, the
    two forms equal bit for bit in every mode, and fresh within 1e-10 of
    the hand-written ExpSum<2> build (iteration counts equal)."""
    c = biexp_case(seed=30 + marquardt)
    tmask = np.ones(NT)
    tmask[5] = 0.0
    dof = float(tmask.sum() - 4)
    tcodes = [fv.TRANSFORM_CODES[tr.code] for tr in myexp["tr"]]
    p0 = c["centre"]
    runs = {}
    for staged in (True, False):
        k = host("nlls", myexp["tle"], staged=staged)
        fresh = k(0, marquardt, tcodes, DT, CONSTS, NLLS_ITS, dof, p0,
                  c["data"], tmask, None)
        p1 = k(1, marquardt, tcodes, DT, CONSTS, 3, dof, p0, c["data"],
               tmask, None)
        res = k(2, marquardt, tcodes, DT, CONSTS, NLLS_ITS - 3, dof, p1[0],
                c["data"], tmask, p1[5])
        for a, b in zip(res[:5], fresh[:5]):
            np.testing.assert_array_equal(a, b)
        runs[staged] = (fresh, p1)
    for a, b in zip(runs[True], runs[False]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    fresh = runs[True][0]
    assert 0.0 < float(runs[True][1][5][2].mean()) < 1.0
    ref = fn.fused_nlls_loop_plain(
        fv.signal_jac_fn(myexp["model"]), myexp["tr"],
        torch.from_numpy(p0), torch.from_numpy(c["data"]), tmask, NLLS_ITS,
        marquardt)
    np.testing.assert_array_equal(fresh[2], ref[2].numpy())
    for a, r in zip(fresh[:5], ref):
        near(a, r.numpy(), 1e-9)
    hand = host("nlls", "ExpSum<2>")(0, marquardt, tcodes, DT, CONSTS,
                                     NLLS_ITS, dof, p0, c["data"], tmask,
                                     None)
    np.testing.assert_array_equal(fresh[2], hand[2])
    for a, h in zip(fresh[:5], hand[:5]):
        near(a, h, 1e-10)


# -- the plugin's routes against the JAX package -----------------------------

def myexp_data(nv, nt=30, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * DT
    amp = rng.uniform(0.6, 1.4, nv)
    d = amp[:, None] * np.exp(-rng.uniform(0.7, 1.3, nv)[:, None] * t)
    return (d + rng.normal(0, 0.05, (nv, nt))).astype(np.float32)


def test_pallas_route_matches_jax(myexp):
    """myexp (one exponential) at float32 with engine-kernel=pallas: the
    port's per-iteration route (kernel 7's plain version here; on the
    card the generated functor's kernel) against the JAX engine's kernel
    7 interpreted, at tests/test_torch_nl_engine.py's tolerances."""
    data = myexp_data(64, seed=4)
    o = {"model": "myexp", "dt": str(DT), "noise": "white",
         "max-iterations": "10", "dtype": "single", "save-free-energy": True,
         "engine-kernel": "pallas"}
    eng = VBInference(get_model_class("myexp")(RunOptions(o)),
                      RunOptions(o), data, device="cpu")
    assert eng.route == "pallas"
    assert eng.model.kernel_model() is None
    jo = JOptions(o)
    je = JVB(jmodel("myexp")(jo), jo, data, np.zeros((64, 3)))
    assert je.use_fused and je.fused_interpret
    rx, rp = je.run(), eng.run()
    sd = np.sqrt(np.diagonal(rx.cov, axis1=1, axis2=2))
    assert np.max(np.abs(rx.means - rp.means) / np.maximum(sd, 1e-6)) \
        < 5e-3
    np.testing.assert_allclose(rp.means, rx.means, rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(rp.noise_means, rx.noise_means, rtol=2e-3)
    np.testing.assert_allclose(rp.free_energy, rx.free_energy, rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


def test_nlls_kernel_route_matches_jax(myexp):
    """myexp (one exponential) with method=nlls at float32: the port's
    nlls-kernel route (kernel 8's plain version here) against the JAX
    nlls-kernel interpreted, at tests/test_torch_nlls_engine.py's
    float32 bounds."""
    data = myexp_data(128, seed=5)
    o = {"model": "myexp", "dt": str(DT), "dtype": "single",
         "method": "nlls", "mt1": "8"}
    te = NLLSInference(get_model_class("myexp")(RunOptions(o)),
                       RunOptions(o), data, device="cpu")
    assert te.route == "nlls-kernel" and te.functor is None
    jo = JOptions({**o, "engine-kernel": "pallas-loop"})
    je = JNLLS(jmodel("myexp")(jo), jo, data, np.zeros((128, 3)))
    assert je.use_nl_kernel
    rx, rp = je.run(), te.run()
    np.testing.assert_allclose(rp.means, rx.means, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(rp.cov, rx.cov, rtol=5e-3, atol=1e-5)
    diff = np.abs(rp.iterations - rx.iterations)
    assert diff.max() <= 30 and np.median(diff) <= 4
    np.testing.assert_array_equal(rp.bad_voxels, rx.bad_voxels)


# -- the generated libraries -------------------------------------------------

def test_generated_libraries_are_distinct_per_kernel(myexp):
    """One functor at one Q gives kernel 6's and kernel 7's libraries
    under different keys (their templates differ), kernel 6's full-time
    form's under a third, and kernel 8's under a fourth, built with the
    NLLS source's -fmad=false; each source holds its kernel's entry
    points and header."""
    src = myexp["tle"].source
    keys = {k: _cuda.generated_key(src, 4, None if k == "nlls" else 1, k)
            for k in _cuda.GEN_KERNELS}
    assert len(set(keys.values())) == len(_cuda.GEN_KERNELS) == 4
    assert keys["nl_loop"] == _cuda.generated_key(src, 4, 1)
    cus = {k: _cuda.generated_source(src, 4, None if k == "nlls" else 1, k)
           for k in _cuda.GEN_KERNELS}
    for kernel, entry, header in (
            ("nl_loop", "fabber_gen_nl_loop(", "fused_nl_loop.cuh"),
            ("nl_loop_full", "fabber_gen_nl_loop_full(",
             "fused_nl_loop.cuh"),
            ("vb_iter", "fabber_gen_vb_iter(", "fused_vb_iter.cuh"),
            ("nlls", "fabber_gen_nlls(", "fused_nlls.cuh")):
        assert entry in cus[kernel] and f'#include "{header}"' in cus[kernel]
        assert src in cus[kernel]
    assert "-fmad=false" in _cuda._gen_flags("nlls")
    assert "-fmad=false" not in _cuda._gen_flags("vb_iter")
    # a header edit moves every key
    assert set(_cuda.HEADERS) >= {"fused_vb_iter.cuh", "fused_nlls.cuh",
                                  "fused_nl_loop.cuh", "dual.cuh"}
    with pytest.raises(ValueError):
        _cuda.build_generated(src, 4, 1, "nlls")
    with pytest.raises(ValueError):
        _cuda.build_generated(src, 4, None, "vb_iter")


def test_generated_wrappers_need_their_library(myexp):
    """The wrappers launch a generated functor's library only from
    functor.libs[(kernel, Q)]; one built for another kernel or Q does
    not serve (the engine builds each before it launches)."""
    tle = derive_time_signal_functor(myexp["model"], 4)
    tle.libs[("nl_loop", 1)] = object()
    with pytest.raises(ValueError, match="vb_iter"):
        fv.generated_lib(tle, "vb_iter", 1)
    with pytest.raises(ValueError, match="nlls"):
        fv.generated_lib(tle, "nlls", None)
    assert fv.generated_lib(tle, "nl_loop", 1) is tle.libs[("nl_loop", 1)]
