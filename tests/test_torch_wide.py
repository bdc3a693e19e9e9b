"""P = 5..8 on the card: the instances this size added to the nonlinear
kernels (ExpSum<3> and ExpSum<4>, and functors generated from a model up
to P = 8), the engines' runs at P = 6, and the card's route gate.

  on the host  kernels 6, 7 and 8 compiled as host C++ at double
               (tests/torch_hostcc.py) with the hand-written ExpSum<3>
               and with the functor generated from the torch myexp
               plugin's time_signal at num-exps 3 (P = 6): staged equal
               to streamed bit for bit, within 1e-9 of the plain
               versions at float64 (the covariance on the lanes whose
               precision has a condition number <= 1e6, see
               tests/test_torch_nlls_kernels.py assert_f64_match), and
               the two functors within 1e-9 of each other;
  engines      linear P = 6 (a cosine design file) with noise-pattern=12
               on 'pallas-whole' (kernel 4's plain version) against the
               JAX engine's pallas-whole, interpreted, at float32
               (tests/test_torch_stats_engine.py's bounds); AR(1) noise
               at P = 6 on 'pallas-loop-ar' against the JAX engine's
               pallas-loop at float32 (tests/test_torch_ar_engine.py's);
               exp with num-exps 3 through 'pallas-loop-nl' and 'pallas'
               against the JAX routes at a short horizon (a sum of
               exponentials is chaotic at float32, ROADMAP Queue 3 item
               7) and method=nlls by fit;
  route gate   vb.py require_card_instance on every branch and the
               messages it raises, and the engines' gates with the
               library's instance queries stood in for (the card tests
               ask the real ones): kernels 6-8 raise past their lists
               and functors, kernels 4, 5 and 9 take per-shape instances
               past theirs (tests/test_torch_wide_design.py).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from fabber_core_tpu.inference.nlls import NLLSInference as JNLLS
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.inference import nlls as nlls_module
from fabber_core_tpu_torch.inference import vb as vb_module
from fabber_core_tpu_torch.inference.nlls import NLLSInference
from fabber_core_tpu_torch.inference.vb import (VBInference,
                                                require_card_instance)
from fabber_core_tpu_torch.io import matfile
from fabber_core_tpu_torch.models import base as tbase
from fabber_core_tpu_torch.models import get_model_class, load_models_from_file
from fabber_core_tpu_torch.models.kernelgen import derive_time_signal_functor
from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.ops import fused_loop_nl as nl
from fabber_core_tpu_torch.ops import fused_nlls as fn
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc
from test_torch_ar_engine import assert_f32_match as ar_f32_match
from test_torch_nl_engine import assert_match as nl_match
from test_torch_nlls_kernels import assert_f64_match as nlls_f64_match
from test_torch_stats_engine import assert_f32_match
from torch_generic_models import restored

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TORCH_PLUGIN = ROOT / "fabber_core_tpu_torch" / "examples" / "fwdmodel_exp.py"
NT, NV, DT = 24, 64, 0.1
# exp with num-exps 3: amplitudes and rates of the three components
TRUTH = [1.5, 0.3, 1.0, 1.5, 0.75, 6.0]


@pytest.fixture(scope="module")
def triexp():
    """exp at num-exps 3 (ExpSum<3>) and the torch myexp plugin at
    num-exps 3 with its functor generated from time_signal (P = 6); the
    plugin's name removed from the registry afterwards."""
    with restored(tbase._MODELS):
        load_models_from_file(str(TORCH_PLUGIN))
        o = RunOptions({"model": "exp", "dt": str(DT), "num-exps": "3"})
        model = get_model_class("exp")(o)
        mo = RunOptions({"model": "myexp", "dt": str(DT), "num-exps": "3"})
        myexp = get_model_class("myexp")(mo)
        tle = derive_time_signal_functor(myexp, 6)
        assert tle is not None and tle.nparams == 6
        yield {"model": model, "myexp": myexp, "tle": tle,
               "tr": [p.transform for p in tbase.resolve_parameters(model,
                                                                    o)]}


def triexp_case(seed, nv=NV, nt=NT):
    """Latent (log) centres near the truth (each parameter scaled by
    U(0.8, 1.2) per voxel), noisy data [T,V] and loose priors, float64."""
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * DT
    m = np.asarray(TRUTH)[:, None] * rng.uniform(0.8, 1.2, (6, nv))
    data = sum(m[2 * i] * np.exp(-m[2 * i + 1] * t[:, None])
               for i in range(3)) + rng.normal(0, 0.02, (nt, nv))
    centre = np.log(m) + rng.normal(0, 0.05, m.shape)
    return {"data": data, "centre": centre, "pm": np.zeros_like(centre),
            "pp": np.full_like(centre, 1e-2)}


def near(got, ref, rel, keep=None):
    ref = np.asarray(ref)
    got = np.asarray(got).reshape(ref.shape)
    if keep is not None:
        got, ref = got[..., keep], ref[..., keep]
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


def well_conditioned(prec, max_cond=1e6):
    prec = np.asarray(prec, np.float64)
    p = prec.shape[0]
    prec = prec.reshape(p, p, -1)
    return np.array([np.linalg.cond(prec[:, :, v]) <= max_cond
                     for v in range(prec.shape[-1])])


# -- kernels 6, 7 and 8 on the host at P = 6 ---------------------------------

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
            build = {"loop": lambda: torch_hostcc.kernel_fn(functor, q, d,
                                                            staged),
                     "iter": lambda: torch_hostcc.vb_iter_kernel_fn(
                         functor, q, d),
                     "nlls": lambda: torch_hostcc.nlls_kernel_fn(
                         functor, d, staged)}[kind]
            built[key] = build()
        return built[key]
    return get


FUNCTORS = ["ExpSum<3>", "generated"]


def functor_of(name, triexp):
    return triexp["tle"] if name == "generated" else name


@pytest.mark.parametrize("name", FUNCTORS)
def test_whole_loop_kernel_on_host_p6(name, triexp, host):
    """Kernel 6 (maxits, 5 iterations, pattern 12) at double: staged
    equals streamed bit for bit, both within 1e-9 of the plain version
    at float64 (the covariance on well-conditioned lanes)."""
    c = triexp_case(seed=40)
    nq = 2
    q = np.zeros((nq, NT))
    q[np.arange(NT) % nq, np.arange(NT)] = 1.0
    functor = functor_of(name, triexp)
    tcodes = [fv.TRANSFORM_CODES[tr.code] for tr in triexp["tr"]]
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                               q.sum(axis=1), 1e-8, 50.0, nq).numpy()
    args = (tcodes, 5, True, consts, (0, 0.0, 0, 0, 0), [0.0] * (nq + 2),
            c["centre"], c["pm"], c["pp"], None, c["data"], None, q.T)
    dt = {} if name == "generated" else {"dt": DT}
    staged = host("loop", functor, nq, True)(*args, **dt)
    streamed = host("loop", functor, nq, False)(*args, **dt)
    for a, b in zip(staged, streamed):
        assert np.array_equal(a, b)
    ref = nl.fused_nl_loop_plain(
        fv.signal_jac_fn(triexp["model"]), triexp["tr"],
        *(torch.from_numpy(c[k]) for k in ("centre", "pm", "pp")),
        torch.from_numpy(c["data"]), q, torch.from_numpy(consts), 5, True)
    keep = well_conditioned(ref[1].numpy())
    assert keep.mean() > 0.5
    for i, (a, r) in enumerate(zip(staged, ref)):
        near(a, r.numpy(), 1e-9, keep if i == 2 else None)


@pytest.mark.parametrize("lm", [False, True], ids=["plain", "lm"])
def test_iteration_kernel_on_host_p6(lm, triexp, host):
    """Kernel 7 at double, Q=1, with and without its LM branch: staged
    equals streamed bit for bit; the hand-written ExpSum<3> and the
    generated functor each within 1e-9 of the plain version at float64
    and of each other."""
    c = triexp_case(seed=41)
    rng = np.random.default_rng(42)
    phi = rng.uniform(1000.0, 3000.0, (1, NV))
    alpha = None
    if lm:
        alpha = 10.0 ** rng.uniform(-6, 2, NV)
        alpha[::4] = 0.0
    q = np.ones((1, NT))
    tcodes = [fv.TRANSFORM_CODES[tr.code] for tr in triexp["tr"]]
    args = (tcodes, DT, True, c["centre"], c["pm"], c["pp"], phi,
            c["data"], q.T, alpha)
    ref = fv.fused_iteration_plain(
        fv.signal_jac_fn(triexp["model"]), triexp["tr"],
        *(torch.from_numpy(c[k]) for k in ("centre", "pm", "pp")),
        torch.from_numpy(phi), torch.from_numpy(c["data"]), q, True,
        None if alpha is None else torch.from_numpy(alpha))
    keep = well_conditioned(ref[1].numpy())
    outs = {}
    for name in FUNCTORS:
        k = host("iter", functor_of(name, triexp), 1)
        staged, streamed = k(True, *args), k(False, *args)
        for a, b in zip(staged, streamed):
            assert np.array_equal(a, b)
        for i, (a, r) in enumerate(zip(staged, ref)):
            near(a, r.numpy(), 1e-9, keep if i == 2 else None)
        outs[name] = staged
    for i, (a, b) in enumerate(zip(*outs.values())):
        near(a, b, 1e-9, keep if i == 2 else None)


@pytest.mark.parametrize("name", FUNCTORS)
def test_nlls_kernel_on_host_p6(name, triexp, host):
    """Kernel 8 (fresh Levenberg, 30 steps) at double in both forms:
    fresh within 1e-9 of the plain version at float64
    (tests/test_torch_nlls_kernels.py assert_f64_match, the covariance
    on lanes of condition <= 1e6), phase 1 (3 steps) + resume equal to
    fresh, the forms equal bit for bit in every mode."""
    c = triexp_case(seed=43)
    tmask = np.ones(NT)
    tmask[5] = 0.0
    consts = [fn.LAMBDA_INIT, fn.LAMBDA_GROW, fn.LAMBDA_SHRINK,
              fn.LAMBDA_MAX, fn.PREC_DIAG_FLOOR, fn.CFTOL,
              fn.PLATEAU_LAMBDA]
    dof = float(tmask.sum() - 6)
    tcodes = [fv.TRANSFORM_CODES[tr.code] for tr in triexp["tr"]]
    functor = functor_of(name, triexp)
    runs = {}
    for staged in (True, False):
        k = host("nlls", functor, staged=staged)
        fresh = k(0, False, tcodes, DT, consts, 30, dof, c["centre"],
                  c["data"], tmask, None)
        p1 = k(1, False, tcodes, DT, consts, 3, dof, c["centre"],
               c["data"], tmask, None)
        res = k(2, False, tcodes, DT, consts, 27, dof, p1[0], c["data"],
                tmask, p1[5])
        for a, b in zip(res[:5], fresh[:5]):
            np.testing.assert_array_equal(a, b)
        runs[staged] = (fresh, p1, res)
    for a, b in zip(runs[True], runs[False]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    fresh = runs[True][0]
    ref = fn.fused_nlls_loop_plain(
        fv.signal_jac_fn(triexp["model"]), triexp["tr"],
        torch.from_numpy(c["centre"]), torch.from_numpy(c["data"]), tmask,
        30, False)
    nlls_f64_match(list(fresh[:5]), [r.numpy().reshape(f.shape)
                                     for r, f in zip(ref, fresh[:5])],
                   max_cond=1e6)


# -- the engines at P = 6 against the JAX engine -----------------------------

def cosine_basis(tmp_path, p, nt):
    t = (np.arange(nt) + 0.5) / nt
    d = np.cos(np.pi * t[:, None] * np.arange(p)[None])
    path = str(tmp_path / "cosine.mat")
    matfile.write_vest(d, path)
    return path, d


def test_linear_p6_pattern_takes_whole_kernel_and_matches_jax(tmp_path):
    """linear P = 6 with noise-pattern=12 at float32 takes 'pallas-whole'
    (kernel 4's plain version here) and matches the JAX engine's
    pallas-whole (its kernel interpreted) within
    tests/test_torch_stats_engine.py's float32 bounds."""
    nt, nv = 40, 256
    path, d = cosine_basis(tmp_path, 6, nt)
    rng = np.random.default_rng(7)
    gsd = np.where(np.arange(nt) % 2 == 0, 1.0, 2.0)[:, None]
    data = (d @ rng.uniform(-1, 1, (6, nv)) + gsd * 10.0 ** rng.uniform(
        -2, 0, nv) * rng.standard_normal((nt, nv))).T.astype(np.float32)
    o = {"model": "linear", "basis": path, "noise": "white",
         "noise-pattern": "12", "max-iterations": "10", "dtype": "single",
         "print-free-energy": True}
    eng = VBInference(get_model_class("linear")(RunOptions(o)),
                      RunOptions(o), data, device="cpu")
    assert eng.route == "pallas-whole" and eng.nparams == 6
    jo = JOptions({**o, "engine-kernel": "pallas-whole"})
    je = JVB(jmodel("linear")(jo), jo, data, np.zeros((nv, 3)))
    assert je.use_whole_kernel
    assert_f32_match(je.run(), eng.run())


def test_ar_p6_matches_jax_kernel_route(tmp_path):
    """AR(1) noise (two echoes, pointzeroone) on linear P = 6 at float32
    takes 'pallas-loop-ar' (kernel 9's plain version here) and matches
    the JAX engine's pallas-loop interpreted within
    tests/test_torch_ar_engine.py's float32 bounds."""
    nt, nv = 60, 200
    path, d = cosine_basis(tmp_path, 6, nt)
    rng = np.random.default_rng(8)
    e = rng.standard_normal((nt, nv))
    for k in range(2, nt):
        e[k] += 0.4 * e[k - 2]
    data = (d @ rng.uniform(-1, 1, (6, nv)) + 10.0 ** rng.uniform(
        -2, 0, nv) * e).T.astype(np.float32)
    o = {"model": "linear", "basis": path, "noise": "ar", "num-echoes": "2",
         "convergence": "pointzeroone", "max-iterations": "10",
         "dtype": "single", "print-free-energy": True}
    eng = VBInference(get_model_class("linear")(RunOptions(o)),
                      RunOptions(o), data, device="cpu")
    assert eng.route == "pallas-loop-ar"
    jo = JOptions({**o, "engine-kernel": "pallas-loop"})
    je = JVB(jmodel("linear")(jo), jo, data, np.zeros((nv, 3)))
    rp = eng.run()
    ar_f32_match(je.run(), rp)
    assert len(np.unique(rp.iterations)) > 1


def triexp_data(nv, nt=40, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(nt) * 0.05
    m = np.asarray(TRUTH)[:, None] * rng.uniform(0.8, 1.2, (6, nv))
    return (sum(m[2 * i][:, None] * np.exp(-m[2 * i + 1][:, None] * t)
                for i in range(3))
            + rng.normal(0, 0.02, (nv, nt))).astype(np.float32)


@pytest.mark.parametrize("jmode,extra,route", [
    ("pallas-loop", {}, "pallas-loop-nl"),
    ("pallas", {"engine-kernel": "pallas"}, "pallas")],
    ids=["pallas-loop-nl", "pallas"])
def test_triexp_vb_routes_match_jax_at_a_short_horizon(jmode, extra, route):
    """exp with num-exps 3 at float32 on the kernel routes (the plain
    versions of kernels 6 and 7 here; ExpSum<3> on the card) against the
    JAX engine's routes, interpreted, over 2 iterations from the model's
    start, voxel by voxel at tests/test_torch_nl_engine.py's bounds
    (assert_match). At 10 iterations the two agree by sorted parameters
    in 8% of voxels: a sum of three exponentials is chaotic at float32
    (ROADMAP Queue 3 item 7); at 2, within 1e-6 posterior sd."""
    data = triexp_data(96)
    o = {"model": "exp", "num-exps": "3", "dt": "0.05", "noise": "white",
         "max-iterations": "2", "dtype": "single", "save-free-energy": True,
         **extra}
    eng = VBInference(get_model_class("exp")(RunOptions(o)), RunOptions(o),
                      data, device="cpu")
    assert eng.route == route and eng.nparams == 6
    jo = JOptions({**o, "engine-kernel": jmode})
    rx = JVB(jmodel("exp")(jo), jo, data, np.zeros((96, 3))).run()
    nl_match(rx, eng.run())


def test_triexp_nlls_kernel_route_matches_jax():
    """exp with num-exps 3, method=nlls at float32: 'nlls-kernel' (kernel
    8's plain version here; ExpSum<3> on the card) against the JAX
    nlls-kernel interpreted, by fit: a float32 J'J of three exponentials
    is near singular, so which lanes' posteriors come out non-finite
    (bad voxels) and their parameters move with rounding (even over 3
    steps: 2e-3 relative), as the biexp rule of
    tests/test_torch_nl_engine.py allows. The port's bad voxels at most
    5 more than the JAX engine's; on the lanes both fit, the fits within
    1e-3 of the data's scale in >= 95%."""
    data = triexp_data(96, seed=1)
    o = {"model": "exp", "num-exps": "3", "dt": "0.05", "method": "nlls",
         "dtype": "single"}
    te = NLLSInference(get_model_class("exp")(RunOptions(o)), RunOptions(o),
                       data, device="cpu")
    assert te.route == "nlls-kernel"
    jo = JOptions({**o, "engine-kernel": "pallas-loop"})
    je = JNLLS(jmodel("exp")(jo), jo, data, np.zeros((96, 3)))
    assert je.use_nl_kernel
    rx, rp = je.run(), te.run()
    assert rp.bad_voxels.sum() <= rx.bad_voxels.sum() + 5
    ok = ~(rx.bad_voxels | rp.bad_voxels)
    fits = [te.evaluate_model(torch.as_tensor(r.means.T, dtype=torch.float64))
            .numpy()[:, ok] for r in (rx, rp)]
    err = np.abs(fits[0] - fits[1]).max(axis=0)
    assert (err <= 1e-3 * np.abs(data).max()).mean() >= 0.95


# -- the card's route gate ----------------------------------------------------

def test_card_instance_passes_a_route_with_an_instance():
    for route in vb_module.ROUTE_KERNEL:
        assert require_card_instance(route, 3, 1, lambda r: True,
                                     lambda r: False) is None
    assert require_card_instance("pallas-loop-nl", 8, 4, lambda r: False,
                                 lambda r: True) is None
    # routes without a kernel pass unasked
    for route in ("xla", "spectral-whole", "xla-generic", "nlls-generic"):
        assert require_card_instance(route, 9, 5, None, None) is None


@pytest.mark.parametrize("route", list(vb_module.ROUTE_KERNEL))
def test_card_instance_raises_without_one(route):
    """No instance and no functor: the card raises, naming the kernel,
    the run's shape and the list to extend, and takes no other route."""
    asked = []

    def no(r):
        asked.append(r)
        return False
    q = None if route == "nlls-kernel" else 1
    kernel = vb_module.ROUTE_KERNEL[route]
    shape = "P=9" + ("" if q is None else ", Q=1")
    with pytest.raises(NotImplementedError) as err:
        require_card_instance(route, 9, q, no, no)
    msg = str(err.value)
    assert msg.startswith(f"no ({shape}) instance of kernel {kernel} "
                          f"({vb_module.INSTANCE_LISTS[kernel]})")
    assert f"the '{route}' route cannot run this on the card" in msg
    assert "device='cpu'" in msg
    assert ("no functor can be generated" in msg) == (kernel in (6, 7, 8))
    assert asked == [route, route]


def test_generated_functor_limits_come_from_the_header():
    """generatable asks csrc/vb_device.cuh's kWideMaxP (kernel 7: its
    cooperative form's kCoopMaxP) and kWideMaxQ, read from the header the
    kernels compile with (P <= 42, 143 for kernel 7, Q <= 35: past kMaxP,
    kMaxQ a generated functor takes the per-shape body)."""
    assert _cuda.gen_limits() == (42, 35)
    assert _cuda.gen_limits("nlls") == (42, 35)
    assert _cuda.gen_limits("vb_iter") == (143, 35)
    functor = object()
    for kernel in ("nl_loop", "vb_iter"):
        assert vb_module.generatable(functor, 8, 4, kernel)
        assert vb_module.generatable(functor, 12, 5, kernel)
        assert vb_module.generatable(functor, 42, 35, kernel)
        assert not vb_module.generatable(functor, 6, 36, kernel)
        assert not vb_module.generatable(None, 2, 1, kernel)
    assert vb_module.generatable(functor, 42, None, "nlls")
    assert not vb_module.generatable(functor, 43, 1, "nl_loop")
    assert not vb_module.generatable(functor, 43, None, "nlls")
    assert vb_module.generatable(functor, 143, 35, "vb_iter")
    assert not vb_module.generatable(functor, 144, 1, "vb_iter")


def test_card_instance_takes_the_functor_of_its_own_route():
    """functor_ok is asked for the route itself: kernel 7 having a
    functor does not admit kernel 6's route, nor the other way round."""
    def only(route):
        return lambda r: r == route
    with pytest.raises(NotImplementedError, match=r"\(P=6, Q=5\).*kernel 6"):
        require_card_instance("pallas-loop-nl", 6, 5, lambda r: False,
                              only("pallas"))
    assert require_card_instance("pallas", 6, 5, lambda r: False,
                                 only("pallas")) is None
    with pytest.raises(NotImplementedError, match="kernel 7"):
        require_card_instance("pallas", 6, 5, only("pallas-loop-nl"),
                              lambda r: False)


def linear_engine(tmp_path, p, extra):
    path, _ = cosine_basis(tmp_path, p, 30)
    o = RunOptions({"model": "linear", "basis": path, "noise": "white",
                    "max-iterations": "10", "dtype": "single", **extra})
    return VBInference(get_model_class("linear")(o), o,
                       np.ones((4, 30), np.float32), device="cpu")


def on_card(eng):
    eng.device = torch.device("cuda")
    eng._require_kernel_instance()
    return eng


@pytest.mark.parametrize("extra,route", [
    ({"noise-pattern": "1234"}, "pallas-whole"),
    ({"engine-kernel": "pallas-loop"}, "pallas-loop"),
    ({"noise": "ar"}, "pallas-loop-ar")])
def test_fixed_design_gate_on_card(tmp_path, monkeypatch, extra, route):
    """On the card a fixed-design kernel route keeps its kernel past the
    prebuilt lists, at (P=8, Q=4) and at P=9: a per-shape instance
    serves it (ops/_cuda.py build_instance), built at the route's first
    launch, so choosing the route builds nothing and raises nothing. The
    library's instance queries are stood in for (their lists: P <= 8, Q
    <= 2 at P > 5)."""
    monkeypatch.setattr(_cuda, "has_whole_instance",
                        lambda p, q: p <= 8 and q <= (3 if p <= 5 else 2))
    monkeypatch.setattr(_cuda, "has_ar_instance",
                        lambda p, q: p <= 8 and q <= 2)
    built = []
    monkeypatch.setattr(_cuda, "build_instance", lambda *a: built.append(a))
    for p in (8, 9):
        eng = linear_engine(tmp_path, p, extra)
        assert eng.route == route
        assert on_card(eng).route == route
    assert built == []


def test_nonlinear_gate_on_card_builds_only_what_runs(monkeypatch):
    """exp at num-exps 3 and 4 has its hand-written instance, at num-exps
    5 (P = 10, where the card raised before per-shape instances) a
    per-shape one built at the route's first launch: construction builds
    nothing for kernel 6 or the NLLS kernel and raises nothing. At
    num-exps 22 (P = 44) the JAX pickers admit neither kernel 6 nor 8:
    VB takes 'pallas', whose kernel 7 runs there in its cooperative form
    (a per-shape unit, built at the first launch; the card raised there
    before it), and NLLS 'nlls-generic', which has no kernel."""
    built = []
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda *a: built.append(a) or "lib")
    monkeypatch.setattr(_cuda, "build_instance",
                        lambda *a: built.append(a) or "lib")
    monkeypatch.setattr(_cuda, "has_nl_instance",
                        lambda kind, p, q: kind == 1 and p <= 8 and q <= 2)
    monkeypatch.setattr(_cuda, "has_nlls_instance",
                        lambda kind, p: kind == 1 and p <= 8)
    data = triexp_data(8)
    for num in ("3", "4", "5", "22"):
        o = RunOptions({"model": "exp", "num-exps": num, "dt": "0.05",
                        "noise": "white", "dtype": "single"})
        eng = VBInference(get_model_class("exp")(o), o, data, device="cpu")
        o = RunOptions({"model": "exp", "num-exps": num, "dt": "0.05",
                        "method": "nlls", "dtype": "single"})
        neng = NLLSInference(get_model_class("exp")(o), o, data,
                             device="cpu")
        neng.device = torch.device("cuda")
        if num == "22":
            assert (eng.route, neng.route) == ("pallas", "nlls-generic")
            assert on_card(eng).functor is None
            # the unit it builds compiles the cooperative form (kIterCoop)
            assert "#define FABBER_ROLL_LOOPS" in _cuda.instance_sources(
                "nl", 44, 1, 1, "vb_iter")["fused_vb_iter"]
            neng._require_kernel_instance()
        else:
            assert (eng.route, neng.route) == ("pallas-loop-nl",
                                               "nlls-kernel")
            assert on_card(eng).functor is None
            neng._require_kernel_instance()
            assert neng.functor is None
    assert built == []


def test_generated_p6_functor_is_built_on_card(triexp, monkeypatch):
    """myexp at num-exps 3 (no hand-written functor) on the card: its
    functor generated from time_signal (P = 6) is built for kernel 6 at
    construction, and for kernel 8 by the NLLS engine."""
    built = []
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda src, p, q, kernel: built.append(
                            (p, q, kernel)) or kernel)
    monkeypatch.setattr(_cuda, "has_nlls_instance", lambda kind, p: False)
    data = triexp_data(8)
    with restored(tbase._MODELS):
        load_models_from_file(str(TORCH_PLUGIN))
        o = RunOptions({"model": "myexp", "num-exps": "3", "dt": "0.05",
                        "noise": "white", "dtype": "single"})
        eng = on_card(VBInference(get_model_class("myexp")(o), o, data,
                                  device="cpu"))
        assert eng.route == "pallas-loop-nl"
        assert eng.functor.libs == {("nl_loop", 1): "nl_loop"}
        o = RunOptions({"model": "myexp", "num-exps": "3", "dt": "0.05",
                        "method": "nlls", "dtype": "single"})
        neng = NLLSInference(get_model_class("myexp")(o), o, data,
                             device="cpu")
        neng.device = torch.device("cuda")
        neng._require_kernel_instance()
        assert neng.route == "nlls-kernel"
    assert built == [(6, 1, "nl_loop"), (6, None, "nlls")]
