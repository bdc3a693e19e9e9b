"""Kernels 6, 7 and 8 past P = 8 and Q = 4: the per-shape instances of the
nonlinear kernels (ops/_cuda.py build_instance "nl") and the route gates
that send the card to them wherever the JAX engine on a TPU runs its
kernels.

  gate parity   the port's VB and NLLS routes against the JAX engine's
                gate (read from construction: use_nl_loop, use_fused,
                use_nl_kernel) over exp num-exps 1-22 (P 2-44) around
                kernel 6's picker bounds at Q 1-35 (noise patterns),
                maxits, pointzeroone and trialmode, T 10-500, under
                engine-kernel=pallas-loop and auto (jax.default_backend
                patched to "tpu"), the generic mode of an evaluate-only
                exp sum, and kernel 7's shapes past P = 42;
  time planes   models/kernelgen.py's count of the generic trace's
                time-carrying intermediates against the JAX package's
                (fn.time_planes);
  plain vs JAX  the plain versions of kernels 6 (3 iterations), 7 (one)
                and 8 (fresh) at exp num-exps 5 (P = 10) and biexp at
                noise-pattern 123456 (Q = 6) against the JAX kernels
                interpreted at float64, tens of voxels; the CPU route at
                exp num-exps 22 (P = 44) against an iteration composed
                from the JAX model and transforms at float64;
  on the host   the per-shape bodies compiled as host C++ at double
                (tests/torch_hostcc.py): kernels 6, 7 (per lane, and its
                cooperative form at (8, 35), (24, 4) and (44, 1); plain
                and LM) and 8 at P = 10, Q = 1, and 6 and 7 at P = 4, Q =
                6, against the plain versions at float64;
  limits        instance_limits("nl", kernel), instance_buildable, the
                units' defines, and the card's gate (the device stood in
                for): it raises past kernel 7's shared-memory bound
                alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fabber_core_tpu.inference.vb as jvb_module
from fabber_core_tpu.inference.nlls import NLLSInference as JNLLS
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.models.base import \
    derive_time_local_eval as jderive
from fabber_core_tpu.models.base import resolve_parameters as jresolve
from fabber_core_tpu.ops import fused_loop_nl as jnl
from fabber_core_tpu.ops import fused_nlls as jfn
from fabber_core_tpu.ops import fused_vb as jfv
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.inference.nlls import NLLSInference
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.models import (get_model_class,
                                          resolve_parameters)
from fabber_core_tpu_torch.models.kernelgen import derive_time_local_eval
from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.ops import fused_loop_nl as nl
from fabber_core_tpu_torch.ops import fused_nlls as fn
from fabber_core_tpu_torch.ops import fused_vb as fv
from fabber_core_tpu_torch.options import RunOptions

import test_fused_loop_generic as jgen
import torch_hostcc
from torch_generic_models import GaussianAct, SuppScaled, stripped_exp

torch.set_num_threads(1)

# noise patterns by their group count (a pattern has at most 35 groups:
# 1-9 and A-Z)
PATTERNS = {1: "1", 2: "12", 4: "1234", 8: "12345678",
            16: "123456789ABCDEFG",
            35: "123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"}
# exp num-exps around kernel 6's JAX bound at each Q (maxits / trialmode
# at T = 100: P 39 / 36, 32 / 31, 25 / 24, 19 / 18, 13 / 13, 8 / 8), and
# past kernel 8's (P 42) and kernel 7's cap (P 42)
GATE_NUMS = {1: (1, 5, 18, 19, 20, 21, 22), 2: (2, 16, 17),
             4: (2, 12, 13), 8: (2, 9, 10, 13), 16: (6, 7), 35: (1, 4, 5)}
DETS = ("maxits", "pointzeroone", "trialmode")


def jax_vb_route(jeng):
    """The JAX engine's nonlinear route, in the port's names."""
    if jeng.use_nl_loop:
        return "pallas-loop-nl"
    return "pallas" if jeng.use_fused else "xla-generic"


def vb_pair(o, nt, jm=None, tm=None):
    """(the JAX engine's route, the port's) for options o at T = nt."""
    data = np.ones((4, nt), np.float32)
    coords = np.zeros((4, 3))
    jo = JOptions(dict(o))
    jeng = JVB(jm or jmodel(o["model"])(jo), jo, data, coords)
    to = RunOptions(dict(o))
    teng = VBInference(tm or get_model_class(o["model"])(to), to, data,
                       device="cpu")
    return jax_vb_route(jeng), teng.route


def exp_options(num, nq, det, mode, **extra):
    return {"model": "exp", "num-exps": str(num), "dt": "0.02",
            "noise": "white", "dtype": "single",
            "noise-pattern": PATTERNS[nq], "convergence": det,
            "max-iterations": "10", "engine-kernel": mode, **extra}


# -- (a) the route gates against the JAX engine's -----------------------------

@pytest.mark.parametrize("nt", [10, 100, 500])
def test_vb_route_matches_jax_gate(nt, monkeypatch):
    """Every (num-exps, Q, detector) of the grid at this T, under
    engine-kernel=pallas-loop and under auto as on a TPU: the port's
    route is the JAX engine's. Kernel 6 runs where the JAX picker admits
    it; past it auto takes kernel 7 and pallas-loop the generic route
    (patterns longer than T are left out, as the engines refuse them)."""
    seen = set()
    for mode in ("pallas-loop", "auto"):
        if mode == "auto":
            monkeypatch.setattr(jvb_module.jax, "default_backend",
                                lambda: "tpu")
        for nq, nums in GATE_NUMS.items():
            if nq > nt:
                continue            # a pattern no longer than the data
            for num in nums:
                for det in DETS:
                    jr, tr = vb_pair(exp_options(num, nq, det, mode), nt)
                    assert tr == jr, (num, nq, det, mode, jr, tr)
                    seen.add((mode, tr))
    assert {("pallas-loop", "pallas-loop-nl"), ("pallas-loop", "xla-generic"),
            ("auto", "pallas-loop-nl"), ("auto", "pallas")} <= seen


@pytest.mark.parametrize("nt", [10, 100, 500])
def test_nlls_route_matches_jax_gate(nt, monkeypatch):
    """method=nlls on exp num-exps 1-22 (P 2-44): kernel 8 where the JAX
    picker admits it (P <= 42 at T = 100, 41 at T = 500), else
    nlls-generic, under auto as on a TPU and pallas-loop."""
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    import fabber_core_tpu.inference.nlls as jnlls_module
    monkeypatch.setattr(jnlls_module.jax, "default_backend", lambda: "tpu")
    data = np.ones((4, nt), np.float32)
    coords = np.zeros((4, 3))
    seen = set()
    for num in range(1, 23):
        for mode in ("auto", "pallas-loop"):
            o = {"model": "exp", "num-exps": str(num), "dt": "0.02",
                 "method": "nlls", "dtype": "single", "engine-kernel": mode}
            jo = JOptions(dict(o))
            je = JNLLS(jmodel("exp")(jo), jo, data, coords)
            jr = "nlls-kernel" if je.use_nl_kernel else "nlls-generic"
            to = RunOptions(dict(o))
            tr = NLLSInference(get_model_class("exp")(to), to, data,
                               device="cpu").route
            assert tr == jr, (num, mode, nt, jr, tr)
            seen.add(tr)
    assert seen == {"nlls-kernel", "nlls-generic"}


def test_motivation_shapes_take_the_jax_routes(monkeypatch):
    """The shapes where the port's gates had no picker (T = 100): exp
    num-exps 20 (P = 40) takes kernel 7 ('pallas'), not kernel 6; NLLS at
    num-exps 22 (P = 44) 'nlls-generic', not kernel 8; num-exps 13 at
    noise-pattern 12345678 (P = 26, Q = 8) 'pallas'. Kernel 8 keeps P =
    40 (num-exps 20), and kernel 6 num-exps 19 (P = 38) at Q = 1."""
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    for num, nq, want in ((20, 1, "pallas"), (13, 8, "pallas"),
                          (19, 1, "pallas-loop-nl")):
        jr, tr = vb_pair(exp_options(num, nq, "maxits", "auto"), 100)
        assert (jr, tr) == (want, want)
    data = np.ones((4, 100), np.float32)
    for num, want in ((20, "nlls-kernel"), (22, "nlls-generic")):
        o = RunOptions({"model": "exp", "num-exps": str(num), "dt": "0.02",
                        "method": "nlls", "dtype": "single"})
        assert NLLSInference(get_model_class("exp")(o), o, data,
                             device="cpu").route == want


def jax_stripped(num):
    """The JAX exp model at num-exps num without its time_signal (the
    JAX engine's generic mode)."""
    base = jmodel("exp")

    class JStrippedExp(base):
        name = "exp-stripped-test"

        @property
        def time_signal(self):
            raise AttributeError("stripped: generic evaluate only")

    return JStrippedExp(JOptions({"model": "exp", "dt": "0.05",
                                  "num-exps": str(num)}))


@pytest.mark.parametrize("nt", [30, 100, 500])
def test_generic_mode_route_matches_jax_gate(nt):
    """An evaluate-only exp sum (the generic full-time mode): kernel 6
    where the JAX picker admits it with the model's time planes (P,
    pattern, detector and T decide), else the generic route."""
    seen = set()
    for num in (1, 2, 3, 5):
        for nq in (1, 8):
            for det in ("maxits", "trialmode"):
                o = {"model": "exp", "num-exps": str(num), "dt": "0.05",
                     "noise": "white", "dtype": "single",
                     "noise-pattern": PATTERNS[nq], "convergence": det,
                     "max-iterations": "10", "engine-kernel": "pallas-loop"}
                jr, tr = vb_pair(o, nt, jm=jax_stripped(num),
                                 tm=stripped_exp(num))
                assert tr == jr, (num, nq, det, jr, tr)
                seen.add(tr)
    if nt <= 100:
        assert seen == {"pallas-loop-nl", "xla-generic"}


def test_pickers_are_the_jax_engines():
    """The port's copies of the JAX pickers give the JAX package's
    answers, and kernel 6's bound at Q = 1, 2, 4, 8, 16, 35 is P = 39,
    32, 25, 19, 13, 8 under maxits at 1,024 voxels, T = 100; kernel 8's
    P = 42 (41 at T = 500)."""
    for p in range(1, 48):
        for tp in (8, 104, 504):
            assert fn.pick_nlls_block(1024, p, tp) == \
                jfn.pick_nlls_block(1024, p, tp)
            for nq in (1, 2, 4, 8, 16, 35):
                for fdet, best in ((False, False), (True, False),
                                   (True, True)):
                    assert nl.pick_nl_block(
                        1024, p, tp, nq, fdet, tracks_best=best) == \
                        jnl.pick_nl_block(1024, p, tp, nq, fdet,
                                          tracks_best=best)
                assert nl.pick_nl_block(1024, p, tp, nq, False, True, 9,
                                        2) == \
                    jnl.pick_nl_block(1024, p, tp, nq, False, True, 9, 2)

    def cap(q):
        return max(p for p in range(1, 60)
                   if nl.pick_nl_block(1024, p, 104, q) is not None)
    assert [cap(q) for q in (1, 2, 4, 8, 16, 35)] == [39, 32, 25, 19, 13, 8]
    assert max(p for p in range(1, 60)
               if fn.pick_nlls_block(1024, p, 104) is not None) == 42
    assert max(p for p in range(1, 60)
               if fn.pick_nlls_block(1024, p, 504) is not None) == 41


# -- (b) the generic mode's time planes ---------------------------------------

@pytest.mark.parametrize("nt", [10, 30, 100])
def test_time_planes_match_jax(nt):
    """models/kernelgen.py's count of a generic trace's time-carrying
    intermediates equals the JAX package's fn.time_planes on the models
    the generic tests share (a Gaussian bump, its suppdata form, exp sums
    of 1, 2, 3 and 5 components without time_signal)."""
    cases = [(GaussianAct(), jgen.GaussianActModel(), 4, 0),
             (SuppScaled(), jgen.SuppScaledModel(), 4, 2)] + [
        (stripped_exp(num), jax_stripped(num), 2 * num, 0)
        for num in (1, 2, 3, 5)]
    for tm, jm, p, ns in cases:
        t = derive_time_local_eval(tm, nt, p, ns)
        j = jderive(jm, nt, p, jnp.float32, ns)
        assert t is not None and j is not None
        assert t.time_planes == j.time_planes, (type(tm).__name__, nt)
    assert derive_time_local_eval(GaussianAct(), nt, 4).time_planes > 1


# -- (c) the plain versions against the JAX kernels at float64 -----------------

NT, NV, DT = 40, 48, 0.1
# model, options, model-space truth: P = 10 and biexp (Q = 6 below)
TRUTHS = {"exp5": ("exp", {"num-exps": "5"},
                   [1.5, 0.2, 1.0, 0.8, 0.75, 2.5, 0.5, 6.0, 0.4, 15.0]),
          "exp4": ("exp", {"num-exps": "4"},
                   [1.5, 0.2, 1.0, 0.8, 0.75, 2.5, 0.5, 6.0]),
          "biexp": ("biexp", {}, [1.5, 0.5, 1.5, 5.0])}
# the cooperative form's cases: exp num-exps 12 and 22 (P = 24, 44), the
# components of chip_smoke.py exp_components (amplitudes 1/num, rates
# evenly spaced in log from 0.2 to 25)
for _num in (12, 22):
    TRUTHS[f"exp{_num}"] = ("exp", {"num-exps": str(_num)}, [
        x for i in range(_num)
        for x in (1.0 / _num, 0.2 * 125.0 ** (i / (_num - 1)))])


def case(name, pattern, seed):
    """Inputs from a numpy seed at float64: the twins, data [T,V] (the
    signal at perturbed truths, noise sd 0.02, one masked sample), the
    centre near the truth's latent, unit prior precision about 0 (the
    prior bounds the precision's condition, so float64 rounding stays
    small beside the tolerance)."""
    model, extra, truth = TRUTHS[name]
    o = {"model": model, "dt": str(DT), "noise": "white",
         "noise-pattern": pattern, **extra}
    jm = jmodel(model)(JOptions(o))
    tm = get_model_class(model)(RunOptions(o))
    params = resolve_parameters(tm, RunOptions(o))
    rng = np.random.default_rng(seed)
    p = len(truth)
    mt = np.asarray(truth)[None] * rng.uniform(0.8, 1.2, (NV, p))
    t = fv.time_index(NT, torch.float64, "cpu")
    sig = tm.time_signal([torch.as_tensor(mt[:, i][None])
                          for i in range(p)], t).expand(NT, NV).numpy()
    latent = np.stack([np.asarray(pr.transform.to_latent(
        torch.as_tensor(mt[:, i]))) for i, pr in enumerate(params)])
    group = [PATTERNS[35].index(ch) for ch in pattern]
    nq = max(group) + 1
    q = np.zeros((nq, NT))
    for i in range(NT):
        q[group[i % len(pattern)], i] = 1.0
    q[:, 5] = 0.0
    return dict(jm=jm, tm=tm, p=p, nq=nq, q=q,
                jtr=[x.transform for x in jresolve(jm, JOptions(o))],
                tr=[x.transform for x in params],
                data=sig + 0.02 * rng.standard_normal((NT, NV)),
                centre=latent + 0.05 * rng.standard_normal((p, NV)),
                pm=np.zeros((p, NV)), pp=np.ones((p, NV)),
                phi=rng.uniform(1000.0, 3000.0, (nq, NV)))


def padded(c):
    """The JAX kernels' inputs: the time axis edge-padded to TB."""
    tp = jfv.pad_time(NT)
    return jnp.pad(jnp.asarray(c["data"]), ((0, tp - NT), (0, 0)),
                   mode="edge")


def rel_err(got, ref):
    got = np.asarray(got, np.float64).reshape(np.shape(ref))
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def nlls_outputs_match(got, ref):
    """Kernel 8's (params, cost, its, prec, cov) at float64: the step
    counts equal, the rest within 1e-9 of each one's max but the
    covariance, held lane by lane in units of the error a float64 inverse
    makes at the precision's condition: each element within 64 x scaled
    cond x 2^-52 of float64's in the lane's scale sqrt(cov_ii cov_jj), on
    the lanes of scaled condition <= 1e12, at least a tenth of them (an
    NLLS precision has no prior: a sum of five exponentials leaves every
    lane's scaled condition at 7e7 or more, most past 1e15, where the
    precision is singular in float64 and the covariance noise on both
    sides; the precision holds those lanes)."""
    got = [np.asarray(g, np.float64) for g in got]
    ref = [np.asarray(r, np.float64) for r in ref]
    p = ref[0].shape[0]
    for k, (g, r) in enumerate(zip(got, ref)):
        g = g.reshape(r.shape)
        if k == 2:
            np.testing.assert_array_equal(g, r)
        elif k != 4:
            assert rel_err(g, r) <= 1e-9, k
    prec = ref[3].reshape(p, p, -1)
    cov, rcov = got[4].reshape(p, p, -1), ref[4].reshape(p, p, -1)
    held = 0
    for v in range(prec.shape[-1]):
        d = 1 / np.sqrt(np.abs(np.diag(prec[:, :, v])))
        cond = np.linalg.cond(prec[:, :, v] * d[:, None] * d[None, :])
        if not cond <= 1e12:
            continue
        held += 1
        sd = np.sqrt(np.abs(np.diag(rcov[:, :, v])))
        err = np.abs(cov[:, :, v] - rcov[:, :, v]) / np.outer(sd, sd)
        assert err.max() <= 64 * cond * 2.0 ** -52, (v, err.max(), cond)
    assert held >= prec.shape[-1] // 10


@pytest.mark.parametrize("name,pattern", [("exp5", "1"),
                                          ("biexp", "123456")],
                         ids=["P10", "Q6"])
def test_plain_kernels_6_7_match_jax_f64(name, pattern):
    """Kernel 6's plain version over 3 iterations and kernel 7's over one
    against the JAX kernels interpreted at float64: every output within
    1e-9 of its max."""
    c = case(name, pattern, seed=7)
    p, nq, q = c["p"], c["nq"], c["q"]
    jconsts = jnl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                                 q.sum(axis=1), 1e-8, 50.0, jnp.float64, nq)
    run = jnl.make_fused_nl_loop(
        c["jm"].time_signal, c["jtr"], p, NT, 3, NV, jnp.float64, True, q,
        block=NV, interpret=True, time_signal_jac=c["jm"].time_signal_jac)
    nl_ref = run(*(jnp.asarray(c[k]) for k in ("centre", "pm", "pp")),
                 padded(c), jconsts)
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                               q.sum(axis=1), 1e-8, 50.0, nq)
    x = {k: torch.from_numpy(c[k]) for k in ("centre", "pm", "pp", "data",
                                             "phi")}
    nl_got = nl.fused_nl_loop(c["tm"], c["tr"], x["centre"], x["pm"],
                              x["pp"], x["data"], q, consts, 3, True)
    run = jfv.make_fused_iteration(
        c["jm"].time_signal, c["jtr"], p, NT, NV, jnp.float64, True, q,
        block=NV, interpret=True, time_signal_jac=c["jm"].time_signal_jac)
    it_ref = run(*(jnp.asarray(c[k]) for k in ("centre", "pm", "pp", "phi")),
                 padded(c))
    it_got = fv.fused_iteration(c["tm"], c["tr"], x["centre"], x["pm"],
                                x["pp"], x["phi"], x["data"], q, True)
    for got, ref in ((nl_got, nl_ref), (it_got, it_ref)):
        for k, (g, r) in enumerate(zip(got, ref)):
            assert rel_err(g.numpy(), np.asarray(r)[..., :NV]) <= 1e-9, k


def jax_iteration_f64(c):
    """One plain VB iteration (kernel 7's function: fused_vb.py:184
    make_fused_iteration) composed at float64 from the JAX package's own
    pieces on case c: its model's time_signal_jac, its transforms'
    to_model and their jvp (make_block_eval's chain factors), the
    per-group sums, the solve and the k'Qk and trace terms in jnp."""
    import jax
    p = c["p"]
    t = jnp.arange(NT, dtype=jnp.float64)[:, None]
    q = jnp.asarray(c["q"])
    data = jnp.asarray(c["data"])

    def jac(lat):
        rows = [lat[i:i + 1] for i in range(p)]
        mrows = [tr.to_model(rows[i]) for i, tr in enumerate(c["jtr"])]
        chain = [jax.jvp(tr.to_model, (rows[i],),
                         (jnp.ones_like(rows[i]),))[1]
                 for i, tr in enumerate(c["jtr"])]
        sig, jm = c["jm"].time_signal_jac(mrows, t)
        return sig, jnp.stack([jm[i] * chain[i] for i in range(p)])

    def sums(j):
        return jnp.einsum("qt,itv,jtv->qijv", q, j, j)

    centre, pm, pp, phi = (jnp.asarray(c[k]) for k in ("centre", "pm",
                                                         "pp", "phi"))
    sig, j = jac(centre)
    r = data - sig
    jtj = sums(j)
    jtr = jnp.einsum("qt,itv,tv->qiv", q, j, r)
    prec = jnp.einsum("qv,qijv->ijv", phi, jtj) + \
        jnp.eye(p)[:, :, None] * pp[None]
    cov = jnp.linalg.inv(prec.transpose(2, 0, 1)).transpose(1, 2, 0)
    rhs = jnp.einsum("qv,qiv->iv", phi, jtr + jnp.einsum(
        "qijv,jv->qiv", jtj, centre)) + pp * pm
    means = jnp.einsum("ijv,jv->iv", cov, rhs)
    k = r + jnp.einsum("itv,iv->tv", j, centre - means)
    nkqk = jnp.einsum("qt,tv->qv", q, k * k)
    ntr = jnp.einsum("ijv,qijv->qv", cov, jtj)
    fsig, fj = jac(means)
    fkqk = jnp.einsum("qt,tv->qv", q, (data - fsig) ** 2)
    ftr = jnp.einsum("ijv,qijv->qv", cov, sums(fj))
    return [np.asarray(x) for x in (means, prec, cov, nkqk, ntr, fkqk,
                                    ftr)]


def test_cpu_route_p44_matches_jax_f64():
    """exp num-exps 22 (P = 44) on the port's CPU route: 'pallas', past
    kernel 6's picker as in the JAX engine's gate (test_vb_route_matches_
    jax_gate), kernel 7's plain version once per iteration (the card runs
    its cooperative form). On a CPU the JAX kernel does not finish at P =
    44 within the tests' time: one interpreted make_fused_iteration call
    (as the P = 10 case calls it) at 4 voxels and T = 40 had not returned
    after 25 minutes, and the JAX engine's pallas and xla routes each ran
    past 8 minutes on 8 voxels. So, as the fallback, the route's
    iteration is held at float64 against the same iteration composed
    from the JAX package's own model and transforms (jax_iteration_f64):
    every output within 1e-9 of its max. The port's engine then runs the
    route at float32 for 2 iterations with finite results."""
    c = case("exp22", "1", seed=21)
    x = {k: torch.from_numpy(c[k]) for k in ("centre", "pm", "pp", "phi",
                                             "data")}
    got = fv.fused_iteration(c["tm"], c["tr"], x["centre"], x["pm"],
                             x["pp"], x["phi"], x["data"], c["q"], True)
    for i, (g, r) in enumerate(zip(got, jax_iteration_f64(c))):
        assert rel_err(g.numpy(), r) <= 1e-9, i
    o = RunOptions({"model": "exp", "num-exps": "22", "dt": str(DT),
                    "noise": "white", "max-iterations": "2",
                    "dtype": "single"})
    eng = VBInference(c["tm"], o, c["data"].T.astype(np.float32),
                      device="cpu")
    assert eng.route == "pallas"
    res = eng.run()
    assert np.isfinite(res.means).all() and not res.bad_voxels.any()


def test_plain_kernel_8_matches_jax_f64_p10():
    """Kernel 8's plain version (fresh Levenberg, 30 steps) at P = 10
    against the JAX kernel interpreted at float64 (nlls_outputs_match)."""
    c = case("exp5", "1", seed=8)
    tmask = np.ones(NT)
    tmask[5] = 0.0
    run = jfn.make_fused_nlls_loop(
        c["jm"].time_signal, c["jtr"], c["p"], NT, 30, NV, jnp.float64,
        tmask, block=NV, interpret=True,
        time_signal_jac=c["jm"].time_signal_jac)
    ref = [np.asarray(r) for r in run(jnp.asarray(c["centre"]), padded(c))]
    got = fn.fused_nlls_loop(c["tm"], c["tr"], torch.from_numpy(c["centre"]),
                             torch.from_numpy(c["data"]), tmask, 30)
    nlls_outputs_match([g.numpy() for g in got], ref)


# -- (d) the per-shape bodies as host C++ at double ---------------------------

@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """Host builds of the kernels, made once per (kernel, functor, Q)."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    built = {}

    def get(kind, functor, q=None):
        if (kind, functor, q) not in built:
            d = tmp_path_factory.mktemp("host")
            built[kind, functor, q] = {
                "loop": lambda: torch_hostcc.kernel_fn(functor, q, d),
                "iter": lambda: torch_hostcc.vb_iter_kernel_fn(functor, q,
                                                               d),
                "nlls": lambda: torch_hostcc.nlls_kernel_fn(functor, d)}[
                    kind]()
        return built[kind, functor, q]
    return get


HOST_CASES = [("exp5", "1", "ExpSum<5>"), ("biexp", "123456", "ExpSum<2>")]


@pytest.mark.parametrize("name,pattern,functor", HOST_CASES,
                         ids=["P10", "Q6"])
def test_whole_loop_kernel_on_host(name, pattern, functor, host):
    """Kernel 6 at (10, 1) (its loops rolled on the card) and (4, 6)
    (unrolled): maxits over 5 iterations and trialmode (3 iterations, 2
    trials) at double, within 1e-9 of the plain version at float64."""
    c = case(name, pattern, seed=11)
    nq, q = c["nq"], c["q"]
    tcodes = [fv.TRANSFORM_CODES[tr.code] for tr in c["tr"]]
    consts = nl.pack_nl_consts(np.full(nq, 1e6), np.full(nq, 1e-6),
                               q.sum(axis=1), 1e-8, 50.0, nq)
    k = host("loop", functor, nq)
    x = [torch.from_numpy(c[n]) for n in ("centre", "pm", "pp")]
    got = k(tcodes, 5, True, consts.numpy(), (0, 0.0, 0, 0, 0),
            [0.0] * (nq + 2), c["centre"], c["pm"], c["pp"], None,
            c["data"], None, q.T, dt=DT)
    ref = nl.fused_nl_loop_plain(fv.signal_jac_fn(c["tm"]), c["tr"], *x,
                                 torch.from_numpy(c["data"]), q, consts, 5,
                                 True)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert rel_err(g, r.numpy()) <= 1e-9, i
    o = RunOptions({"model": c["tm"].name, "dt": str(DT), "noise": "white",
                    "noise-pattern": pattern, "convergence": "trialmode",
                    "max-iterations": "3", "max-trials": "2",
                    **TRUTHS[name][1]})
    eng = VBInference(c["tm"], o, np.ones((NV, NT)), device="cpu")
    det = eng._nl_fdet_consts()
    from fabber_core_tpu_torch.ops.fused_loop_nl import DETECTOR_KINDS
    assert "trialmode" in DETECTOR_KINDS
    kind = _cuda.detector_args(det["det"])
    dconsts = list(det["lb_coeff"]) + [det["f_const"], det["f_const_init"]]
    got = k(tcodes, 3, True, consts.numpy(), kind, dconsts, c["centre"],
            c["pm"], c["pp"], None, c["data"], None, q.T, dt=DT)
    ref = nl.fused_nl_loop_plain(fv.signal_jac_fn(c["tm"]), c["tr"], *x,
                                 torch.from_numpy(c["data"]), q, consts, 3,
                                 True, detector=det)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert rel_err(g, r.numpy()) <= 1e-9, i


@pytest.mark.parametrize("name,pattern,functor", HOST_CASES + [
    ("exp4", PATTERNS[35], "ExpSum<4>"), ("exp12", "1234", "ExpSum<12>"),
    ("exp22", "1", "ExpSum<22>")],
    ids=["P10", "Q6", "Q35-coop-folded", "P24-Q4-coop-folded", "P44-coop"])
@pytest.mark.parametrize("lm", [False, True], ids=["plain", "lm"])
def test_iteration_kernel_wide_form_on_host(name, pattern, functor, lm,
                                            host):
    """Kernel 7's per-shape instances at double, with and without the LM
    branch: at (10, 1) and (4, 6) the prebuilt form's template (staged
    and streamed, bit for bit), past ops/_cuda.py rolled_loops' sizes the
    cooperative form (fused_vb_iter_coop_kernel, a block's 32 threads as
    host threads): folded at (8, 35) and (24, 4) (past kCoopFoldSums
    per-group sums: the groups folded into one weighted sum for the
    solve, a pass per group for each trace), per group at (44, 1). Within
    1e-9 of the plain version at float64, which sums per group."""
    c = case(name, pattern, seed=12)
    alpha = None
    if lm:
        alpha = 10.0 ** np.random.default_rng(13).uniform(-6, 2, NV)
        alpha[::4] = 0.0
    tcodes = [fv.TRANSFORM_CODES[tr.code] for tr in c["tr"]]
    k = host("iter", functor, c["nq"])
    args = (tcodes, DT, True, c["centre"], c["pm"], c["pp"], c["phi"],
            c["data"], c["q"].T, alpha)
    staged, streamed = k(True, *args), k(False, *args)
    for a, b in zip(staged, streamed):
        assert np.array_equal(a, b)
    ref = fv.fused_iteration_plain(
        fv.signal_jac_fn(c["tm"]), c["tr"],
        *(torch.from_numpy(c[n]) for n in ("centre", "pm", "pp", "phi",
                                           "data")),
        c["q"], True, None if alpha is None else torch.from_numpy(alpha))
    for i, (g, r) in enumerate(zip(staged, ref)):
        assert rel_err(g, r.numpy()) <= 1e-9, i


def test_nlls_kernel_on_host_p10(host):
    """Kernel 8 at P = 10 at double: fresh Levenberg (30 steps) against
    the plain version at float64 (nlls_outputs_match), and phase 1 (3
    steps) + resume equal to the fresh launch."""
    c = case("exp5", "1", seed=14)
    tmask = np.ones(NT)
    tmask[5] = 0.0
    consts = [fn.LAMBDA_INIT, fn.LAMBDA_GROW, fn.LAMBDA_SHRINK,
              fn.LAMBDA_MAX, fn.PREC_DIAG_FLOOR, fn.CFTOL, fn.PLATEAU_LAMBDA]
    dof = float(tmask.sum() - c["p"])
    tcodes = [fv.TRANSFORM_CODES[tr.code] for tr in c["tr"]]
    k = host("nlls", "ExpSum<5>")
    fresh = k(0, False, tcodes, DT, consts, 30, dof, c["centre"], c["data"],
              tmask, None)
    p1 = k(1, False, tcodes, DT, consts, 3, dof, c["centre"], c["data"],
           tmask, None)
    res = k(2, False, tcodes, DT, consts, 27, dof, p1[0], c["data"], tmask,
            p1[5])
    for a, b in zip(fresh[:5], res[:5]):
        assert np.array_equal(a, b)
    ref = fn.fused_nlls_loop_plain(
        fv.signal_jac_fn(c["tm"]), c["tr"], torch.from_numpy(c["centre"]),
        torch.from_numpy(c["data"]), tmask, 30)
    nlls_outputs_match(fresh[:5], [r.numpy() for r in ref])


# -- (e) limits, units and the card's gate -------------------------------------

def test_nl_limits_and_units():
    """The nonlinear family's limits come from csrc/vb_device.cuh
    (kWideMaxP 42, kWideMaxQ 35); an exp sum needs even P; its units
    define the shape and the functor kind, and FABBER_ROLL_LOOPS past
    ROLL_P (16) or ROLL_SUMS (600) per-group sums."""
    assert _cuda.instance_limits("nl") == (42, 35)
    assert _cuda.instance_limits("nl", "vb_iter") == (143, 35)
    assert _cuda.gen_limits() == (42, 35)
    for kernel in _cuda.NL_ENTRIES:
        assert _cuda.instance_buildable("nl", 10, 1, 1, kernel)
        assert _cuda.instance_buildable("nl", 42, 35, 1, kernel)
        assert _cuda.instance_buildable("nl", 5, 3, 0, kernel)
        assert not _cuda.instance_buildable("nl", 5, 1, 1, kernel)
        assert not _cuda.instance_buildable("nl", 4, 36, 1, kernel)
        assert not _cuda.instance_buildable("nl", 4, 1, None, kernel)
        assert _cuda.instance_buildable("nl", 44, 1, 1, kernel) == (
            kernel == "vb_iter")
    assert _cuda.instance_buildable("nl", 142, 35, 1, "vb_iter")
    assert not _cuda.instance_buildable("nl", 144, 1, 1, "vb_iter")
    assert [_cuda.rolled_loops(p, q) for p, q in (
        (10, 1), (16, 1), (17, 1), (8, 35), (4, 35), (24, 4))] == \
        [False, False, True, True, False, True]
    # one unit a build: the kernel asked for, kernel 8 at Q = 1
    for kernel, (entry, *_) in _cuda.NL_ENTRIES.items():
        units = _cuda.instance_sources("nl", 24, 4, 1, kernel)
        assert set(units) == {entry}
        q = 1 if kernel == "nlls" else 4
        for line in ("#define FABBER_INST_P 24", f"#define FABBER_INST_Q {q}",
                     "#define FABBER_INST_KIND 1",
                     "#define FABBER_ROLL_LOOPS", f'#include "{entry}.cu"'):
            assert line in units[entry]
    assert "FABBER_ROLL_LOOPS" not in _cuda.instance_sources(
        "nl", 10, 1, 1, "nl_loop")["fused_nl_loop"]
    with pytest.raises(ValueError, match="a nonlinear kernel"):
        _cuda.instance_sources("nl", 10, 1, 1)
    key = _cuda.instance_key
    assert key("nl", 10, 1, 1, "nl_loop") != key("nl", 10, 1, 0, "nl_loop")
    assert key("nl", 10, 1, 1, "nl_loop") != key("nl", 10, 1, 1, "vb_iter")
    assert key("nl", 10, 2, 1, "vb_iter") != key("nl", 10, 1, 1, "vb_iter")
    assert key("nl", 10, 2, 1, "nlls") == key("nl", 10, 1, 1, "nlls")
    assert "FABBER_ROLL_LOOPS" in _cuda.generated_source("", 20, 1)
    assert "FABBER_ROLL_LOOPS" not in _cuda.generated_source("", 12, 1)
    # every unit builds optimized (test_torch_rolled_units.py): a
    # generated functor with its kernel's source flags alone
    for kernel, (_, _, _, src) in _cuda.GEN_KERNELS.items():
        assert _cuda._gen_flags(kernel) == _cuda.NVCC_FLAGS + \
            _cuda.SOURCE_FLAGS.get(src, [])


def on_card(eng):
    eng.device = torch.device("cuda")
    eng._require_kernel_instance()
    return eng


@pytest.mark.parametrize("num,nq,route,raises", [
    (5, 1, "pallas-loop-nl", False), (2, 35, "pallas-loop-nl", False),
    (19, 1, "pallas-loop-nl", False), (13, 8, "pallas", False),
    (21, 1, "pallas", False), (21, 35, "pallas", False),
    (22, 1, "pallas", False), (71, 35, "pallas", False),
    (72, 1, "pallas", True)])
def test_card_gate_raises_past_kernel_7s_cap_alone(num, nq, route, raises,
                                                   monkeypatch):
    """With the device stood in for "cuda" and the prebuilt list as the
    library has it: every shape the gates give kernels 6 and 7 up to
    their bounds is served by a per-shape instance (built at the route's
    first launch: nothing is built at construction), kernel 7 past P = 16
    in its cooperative form up to csrc/vb_device.cuh kCoopMaxP (143: exp
    num-exps 71, P = 142, runs at Q = 35); exp num-exps 72 (P = 144) on
    kernel 7 raises, naming the shared-memory bound."""
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(_cuda, "has_nl_instance",
                        lambda kind, p, q: kind == 1 and p <= 8 and q <= 2)
    built = []
    monkeypatch.setattr(_cuda, "build_instance", lambda *a: built.append(a))
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda *a: built.append(a))
    o = RunOptions(exp_options(num, nq, "maxits", "auto"))
    eng = VBInference(get_model_class("exp")(o), o,
                      np.ones((4, 100), np.float32), device="cpu")
    assert eng.route == route
    if raises:
        with pytest.raises(NotImplementedError,
                           match=r"\(P=144, Q=1\) instance of kernel 7.*"
                                 r"shared memory.*bounds P at 143.*"
                                 r"kCoopMaxP"):
            on_card(eng)
    else:
        assert on_card(eng).functor is None
    assert built == []


def test_poly_past_its_list_takes_a_per_shape_instance(monkeypatch):
    """poly degree 5 with a log transform under engine-kernel=pallas (P =
    6, no PolyModel<6> in the prebuilt list): a per-shape instance of
    kind 0 serves kernel 7, no functor is generated; kernel 8 at P = 6
    too."""
    monkeypatch.setattr(_cuda, "has_nl_instance",
                        lambda kind, p, q: kind == 0 and p <= 4 and q <= 2)
    monkeypatch.setattr(_cuda, "has_nlls_instance",
                        lambda kind, p: kind == 0 and p <= 4)
    built = []
    monkeypatch.setattr(_cuda, "build_generated",
                        lambda *a: built.append(a))
    extra = {"model": "poly", "degree": "5", "PSP_byname1": "c0",
             "PSP_byname1_transform": "L", "dtype": "single",
             "noise": "white"}
    o = RunOptions({**extra, "engine-kernel": "pallas"})
    eng = VBInference(get_model_class("poly")(o), o,
                      np.ones((4, 30), np.float32), device="cpu")
    assert eng.route == "pallas"
    assert fv.nl_instantiated(eng.model.kernel_model(), 1, "vb_iter")
    assert on_card(eng).functor is None
    o = RunOptions({**extra, "method": "nlls"})
    neng = NLLSInference(get_model_class("poly")(o), o,
                         np.ones((4, 30), np.float32), device="cpu")
    assert neng.route == "nlls-kernel"
    neng.device = torch.device("cuda")
    neng._require_kernel_instance()
    assert neng.functor is None and built == []
