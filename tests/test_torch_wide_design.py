"""Fixed designs past P = 8: the per-shape instances of kernels 1-5 and 9
(ops/_cuda.py build_instance) and the route gate that sends the card to
them wherever the JAX engine on a TPU runs its kernels.

  gate parity   the port's route against the JAX engine's (its TPU
                decision, jax.default_backend patched to "tpu") over P
                1-26, T 10-500, Q 1-4 (noise patterns), maxits and
                trialmode, white and AR(1) noise, split and fused: equal,
                or a kernel route of the port's where the JAX engine's
                VMEM picker refuses that kernel at this T only (the card's
                gate is its shared memory, up to the largest P the picker
                admits at any T); the port's copies of the JAX pickers
                against the JAX package's own; the JAX split form's
                failure at P 21-25 (its gate admits, its core picker does
                not), a property of the reference;
  plain f64     the port's plain versions at P = 12 and 20 against the
                JAX package at float64 within 1e-9 (the statistics against
                make_design_stats, the core against the XLA eigenbasis
                loops, kernel 4's plain version at pattern 12 and kernel
                9's at 1 and 2 echoes against the JAX kernels
                interpreted), on cosine designs;
  on the host   the per-shape kernels compiled as host C++ at double
                (tests/torch_hostcc.py): kernels 1-3 at P = 12 and 20
                (staged equal to streamed bit for bit, within 1e-12 of the
                plain versions), kernel 4 in MODEs 0 and 2 and kernel 5 at
                P = 12 and 16 (within 1e-9; lm 1e-8), kernel 9 at P = 12
                (1e-11; F 1e-12);
  build         build_instance's units, key, limits and its failure
                (nvcc's stderr in the error), without nvcc.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fabber_core_tpu.inference.vb as jvb_module
from fabber_core_tpu.inference.vb import VBInference as JVB
from fabber_core_tpu.models import get_model_class as jmodel
from fabber_core_tpu.noise.white import WhiteNoiseModel as JWhite
from fabber_core_tpu.ops import fused_loop as jfl
from fabber_core_tpu.ops import fused_spectral as jfs
from fabber_core_tpu.ops import fused_vb as jfv
from fabber_core_tpu.ops import fused_whole as jfw
from fabber_core_tpu.ops import spectral as jspec
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch import FabberError
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.noise.white import WhiteNoiseModel as TWhite
from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.ops import fused_loop as tfl
from fabber_core_tpu_torch.ops import fused_spectral as tfs
from fabber_core_tpu_torch.ops import fused_whole as tfw
from fabber_core_tpu_torch.options import RunOptions as TOptions

import torch_hostcc
from test_torch_ar_kernels import ar_host  # noqa: F401  (a fixture)
from test_torch_ar_kernels import check_host_f64
from test_torch_ar_kernels import \
    test_plain_matches_pallas_kernel_f64 as ar_plain_vs_pallas_f64
from test_torch_spectral_kernels import det_pair
from test_torch_stats_engine import jax_route
from test_torch_whole_kernels import (check_kernel_on_host, make_case,
                                      noise_consts, port_whole, rel)

torch.set_num_threads(1)


# -- (a) the route gate against the JAX engine's ----------------------------

GRID_T = (10, 50, 106, 200, 500)
GRID_P = tuple(range(1, 27))
# (options, Q): white noise at Q 1-4 (noise patterns), AR(1) at 1-2 echoes
NOISES = [({"noise-pattern": pat}, len(pat)) for pat in ("1", "12", "123",
                                                           "1234")] \
    + [({"noise": "ar", "num-echoes": str(n)}, n) for n in (1, 2)]
SPECTRAL = ("spectral-whole", "spectral-fused", "spectral-xstats")


def port_wider(route, p, nq, nt, det):
    """True where the port's kernel route is one the JAX engine's VMEM
    picker refuses at this T only: the port keeps its kernel there (its
    gate is the card's shared memory)."""
    if route in SPECTRAL:
        return (jfs.pick_spectral_block(
            1024, p, nt, det=det in ("pointzeroone", "freduce",
                                     "trialmode")) is None
                and p <= tfs.MAX_P)
    if route == "pallas-whole":
        wdet = det in ("pointzeroone", "trialmode", "lm")
        return (jfw.pick_whole_block(1024, p, nq, jfv.pad_time(nt),
                                     det=wdet) is None
                and p <= tfw.whole_cap(nq, wdet))
    return False


@pytest.mark.parametrize("nt", GRID_T)
def test_route_gate_matches_jax_engine(nt, monkeypatch):
    """Every (P, Q, detector, noise, spectral-impl) at this T: the port's
    route is the JAX engine's on a TPU, or a kernel route the JAX picker
    refuses at this T alone (port_wider). Where the JAX engine runs kernel
    1-5 or 9, so does the port, past P = 8 too; past the caps both take
    the same non-kernel route."""
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    rng = np.random.default_rng(nt)
    data = rng.standard_normal((8, nt)).astype(np.float32)
    coords = np.stack([np.arange(8), np.zeros(8), np.zeros(8)], 1)
    seen = set()
    wider = 0
    for p in GRID_P:
        for noise, nq in NOISES:
            for det in ("maxits", "trialmode"):
                for impl in ("split", "fused"):
                    o = {"model": "poly", "degree": str(p - 1),
                         "noise": "white", "max-iterations": "10",
                         "dtype": "single", "convergence": det,
                         "spectral-impl": impl, **noise}
                    jo = JOptions(dict(o))
                    jr = jax_route(JVB(jmodel("poly")(jo), jo, data, coords))
                    to = TOptions(dict(o))
                    tr = VBInference(get_model_class("poly")(to), to, data,
                                     device="cpu").route
                    ok = tr == jr or port_wider(tr, p, nq, nt, det)
                    assert ok, (p, noise, det, impl, jr, tr)
                    wider += tr != jr
                    seen.add(tr)
    # the grid reaches the kernel routes and the ones past the caps
    assert {"spectral-whole", "spectral-fused", "pallas-whole",
            "pallas-loop-ar", "xla"} <= seen
    # the port keeps its kernels where the JAX pickers stop short of
    # their caps at this T (at T = 10 the whole kernel at P = 20, Q 1-3)
    assert wider > 0


def test_pickers_are_the_jax_engines():
    """The port's copies of the JAX pickers (its route gate's caps) give
    the JAX package's answers, and the caps are 25 (spectral), 20 / 19
    at Q = 4 / 17 (whole, maxits / detector), 17 / 16 (kernel 5), 16 / 15
    (kernel 9, maxits), 14 / 13 (its detectors)."""
    for p in range(1, 30):
        for nt in (1, 10, 50, 106, 200, 500):
            for det in (False, True):
                assert tfs.pick_spectral_block(1024, p, nt, det) == \
                    jfs.pick_spectral_block(1024, p, nt, det)
                for nq in (1, 2, 3, 4):
                    assert tfw.pick_whole_block(
                        1024, p, nq, tfw.pad_time(nt), det) == \
                        jfw.pick_whole_block(1024, p, nq, jfv.pad_time(nt),
                                             det)
        for det in (False, True):
            assert tfs.pick_core_block(1000, p, det) == \
                jfs.pick_core_block(1000, p, det)
        for nq in (1, 2, 3, 4):
            assert tfl.n_white_loop_planes(p, nq) == \
                jfl.n_white_loop_planes(p, nq)
        for nq in (1, 2):
            for fdet in (False, True):
                assert tfl.n_ar_loop_planes(p, fdet, nq) == \
                    jfl.n_ar_loop_planes(p, fdet, nq)
    assert tfs.jax_spectral_cap() == tfs.jax_spectral_cap(True) == \
        tfs.MAX_P == 25
    assert [tfw.whole_cap(q) for q in (1, 2, 3, 4)] == [20, 20, 20, 19]
    assert [tfw.whole_cap(q, True) for q in (1, 2, 3, 4)] == [17] * 4

    def loop_cap(planes):
        return max(p for p in range(1, 40)
                   if tfl.pick_block(1024, planes(p)) is not None)
    assert [loop_cap(lambda p, q=q: tfl.n_white_loop_planes(p, q))
            for q in (1, 2, 3, 4)] == [17, 16, 16, 16]
    assert [loop_cap(lambda p, q=q, f=f: tfl.n_ar_loop_planes(p, f, q))
            for f in (False, True) for q in (1, 2)] == [16, 15, 14, 13]


@pytest.mark.parametrize("p", [21, 25])
def test_jax_split_form_fails_where_its_gate_admits(p, monkeypatch):
    """A property of the reference, not ported: at P 21-25 and short T
    the JAX spectral gate admits the split form, but its core kernel's
    picker finds no tile, so the JAX engine fails at its run. The port's
    gate gives the same route, and its kernels serve it (on the CPU its
    plain route runs)."""
    assert jfs.pick_spectral_block(1024, p, 10) is not None
    assert jfs.pick_core_block(1024, p) is None
    monkeypatch.setattr(jvb_module.jax, "default_backend", lambda: "tpu")
    rng = np.random.default_rng(p)
    nt = 10
    data = rng.standard_normal((16, nt)).astype(np.float32)
    coords = np.stack([np.arange(16), np.zeros(16), np.zeros(16)], 1)
    o = {"model": "poly", "degree": str(p - 1), "noise": "white",
         "max-iterations": "5", "dtype": "single"}
    jo = JOptions(dict(o))
    assert jax_route(JVB(jmodel("poly")(jo), jo, data, coords)) == \
        "spectral-whole"
    to = TOptions(dict(o))
    eng = VBInference(get_model_class("poly")(to), to, data, device="cpu")
    assert eng.route == "spectral-whole"
    res = eng.run()
    assert res.means.shape == (16, p)


# -- (b) the plain versions at float64 against the JAX package -------------

def cosine_design(p, nt):
    t = (np.arange(nt) + 0.5) / nt
    return np.cos(np.pi * t[:, None] * np.arange(p)[None])


def spectral_case(p, nt=106, nv=96, seed=0):
    """A cosine design with two masked timepoints, float64 data."""
    rng = np.random.default_rng(seed + p)
    d = cosine_design(p, nt)
    q = np.ones(nt)
    q[[2, nt // 2]] = 0.0
    data = d @ rng.uniform(-1, 1, (p, nv)) \
        + 10.0 ** rng.uniform(-2, 0, nv) * rng.standard_normal((nt, nv))
    return d, q, data


@pytest.mark.parametrize("p", [12, 20])
def test_spectral_stats_plain_f64_matches_design_stats(p):
    """Kernel 1's plain version at float64 equals the JAX engine's
    make_design_stats within 1e-9 (D'Qy = dtqr + A m0 against its
    scale)."""
    nt = 106
    d, q, data = spectral_case(p, nt)
    mt = {f"mt{i + 1}": str(t + 1)
          for i, t in enumerate(np.flatnonzero(q == 0))}
    jnoise = JWhite(JOptions(mt), nt, [int(v) for v in mt.values()])
    js = jnoise.make_design_stats(jnp.asarray(d), jnp.asarray(data))
    tc = tfs.pack_mxu_consts(d, q, nt, torch.float64)
    ac = tfs.pack_solve_consts(d, q, nt, torch.float64)
    m0, rtqr, dtqr = (x.numpy() for x in tfs.spectral_stats_plain(
        torch.from_numpy(data), tc, ac))
    jm0 = np.asarray(js.m0)
    assert rel(m0, jm0) <= 1e-9
    assert rel(rtqr, np.asarray(js.rtqr)) <= 1e-9
    a = d.T @ (q[:, None] * d)
    assert np.abs(dtqr - np.asarray(js.dtqr)[0]).max() <= \
        1e-9 * np.abs(a @ jm0).max()


def spectral_core_case(p, nv=96, seed=0):
    """float64 statistics (the plain kernel 1's), prior means, and the
    route's constants (tests/test_torch_spectral_kernels.py core_inputs,
    on a cosine design)."""
    nt = 106
    d, q, data = spectral_case(p, nt, nv, seed)
    tc = tfs.pack_mxu_consts(d, q, nt, torch.float64)
    ac = tfs.pack_solve_consts(d, q, nt, torch.float64)
    stats = [x.numpy() for x in tfs.spectral_stats_plain(
        torch.from_numpy(data), tc, ac)]
    pm = np.random.default_rng(seed).uniform(-1, 1, (p, nv))
    pp = np.full(p, 0.5)
    c_post = (q.sum() - 1) * 0.5 + 1e-6
    args = (d, q, nt, pp, 1e-6, c_post, 1e-8, 50.0)
    extra = (jspec.eigen_elbo_const(q, c_post, 1e-6, 1e6, p), c_post + 0.5)
    return data, stats, pm, args, extra


@pytest.mark.parametrize("p", [12, 20])
def test_spectral_core_plain_f64_matches_spectral_loop(p):
    """Kernel 2's plain version under maxits at float64 equals the JAX XLA
    eigenbasis loop (ops/spectral.py make_spectral_loop) within 1e-9."""
    _, stats, pm, args, extra = spectral_core_case(p)
    d, q, nt, pp, inv_b0, c_post, b_init, c_init = args
    jout = jspec.make_spectral_loop(d, q, pp, 10, b_init, c_init, inv_b0,
                                    c_post, jnp.float64)(
        *(jnp.asarray(x) for x in stats), jnp.asarray(pm))
    tsc = tfs.pack_spectral_consts(*args, torch.float64, extra)
    tout = tfs.spectral_core_plain(*(torch.from_numpy(x) for x in stats),
                                   torch.from_numpy(pm), tsc, 10)
    for j, t in zip(jout, tout[:5]):      # means, prec, cov, b, c
        assert rel(t.numpy(), np.asarray(j)) <= 1e-9


@pytest.mark.parametrize("p", [12, 20])
def test_spectral_core_plain_trialmode_f64_matches_detector_loop(p):
    """Kernel 2d's plain version under trialmode at float64 equals the JAX
    XLA eigenbasis detector loop (make_spectral_detector_loop): iteration
    counts and engine-initial flags equal, the posterior within 1e-9."""
    _, stats, pm, args, extra = spectral_core_case(p, seed=3)
    d, q, nt, pp, inv_b0, c_post, b_init, c_init = args
    td, jd, cap = det_pair("trialmode", {"max-trials": "3"})
    nv = pm.shape[1]
    loop = jspec.make_spectral_detector_loop(
        d, q, pp, jd, cap, b_init, c_init, inv_b0=inv_b0, c_post=c_post,
        b0=1.0 / inv_b0, c0=1e-6, dtype=jnp.float64)
    jmeans, jprec, jcov, jb, jsel, jconv = loop(
        *(jnp.asarray(x) for x in stats), jnp.asarray(pm),
        jd.init_state(nv, jnp.float64))
    tsc = tfs.pack_spectral_consts(*args, torch.float64, extra)
    tout = tfs.spectral_core_plain(*(torch.from_numpy(x) for x in stats),
                                   torch.from_numpy(pm), tsc, cap, td)
    np.testing.assert_array_equal(tout[6][0].numpy().astype(np.int32),
                                  np.asarray(jconv.its))
    sel = np.asarray(jsel)
    np.testing.assert_array_equal(tout[3][0].numpy() < 0, sel)
    keep = ~sel
    for j, t in zip((jmeans, jprec, jcov, jb),
                    list(tout[:3]) + [tout[3].abs()]):
        assert rel(t.numpy()[..., keep], np.asarray(j)[..., keep]) <= 1e-9


def test_whole_plain_pattern12_f64_matches_pallas_kernel():
    """Kernel 4's plain version at P = 12, Q = 2 (pattern 12), maxits, at
    float64 against the JAX whole-program kernel interpreted at float64:
    every output within 1e-9 of its max."""
    p, nq, nt = 12, 2, 29
    d, q, data, pm, pp = make_case(p, nq, nt, masked=True, seed=4)
    nv = 64
    data, pm, pp = data[:, :nv], pm[:, :nv], pp[:, :nv]
    b0, c0, ntg, ib, ic = noise_consts(q)
    call = jfw.make_fused_whole_loop(p, nq, 10, nt, nv, jnp.float64,
                                     block=nv, interpret=True)
    tp = jfw.pad_time(nt)
    tc = jfw.pack_time_consts(d, q, nt, tp, jnp.float64)
    sc = jfw.pack_scalar_consts(d, q, nt, b0, c0, ntg, ib, ic, jnp.float64)
    jout = [np.asarray(x) for x in call(
        call.fold_data(jnp.asarray(data, jnp.float64)), tc, sc,
        jnp.asarray(pm, jnp.float64), jnp.asarray(pp, jnp.float64))]
    tout = port_whole(p, nq, nt, d, q, data, pm, pp, 10,
                      dtype=torch.float64)
    for t, j in zip(tout, jout):
        assert rel(t.reshape(j.shape), j) <= 1e-9


@pytest.mark.parametrize("nq", [1, 2])
def test_ar_plain_f64_matches_pallas_kernel_p12(nq):
    """Kernel 9's plain version at P = 12 (a cosine design), 1 and 2
    echoes, maxits, at float64 against the JAX AR(1) kernel interpreted:
    tests/test_torch_ar_kernels.py's comparison (1e-9)."""
    ar_plain_vs_pallas_f64(nq, 12, None, 64)


# -- (c) the per-shape kernels compiled as host C++ --------------------------

@pytest.fixture(scope="module")
def spectral_wide(tmp_path_factory):
    """(name, P) -> kernel 1, 2 or 3's per-shape instance at double on
    the host (skipped without g++)."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    libs = {}
    makers = {"stats": torch_hostcc.stats_kernel_fn,
              "core": torch_hostcc.core_kernel_fn,
              "fused": torch_hostcc.fused_kernel_fn}

    def get(name, p):
        if (name, p) not in libs:
            libs[name, p] = makers[name](
                p, tmp_path_factory.mktemp(f"{name}{p}"))
        return libs[name, p]
    return get


def rel_all(got, ref):
    return max(rel(np.asarray(g).reshape(np.shape(r)), r)
               for g, r in zip(got, ref))


@pytest.mark.parametrize("p", [12, 20])
def test_spectral_kernels_on_host_match_plain(p, spectral_wide):
    """Kernels 1, 2 and 3 past P = 8 (the block's factor of A and the
    constants in shared memory) at double: kernel 1 staged (blocks of 32
    lanes as threads, a ragged last block) equal to streamed bit for bit,
    both within 1e-12 of the plain statistics; kernel 2 in maxits and
    trialmode within 1e-12 of the plain core, iteration counts equal;
    kernel 3 in both forms equal to kernel 1 then kernel 2 within
    1e-12."""
    nt, nv = 106, 70
    d, q, data = spectral_case(p, nt, nv, seed=7)
    tc = tfs.pack_mxu_consts(d, q, nt, torch.float64)
    ac = tfs.pack_solve_consts(d, q, nt, torch.float64)
    ref = [x.numpy() for x in tfs.spectral_stats_plain(
        torch.from_numpy(data), tc, ac)]
    stats = spectral_wide("stats", p)
    staged = stats(True, data, tc.numpy(), ac.numpy())
    streamed = stats(False, data, tc.numpy(), ac.numpy())
    for a, b in zip(staged, streamed):
        assert np.array_equal(a, b)
    assert rel_all(staged, ref) <= 1e-12
    pm = np.random.default_rng(p).uniform(-1, 1, (p, nv))
    c_post = (q.sum() - 1) * 0.5 + 1e-6
    consts = tfs.pack_spectral_consts(d, q, nt, np.full(p, 0.5), 1e-6,
                                      c_post, 1e-8, 50.0, torch.float64,
                                      (1.0, c_post + 0.5))
    for kind in ("maxits", "trialmode"):
        td, _, cap = det_pair(kind, {"max-trials": "3"}) \
            if kind != "maxits" else (None, None, 10)
        dargs = _cuda.detector_args(td)
        plain = [x.numpy() for x in tfs.spectral_core_plain(
            *(torch.from_numpy(x) for x in ref), torch.from_numpy(pm),
            consts, cap, td)]
        core = spectral_wide("core", p)(*ref, pm, consts.numpy(), cap, dargs)
        assert rel_all(core, plain) <= 1e-12
        assert np.array_equal(core[6], plain[6].reshape(core[6].shape))
        for form in (True, False):
            fused = spectral_wide("fused", p)(
                form, data, tc.numpy(), ac.numpy(), pm, consts.numpy(), cap,
                dargs)
            assert rel_all(fused, core) <= 1e-12


@pytest.fixture(scope="module")
def whole_wide(tmp_path_factory):
    """(P, Q) -> kernel 4's per-shape instance at double on the host."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    libs = {}

    def get(p, nq):
        if (p, nq) not in libs:
            libs[p, nq] = torch_hostcc.whole_kernel_fn(
                p, nq, tmp_path_factory.mktemp(f"wholewide{p}{nq}"))
        return libs[p, nq]
    return get


WHOLE_WIDE_CASES = [(12, 2, "maxits"), (12, 2, "trialmode"), (12, 1, "lm"),
                    (16, 1, "maxits"), (16, 1, "trialmode"),
                    (4, 4, "maxits"), (7, 3, "trialmode")]


@pytest.mark.parametrize("p,nq,kind", WHOLE_WIDE_CASES,
                         ids=[f"P{p}-Q{q}-{k}"
                              for p, q, k in WHOLE_WIDE_CASES])
def test_whole_kernel_on_host_wide(p, nq, kind, whole_wide):
    """Kernel 4's per-shape instances (D'Q_qD through a pointer) in MODE 0
    (maxits) and MODE 2 (trialmode, lm), past P = 8 and at the Q 3-4
    shapes the prebuilt list lacks: staged equal to streamed bit for bit,
    within 1e-9 of the plain version at float64 (lm 1e-8)
    (tests/test_torch_whole_kernels.py check_kernel_on_host)."""
    assert not torch_hostcc.whole_prebuilt(p, nq)
    check_kernel_on_host(kind, nq, whole_wide, p)


LOOP_WIDE_CASES = [(12, 2, -1.0), (16, 1, 0.2), (5, 4, -1.0)]


@pytest.mark.parametrize("p,nq,locked", LOOP_WIDE_CASES,
                         ids=[f"P{p}-Q{q}-{'locked' if lk > 0 else 'free'}"
                              for p, q, lk in LOOP_WIDE_CASES])
def test_loop_kernel_on_host_wide(p, nq, locked, tmp_path):
    """Kernel 5's per-shape instances (D'Q_qD through a pointer) at double,
    10 iterations, from the port's make_design_stats at float64: within
    1e-9 of each output's max of the plain version on 61 voxels."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    assert not torch_hostcc.whole_prebuilt(p, nq)
    nt, nv = 29, 61
    d, q, data, pm, pp = make_case(p, nq, nt, masked=True, seed=5)
    mt = {f"mt{i + 1}": str(t + 1)
          for i, t in enumerate(np.flatnonzero(q.sum(axis=0) == 0))}
    noise = TWhite(TOptions({"noise-pattern": "1234"[:nq], **mt}), nt,
                   [int(v) for v in mt.values()])
    ts = noise.make_design_stats(
        torch.from_numpy(d), torch.from_numpy(data[:, :nv].astype(np.float64)))
    b0, c0, ntg, ib, ic = noise_consts(q)
    consts = tfl.pack_loop_consts(ts.dtqd, b0, c0, ntg, ib, ic)
    pm64 = torch.from_numpy(pm[:, :nv].astype(np.float64))
    pp64 = torch.from_numpy(pp[:, :nv].astype(np.float64))
    fn = torch_hostcc.loop_kernel_fn(p, nq, tmp_path)
    kout = fn(10, locked, consts.numpy(), ts.m0.numpy(), ts.rtqr.numpy(),
              ts.dtqr.numpy(), pm64.numpy(), pp64.numpy())
    ref = tfl.fused_vb_loop_plain(ts.m0, ts.rtqr, ts.dtqr, consts, pm64,
                                  pp64, 10, locked)
    for k, r in zip(kout, ref):
        assert k.shape == tuple(r.shape)
        assert rel(k, r.numpy()) <= 1e-9


@pytest.mark.parametrize("nq,kind", [(1, "maxits"), (2, "maxits"),
                                     (1, "pointzeroone")])
def test_ar_kernel_on_host_p12(nq, kind, ar_host):
    """Kernel 9's per-shape instance at P = 12 (D'M_sD through a pointer)
    at double against the plain version at float64
    (tests/test_torch_ar_kernels.py check_host_f64: F 1e-12, the rest
    1e-11, iteration counts and engine-initial tags equal)."""
    check_host_f64(nq, kind, ar_host, 12)


# -- (d) build_instance without nvcc -----------------------------------------

def test_instance_limits_and_buildable_shapes():
    """The limits come from the csrc files that fix them; the spectral
    and AR families start past the prebuilt P, the whole family serves
    any (P, Q) up to (20, 4)."""
    assert _cuda.instance_limits("spectral") == (25, 1)
    assert _cuda.instance_limits("whole") == (20, 4)
    assert _cuda.instance_limits("ar") == (16, 2)
    assert _cuda.instance_buildable("spectral", 9)
    assert _cuda.instance_buildable("spectral", 25)
    assert not _cuda.instance_buildable("spectral", 8)
    assert not _cuda.instance_buildable("spectral", 26)
    assert _cuda.instance_buildable("whole", 3, 4)
    assert _cuda.instance_buildable("whole", 20, 4)
    assert not _cuda.instance_buildable("whole", 21, 1)
    assert not _cuda.instance_buildable("whole", 4, 5)
    assert _cuda.instance_buildable("ar", 16, 2)
    assert not _cuda.instance_buildable("ar", 8, 1)
    assert not _cuda.instance_buildable("ar", 17, 1)
    assert not _cuda.instance_buildable("ar", 12, 3)
    with pytest.raises(FabberError, match="no per-shape whole instance"):
        _cuda.build_instance("whole", 21, 1)


def test_instance_units_and_key():
    """One small unit per source of the family: the shape's defines, then
    the source's include. The key covers the shape, the sources, the
    headers and the flags."""
    units = _cuda.instance_sources("whole", 12, 2)
    assert sorted(units) == ["fused_loop", "fused_whole"]
    for stem, text in units.items():
        lines = [ln for ln in text.splitlines() if not ln.startswith("//")]
        assert lines == ["#define FABBER_INST_P 12",
                         "#define FABBER_INST_Q 2", f'#include "{stem}.cu"']
    spec = _cuda.instance_sources("spectral", 20)
    assert sorted(spec) == ["spectral_core", "spectral_fused",
                            "spectral_stats"]
    assert "FABBER_INST_Q" not in "".join(spec.values())
    assert _cuda.instance_sources("ar", 12, 1)["fused_ar_loop"].count(
        "#define FABBER_INST_Q 1") == 1
    keys = {_cuda.instance_key(f, p, q) for f, p, q in (
        ("whole", 12, 2), ("whole", 12, 1), ("whole", 16, 2),
        ("spectral", 12, 1), ("ar", 12, 1))}
    assert len(keys) == 5
    assert _cuda.instance_key("whole", 12, 2) == \
        _cuda.instance_key("whole", 12, 2)
    flags = list(_cuda.NVCC_FLAGS)
    try:
        _cuda.NVCC_FLAGS.append("-DFABBER_X")
        assert _cuda.instance_key("whole", 12, 2) not in keys
    finally:
        _cuda.NVCC_FLAGS[:] = flags


def test_failed_instance_build_raises_with_nvcc_stderr(tmp_path,
                                                       monkeypatch):
    """A unit nvcc refuses raises FabberError with nvcc's output; no
    library is written or loaded and nothing runs in its place. The log
    keeps the failure."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no instance today' >&2\n"
                    "exit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(FabberError) as err:
        _cuda.build_instance("ar", 12, 1)
    msg = str(err.value)
    assert "did not build" in msg and "error: no instance today" in msg
    key = _cuda.instance_key("ar", 12, 1)
    assert not (tmp_path / "kernels" / "inst"
                / f"libfabber_inst_{key}.so").exists()
    assert key not in _cuda._inst_libs
    assert "no instance today" in _cuda.inst_build_log[key][1]
    unit = tmp_path / "kernels" / "inst" / f"{key}.fused_ar_loop.cu"
    assert unit.read_text() == \
        _cuda.instance_sources("ar", 12, 1)["fused_ar_loop"]
    assert not any(n.endswith(".o") for n in os.listdir(unit.parent))


def test_route_choice_builds_nothing(monkeypatch):
    """Choosing a route past the prebuilt lists on the card asks the lists
    and the limits alone: no build at construction (the build runs at
    the route's first launch)."""
    built = []
    monkeypatch.setattr(_cuda, "build_instance",
                        lambda *a: built.append(a))
    monkeypatch.setattr(_cuda, "has_whole_instance",
                        lambda p, q: p <= 8 and q <= (3 if p <= 5 else 2))
    monkeypatch.setattr(_cuda, "has_ar_instance",
                        lambda p, q: p <= 8 and q <= 2)
    data = np.random.default_rng(0).standard_normal((8, 40)).astype(
        np.float32)
    for extra, route in (({}, "spectral-whole"),
                         ({"noise-pattern": "12"}, "pallas-whole"),
                         ({"noise-pattern": "1234"}, "pallas-whole"),
                         ({"noise": "ar"}, "pallas-loop-ar")):
        o = TOptions({"model": "poly", "degree": "11", "noise": "white",
                      "max-iterations": "10", "dtype": "single", **extra})
        eng = VBInference(get_model_class("poly")(o), o, data, device="cpu")
        assert eng.route == route
        eng.device = torch.device("cuda")
        eng._require_kernel_instance()
    assert built == []
