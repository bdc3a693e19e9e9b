"""The plain versions of the port's fixed-design kernels against the JAX
package's Pallas kernels run in interpret mode, as the JAX tests run
them on the CPU: the whole-program kernel (kernel 4, ops/fused_whole.py)
in maxits and its pointzeroone / trialmode / lm modes, the stats-input
whole-loop kernel (kernel 5, ops/fused_loop.py) and the one-kernel
spectral form (kernel 3, ops/fused_spectral.py spectral_fused). Inputs
come from one numpy seed and go to both packages.

Float32 bounds (the two sides sum the statistics in different orders):
  kernel 4, maxits: means within 1e-3 posterior sd, every other output
    within 1e-4 of its max; detector modes: at most 3 of 256 lanes with
    another iteration count (a near-threshold |dF| flips on the last
    bits, tests/test_fused_whole.py), the other lanes as maxits, F within
    1e-4 of its max;
  kernel 5 (the same statistics into both): every output 1e-4;
  kernel 3: every output 1e-4, iteration counts and engine-initial tags
    equal.
Float64: kernel 4 and 5 against the JAX engine's statistics route, 1e-9.
Kernel 4 itself, compiled as host C++ at double (tests/torch_hostcc.py;
skipped without g++): its staged and streamed forms bit for bit, and
both within 1e-9 of the plain version at float64. Kernel 5 itself, the
same way: within 1e-9 of the JAX kernel interpreted at float64, and of
its plain version at float64 on a ragged voxel count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.inference.convergence import \
    get_detector_class as jdetector
from fabber_core_tpu.noise.white import WhiteNoiseModel as JWhite
from fabber_core_tpu.ops import fused_loop as jfl
from fabber_core_tpu.ops import fused_spectral as jfs
from fabber_core_tpu.ops import fused_whole as jfw
from fabber_core_tpu.ops import spectral as jspec
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.convert import design_stats_from_numpy
from fabber_core_tpu_torch.inference.convergence import \
    get_detector_class as tdetector
from fabber_core_tpu_torch.inference.vb import VBInference
from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.ops import fused_loop as tfl
from fabber_core_tpu_torch.ops import fused_spectral as tfs
from fabber_core_tpu_torch.ops import fused_whole as tfw
from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.options import RunOptions

import torch_hostcc

torch.set_num_threads(1)

NV = 256


def design(p, nt):
    t = np.arange(1, nt + 1, dtype=np.float64) / nt
    return np.stack([np.ones(nt)] + [np.cos(np.pi * k * t)
                                     for k in range(1, p)], axis=1)


def group_masks(nq, nt, masked):
    q = np.zeros((nq, nt))
    q[np.arange(nt) % nq, np.arange(nt)] = 1.0
    if masked:
        q[:, [2, nt // 2]] = 0.0
    return q


def make_case(p, nq, nt, masked, seed=0):
    """Data [T,V] float32 with a noise sd per group and per voxel
    (log-uniform, so lanes settle at different iterations), the group
    masks, prior means and precisions."""
    rng = np.random.default_rng(seed + 100 * p + 10 * nq + nt)
    d = design(p, nt)
    q = group_masks(nq, nt, masked)
    truth = rng.uniform(-2, 2, (p, NV))
    sd = 10.0 ** rng.uniform(-2, 0.5, NV)
    gsd = 1.0 + np.arange(nq)[np.arange(nt) % nq]
    data = d @ truth + gsd[:, None] * sd * rng.standard_normal((nt, NV))
    pm = rng.uniform(-0.5, 0.5, (p, NV))
    pp = np.full((p, NV), 1e-3)
    return d, q, data.astype(np.float32), pm.astype(np.float32), \
        pp.astype(np.float32)


def noise_consts(q):
    nq = q.shape[0]
    return np.full(nq, 1e6), np.full(nq, 1e-6), q.sum(axis=1), 1e-8, 50.0


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def sd_err(got, ref, cov):
    sd = np.sqrt(np.stack([cov[i, i] for i in range(cov.shape[0])]))
    return np.max(np.abs(np.asarray(got, np.float64) - ref) / sd)


def det_dict(kind, p, nq, nt):
    """The port's detector dict (VBInference._nl_fdet_consts, host
    float64 ELBO constants) and the loop cap, from an engine on the
    CPU with the same noise groups."""
    opts = RunOptions({"model": "poly", "degree": str(p - 1),
                       "noise": "white", "dtype": "single",
                       "convergence": kind, "max-iterations": "8",
                       "max-trials": "3", "noise-pattern": "123"[:nq]})
    eng = VBInference(get_model_class("poly")(opts), opts,
                      np.ones((4, nt), np.float32), device="cpu")
    return eng._nl_fdet_consts(), eng.max_iter_cap


def jax_whole(p, nq, nt, d, q, data, pm, pp, n_iters, locked=-1.0,
              kind=None, det=None):
    b0, c0, ntg, ib, ic = noise_consts(q)
    jdet, det_consts = None, None
    if kind is not None:
        jdet = jdetector(kind)(JOptions({"max-iterations": "8",
                                         "max-trials": "3"}))
        conv1 = jdet.init_state(1, jnp.float32)
        det_consts = {"lb_coeff": det["lb_coeff"], "f_const": det["f_const"],
                      "init_save": bool(np.asarray(conv1.save)[0]),
                      "sentinel": float(np.asarray(conv1.prev_f)[0])}
    call = jfw.make_fused_whole_loop(
        p, nq, n_iters, nt, NV, jnp.float32, locked_noise_stdev=locked,
        block=NV, interpret=True, detector=jdet, det_consts=det_consts)
    tp = jfw.pad_time(nt)
    tc = jfw.pack_time_consts(d, q, nt, tp, jnp.float32)
    sc = jfw.pack_scalar_consts(d, q, nt, b0, c0, ntg, ib, ic, jnp.float32)
    out = call(call.fold_data(jnp.asarray(data)), tc, sc, jnp.asarray(pm),
               jnp.asarray(pp))
    return [np.asarray(x) for x in out]


def port_whole(p, nq, nt, d, q, data, pm, pp, n_iters, locked=-1.0,
               det=None, dtype=torch.float32):
    b0, c0, ntg, ib, ic = noise_consts(q)
    tc = tfw.pack_whole_time_consts(d, q, nt, dtype)
    sc = tfw.pack_whole_consts(d, q, nt, b0, c0, ntg, ib, ic)
    out = tfw.fused_whole(torch.from_numpy(data).to(dtype), tc, sc,
                          torch.from_numpy(pm).to(dtype),
                          torch.from_numpy(pp).to(dtype), n_iters, locked,
                          det)
    return [x.numpy() for x in out]


def assert_outputs_match(tout, jout, keep=slice(None)):
    cov = jout[2][..., keep].astype(np.float64)
    assert sd_err(tout[0][..., keep], jout[0][..., keep], cov) <= 1e-3
    for t, j in zip(tout[1:], jout[1:]):
        assert t.shape == j.shape
        assert rel(t[..., keep], j[..., keep]) <= 1e-4


WHOLE_CASES = [(1, 1, 106, False, -1.0), (3, 1, 106, True, -1.0),
               (2, 2, 29, False, -1.0), (3, 2, 106, True, -1.0),
               (4, 3, 29, True, -1.0), (3, 2, 29, False, 0.5),
               (4, 1, 106, False, 0.2),
               # P = 5..8 (the card's instances since P <= 4), the cosine
               # design: poly degree >= 5 is beyond float32
               (6, 1, 106, False, -1.0), (6, 2, 29, True, -1.0),
               (8, 1, 29, False, 0.2), (8, 2, 29, True, -1.0)]


@pytest.mark.parametrize("p,nq,nt,masked,locked", WHOLE_CASES,
                         ids=[f"P{c[0]}-Q{c[1]}-T{c[2]}"
                              + ("-masked" if c[3] else "")
                              + ("-locked" if c[4] > 0 else "")
                              for c in WHOLE_CASES])
def test_whole_plain_matches_pallas_kernel(p, nq, nt, masked, locked):
    """Kernel 4, maxits, 10 iterations."""
    d, q, data, pm, pp = make_case(p, nq, nt, masked)
    jout = jax_whole(p, nq, nt, d, q, data, pm, pp, 10, locked)
    tout = port_whole(p, nq, nt, d, q, data, pm, pp, 10, locked)
    assert_outputs_match(tout, jout)


@pytest.mark.parametrize("nq", [1, 2])
@pytest.mark.parametrize("kind", ["pointzeroone", "trialmode", "lm"])
def test_whole_plain_detector_matches_pallas_kernel(kind, nq):
    """Kernel 4's detector modes at the engine's loop cap: iteration
    counts, F and the selected state."""
    check_detector_vs_pallas(kind, 3, nq, 29)


@pytest.mark.parametrize("kind", ["trialmode", "lm"])
def test_whole_plain_detector_matches_pallas_kernel_p6(kind):
    """The same at P = 6, Q = 2 (masked), T=106 (at T=29 no P = 6 lane
    stops before the cap)."""
    check_detector_vs_pallas(kind, 6, 2, 106)


def check_detector_vs_pallas(kind, p, nq, nt):
    """test_whole_plain_detector_matches_pallas_kernel's comparison."""
    d, q, data, pm, pp = make_case(p, nq, nt, masked=nq == 2, seed=1)
    det, cap = det_dict(kind, p, nq, nt)
    jout = jax_whole(p, nq, nt, d, q, data, pm, pp, cap, kind=kind, det=det)
    tout = port_whole(p, nq, nt, d, q, data, pm, pp, cap, det=det)
    flip = tout[6][0] != jout[6][0]
    assert flip.sum() <= 3, flip.sum()
    assert len(np.unique(tout[6][0])) > 1          # lanes stop apart
    assert_outputs_match(tout, jout, keep=~flip)


@pytest.mark.parametrize("kind", ["maxits", "trialmode", "lm"])
def test_whole_plain_f64_matches_stats_route(kind):
    """At float64 kernel 4's plain version is the JAX engine's XLA
    statistics route arithmetic: its statistics equal make_design_stats
    and its maxits posterior equals fused_vb_loop_plain's from them, to
    1e-9; the detector modes' outputs are finite and their F matches a
    float32 run's within its rounding."""
    check_f64_stats_route(kind, 3)


@pytest.mark.parametrize("p", [6, 8])
def test_whole_plain_f64_matches_stats_route_wide(p):
    """The same at P = 6 and 8, maxits."""
    check_f64_stats_route("maxits", p)


def check_f64_stats_route(kind, p):
    """test_whole_plain_f64_matches_stats_route's comparison at P."""
    nq, nt = 2, 29
    d, q, data, pm, pp = make_case(p, nq, nt, masked=True, seed=2)
    data64 = data.astype(np.float64)
    mt = {f"mt{i + 1}": str(t + 1)
          for i, t in enumerate(np.flatnonzero(q.sum(axis=0) == 0))}
    jnoise = JWhite(JOptions({"noise-pattern": "12", **mt}), nt,
                    [int(v) for v in mt.values()])
    js = jnoise.make_design_stats(jnp.asarray(d), jnp.asarray(data64))
    b0, c0, ntg, ib, ic = noise_consts(q)
    tc = tfw.pack_whole_time_consts(d, q, nt, torch.float64)
    sc = tfw.pack_whole_consts(d, q, nt, b0, c0, ntg, ib, ic)
    m0, rtqr, dtqr = tfw.whole_stats_plain(torch.from_numpy(data64), tc, sc,
                                           p, nq)
    a = d.T @ d
    np.testing.assert_allclose(m0.numpy(), np.asarray(js.m0), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(js.m0)).max())
    np.testing.assert_allclose(rtqr.numpy(), np.asarray(js.rtqr), rtol=1e-9)
    scale = np.abs(a @ np.asarray(js.m0)).max()
    assert np.abs(dtqr.numpy() - np.asarray(js.dtqr)).max() <= 1e-9 * scale
    if kind == "maxits":
        whole = port_whole(p, nq, nt, d, q, data64.astype(np.float32), pm,
                           pp, 10, dtype=torch.float64)
        # the float32-cast data above: feed the same values to the loop
        tstats = tfw.whole_stats_plain(
            torch.from_numpy(data64.astype(np.float32)).double(), tc, sc, p,
            nq)
        loop = tfl.fused_vb_loop_plain(
            *tstats, sc, torch.from_numpy(pm).double(),
            torch.from_numpy(pp).double(), 10)
        for w, lo in zip(whole[:5], loop):
            np.testing.assert_allclose(w, lo.numpy(), rtol=1e-9,
                                       atol=1e-9 * np.abs(lo.numpy()).max())
    else:
        det, cap = det_dict(kind, p, nq, nt)
        r64 = port_whole(p, nq, nt, d, q, data, pm, pp, cap, det=det,
                         dtype=torch.float64)
        r32 = port_whole(p, nq, nt, d, q, data, pm, pp, cap, det=det)
        assert all(np.isfinite(x).all() for x in r64)
        same = r64[6][0] == r32[6][0]
        assert same.mean() > 0.95
        assert rel(r32[5][0][same], r64[5][0][same]) <= 1e-4


@pytest.mark.parametrize("nq,locked", [(1, -1.0), (2, -1.0), (3, 0.3)])
def test_loop_plain_matches_pallas_kernel(nq, locked):
    """Kernel 5: the JAX package's make_design_stats (float32) into both
    the Pallas kernel and the plain version."""
    check_loop_vs_pallas(3, nq, locked)


@pytest.mark.parametrize("p,nq,locked", [(6, 2, -1.0), (8, 1, 0.3)])
def test_loop_plain_matches_pallas_kernel_wide(p, nq, locked):
    """The same at P = 6 and 8."""
    check_loop_vs_pallas(p, nq, locked)


def check_loop_vs_pallas(p, nq, locked):
    """test_loop_plain_matches_pallas_kernel's comparison at P."""
    nt = 29
    d, q, data, pm, pp = make_case(p, nq, nt, masked=True, seed=3)
    pattern = "123"[:nq]
    mt = {f"mt{i + 1}": str(t + 1)
          for i, t in enumerate(np.flatnonzero(q.sum(axis=0) == 0))}
    jnoise = JWhite(JOptions({"noise-pattern": pattern, **mt}), nt,
                    [int(v) for v in mt.values()])
    js = jnoise.make_design_stats(jnp.asarray(d, jnp.float32),
                                  jnp.asarray(data))
    b0, c0, ntg, ib, ic = noise_consts(q)
    call = jfl.make_fused_vb_loop(p, nq, 10, NV, jnp.float32,
                                  locked_noise_stdev=locked, block=NV,
                                  interpret=True)
    jconsts = jfl.pack_consts(js.dtqd, b0[:, None], c0[:, None], ntg, ib,
                              ic, jnp.float32)
    jout = [np.asarray(x) for x in call(js.m0, js.rtqr, js.dtqr, jconsts,
                                        jnp.asarray(pm), jnp.asarray(pp))]
    ts = design_stats_from_numpy(js)
    consts = tfl.pack_loop_consts(ts.dtqd, b0, c0, ntg, ib, ic)
    np.testing.assert_array_equal(consts.to(torch.float32).numpy(),
                                  np.asarray(jconsts)[::8, 0])
    tout = tfl.fused_vb_loop(ts.m0, ts.rtqr, ts.dtqr, consts,
                             torch.from_numpy(pm), torch.from_numpy(pp), 10,
                             locked)
    for t, j in zip(tout, jout):
        assert t.shape == j.shape
        assert rel(t.numpy(), j) <= 1e-4


SPECTRAL_CASES = [(None, {}), ("pointzeroone", {}), ("freduce", {}),
                  ("trialmode", {"max-trials": "3"})]


@pytest.mark.parametrize("kind,extra", SPECTRAL_CASES,
                         ids=[c[0] or "maxits" for c in SPECTRAL_CASES])
def test_spectral_fused_plain_matches_pallas_kernel(kind, extra):
    """Kernel 3 (spectral-impl=fused) in maxits and its detector modes."""
    p, nt = 3, 106
    d, q, data, pm, _ = make_case(p, 1, nt, masked=True, seed=4)
    qm = q[0]
    c_post = (qm.sum() - 1) * 0.5 + 1e-6
    args = (d, qm, nt, np.full(p, 1e-3), 1e-6, c_post, 1e-8, 50.0)
    elbo = (jspec.eigen_elbo_const(qm, c_post, 1e-6, 1e6, p), c_post + 0.5)
    n_iters, td, jd, det_consts = 10, None, None, None
    if kind is not None:
        opts = {"max-iterations": "10", **extra}
        td = tdetector(kind)(RunOptions(dict(opts)))
        jd = jdetector(kind)(JOptions(dict(opts)))
        n_iters = int(td.max_iterations) + 2
        conv1 = jd.init_state(1, jnp.float32)
        det_consts = {"sentinel": float(np.asarray(conv1.prev_f)[0]),
                      "init_save": bool(np.asarray(conv1.save)[0])}
    call = jfs.make_fused_spectral_loop(p, n_iters, nt, NV, jnp.float32,
                                        block=NV, interpret=True,
                                        detector=jd, det_consts=det_consts)
    jout = [np.asarray(x) for x in call(
        call.fold_data(jnp.asarray(data)),
        jfs.pack_spectral_time_consts(d, qm, nt, jnp.float32),
        jfs.pack_spectral_consts(*args, jnp.float32, elbo), jnp.asarray(pm))]
    tout = [x.numpy() for x in tfs.spectral_fused(
        torch.from_numpy(data), tfs.pack_mxu_consts(d, qm, nt, torch.float32),
        tfs.pack_solve_consts(d, qm, nt, torch.float32),
        torch.from_numpy(pm),
        tfs.pack_spectral_consts(*args, torch.float32, elbo), n_iters, td)]
    if kind is not None:
        np.testing.assert_array_equal(tout[6], jout[6])
        np.testing.assert_array_equal(tout[3] < 0, jout[3] < 0)
    for t, j in zip(tout, jout):
        assert t.shape == j.shape
        assert rel(t, j) <= 1e-4


def test_wrappers_on_cpu_run_the_plain_versions():
    """On CPU tensors the wrappers are their plain versions and count
    no launch."""
    p, nq, nt = 3, 2, 29
    d, q, data, pm, pp = make_case(p, nq, nt, masked=False)
    b0, c0, ntg, ib, ic = noise_consts(q)
    tc = tfw.pack_whole_time_consts(d, q, nt, torch.float32)
    sc = tfw.pack_whole_consts(d, q, nt, b0, c0, ntg, ib, ic)
    x, tpm, tpp = (torch.from_numpy(a) for a in (data, pm, pp))
    tfw.fused_whole.launches = tfl.fused_vb_loop.launches = 0
    tfs.spectral_fused.launches = 0
    for a, b in zip(tfw.fused_whole(x, tc, sc, tpm, tpp, 3),
                    tfw.fused_whole_plain(x, tc, sc, tpm, tpp, 3)):
        assert torch.equal(a, b)
    stats = tfw.whole_stats_plain(x, tc, sc, p, nq)
    for a, b in zip(tfl.fused_vb_loop(*stats, sc, tpm, tpp, 3),
                    tfl.fused_vb_loop_plain(*stats, sc, tpm, tpp, 3)):
        assert torch.equal(a, b)
    assert tfw.fused_whole.launches == tfl.fused_vb_loop.launches == 0
    with pytest.raises(ValueError, match="freduce"):
        tfw.fused_whole(x, tc, sc, tpm, tpp, 3,
                        detector={"det": tdetector("freduce")(
                            RunOptions({}))})
    with pytest.raises(ValueError, match="n_iters"):
        tfl.fused_vb_loop(*stats, sc, tpm, tpp, 0)
    with pytest.raises(ValueError, match="no kernel"):
        tfw.fused_whole(x.to("meta"), tc, sc, tpm.to("meta"),
                        tpp.to("meta"), 3)


def test_pack_consts_match_jax_layout():
    """The port's constants are the JAX blocks without the ROWS (8x)
    replication and the time padding."""
    p, nq, nt = 3, 2, 29
    d, q, _, _, _ = make_case(p, nq, nt, masked=True)
    b0, c0, ntg, ib, ic = noise_consts(q)
    tp = jfw.pad_time(nt)
    jtc = np.asarray(jfw.pack_time_consts(d, q, nt, tp, jnp.float64))[::8, 0]
    ttc = tfw.pack_whole_time_consts(d, q, nt, torch.float64).numpy()
    np.testing.assert_array_equal(ttc, jtc.reshape(-1, tp)[:, :nt])
    jsc = np.asarray(jfw.pack_scalar_consts(d, q, nt, b0, c0, ntg, ib, ic,
                                            jnp.float64))[::8, 0]
    tsc = tfw.pack_whole_consts(d, q, nt, b0, c0, ntg, ib, ic).numpy()
    np.testing.assert_allclose(tsc, jsc, rtol=1e-15, atol=0)


# -- kernel 4 compiled as host C++ (tests/torch_hostcc.py) ------------------

@pytest.fixture(scope="module")
def whole_host(tmp_path_factory):
    """(P, Q) -> kernel 4 at double on the host, both forms (built once
    per module; skipped without g++)."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    libs = {}

    def get(p, nq):
        if (p, nq) not in libs:
            libs[p, nq] = torch_hostcc.whole_kernel_fn(
                p, nq, tmp_path_factory.mktemp(f"whole{p}{nq}"))
        return libs[p, nq]
    return get


HOST_CASES = [("maxits", 1), ("maxits", 2), ("pointzeroone", 1),
              ("pointzeroone", 2), ("trialmode", 1), ("trialmode", 2),
              ("lm", 1), ("lm", 2)]
# the P = 5..8 instances: (P, Q, mode)
WIDE_HOST_CASES = [(6, 1, "maxits"), (6, 2, "lm"), (8, 2, "maxits"),
                   (8, 1, "trialmode")]


@pytest.mark.parametrize("p,nq,kind", WIDE_HOST_CASES,
                         ids=[f"P{p}-{k}-Q{q}" for p, q, k in WIDE_HOST_CASES])
def test_kernel_on_host_wide(p, nq, kind, whole_host):
    """test_kernel_on_host_staged_equals_streamed at P = 6 and 8."""
    check_kernel_on_host(kind, nq, whole_host, p)


@pytest.mark.parametrize("kind,nq", HOST_CASES,
                         ids=[f"{k}-Q{q}" for k, q in HOST_CASES])
def test_kernel_on_host_staged_equals_streamed(kind, nq, whole_host):
    """Kernel 4's staged form (the block's tile in shared memory,
    csrc/tile.cuh) equals its streamed form bit for bit at double, in
    MODE 0 (maxits), 1 (pointzeroone) and 2 (trialmode, lm), and both
    match the plain version at float64 within 1e-9 of each output's max
    (iteration counts equal); lm within 1e-8: its damped steps leave the
    prior-dominated first states with a large d = means - m0, where
    k'Qk = rtqr - 2 d'D'Qr0 + d'D'QDd cancels (4.6e-9 seen at Q=2)."""
    check_kernel_on_host(kind, nq, whole_host, 3)


def check_kernel_on_host(kind, nq, whole_host, p):
    """test_kernel_on_host_staged_equals_streamed's comparison at P."""
    nt = 29
    d, q, data, pm, pp = make_case(p, nq, nt, masked=True, seed=3)
    b0, c0, ntg, ib, ic = noise_consts(q)
    tc = tfw.pack_whole_time_consts(d, q, nt, torch.float64)
    sc = tfw.pack_whole_consts(d, q, nt, b0, c0, ntg, ib, ic)
    if kind == "maxits":
        det, n_iters, dargs, dcs = None, 10, (0, 0.0, 0, 0, 0), [0.0] * (
            nq + 1)
    else:
        det, n_iters = det_dict(kind, p, nq, nt)
        dargs = _cuda.detector_args(det["det"])
        dcs = list(det["lb_coeff"]) + [det["f_const"]]
    fn = whole_host(p, nq)
    args = (n_iters, -1.0, sc.numpy(), dargs, dcs, data, tc.numpy(), pm, pp)
    staged, streamed = fn(True, *args), fn(False, *args)
    for a, b in zip(staged, streamed):
        assert np.array_equal(a, b)
    ref = port_whole(p, nq, nt, d, q, data, pm, pp, n_iters, det=det,
                     dtype=torch.float64)
    for a, r in zip(staged, ref):
        assert rel(a.reshape(r.shape), r) <= (1e-8 if kind == "lm" else 1e-9)


# -- kernel 5 compiled as host C++ (tests/torch_hostcc.py) ------------------

LOOP_HOST_CASES = [(nq, locked) for nq in (1, 2, 3) for locked in (-1.0, 0.2)]
# the P = 5..8 instances: (P, Q, locked sd)
WIDE_LOOP_HOST_CASES = [(6, 2, -1.0), (8, 1, 0.2)]


@pytest.mark.parametrize("p,nq,locked", WIDE_LOOP_HOST_CASES,
                         ids=[f"P{p}-Q{q}-{'locked' if lk > 0 else 'free'}"
                              for p, q, lk in WIDE_LOOP_HOST_CASES])
def test_loop_kernel_on_host_wide(p, nq, locked, tmp_path):
    """test_loop_kernel_on_host_matches_pallas_kernel_and_plain at P = 6
    and 8."""
    check_loop_kernel_on_host(p, nq, locked, tmp_path)


@pytest.mark.parametrize("nq,locked", LOOP_HOST_CASES,
                         ids=[f"Q{q}-{'locked' if lk > 0 else 'free'}"
                              for q, lk in LOOP_HOST_CASES])
def test_loop_kernel_on_host_matches_pallas_kernel_and_plain(nq, locked,
                                                             tmp_path):
    """Kernel 5 (csrc/fused_loop.cu) at double, 10 iterations, from the
    JAX package's make_design_stats at float64: within 1e-9 of each
    output's max of the JAX Pallas kernel interpreted at float64 on 64
    voxels (a multiple of its ROWS=8 that its block divides), and of the
    plain version at float64 on 61 voxels (a multiple of neither 4 nor
    a block)."""
    check_loop_kernel_on_host(3, nq, locked, tmp_path)


def check_loop_kernel_on_host(p, nq, locked, tmp_path):
    """test_loop_kernel_on_host_matches_pallas_kernel_and_plain's
    comparison at P."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    nt = 29
    fn = torch_hostcc.loop_kernel_fn(p, nq, tmp_path)
    d, q, data, pm, pp = make_case(p, nq, nt, masked=True, seed=5)
    mt = {f"mt{i + 1}": str(t + 1)
          for i, t in enumerate(np.flatnonzero(q.sum(axis=0) == 0))}
    jnoise = JWhite(JOptions({"noise-pattern": "123"[:nq], **mt}), nt,
                    [int(v) for v in mt.values()])
    js = jnoise.make_design_stats(jnp.asarray(d),
                                  jnp.asarray(data.astype(np.float64)))
    ts = design_stats_from_numpy(js)
    b0, c0, ntg, ib, ic = noise_consts(q)
    consts = tfl.pack_loop_consts(ts.dtqd, b0, c0, ntg, ib, ic)
    pm64, pp64 = pm.astype(np.float64), pp.astype(np.float64)

    nv = 64
    call = jfl.make_fused_vb_loop(p, nq, 10, nv, jnp.float64,
                                  locked_noise_stdev=locked, block=nv,
                                  interpret=True)
    jconsts = jfl.pack_consts(js.dtqd, b0[:, None], c0[:, None], ntg, ib,
                              ic, jnp.float64)
    np.testing.assert_array_equal(consts.numpy(), np.asarray(jconsts)[::8, 0])
    jout = call(js.m0[:, :nv], js.rtqr[:, :nv], js.dtqr[:, :, :nv], jconsts,
                jnp.asarray(pm64[:, :nv]), jnp.asarray(pp64[:, :nv]))
    kout = fn(10, locked, consts.numpy(), np.asarray(js.m0)[:, :nv],
              np.asarray(js.rtqr)[:, :nv], np.asarray(js.dtqr)[:, :, :nv],
              pm64[:, :nv], pp64[:, :nv])
    for k, j in zip(kout, jout):
        assert k.shape == j.shape
        assert rel(k, np.asarray(j)) <= 1e-9

    nv = 61
    kout = fn(10, locked, consts.numpy(), ts.m0[:, :nv].numpy(),
              ts.rtqr[:, :nv].numpy(), ts.dtqr[:, :, :nv].numpy(),
              pm64[:, :nv], pp64[:, :nv])
    ref = tfl.fused_vb_loop_plain(
        ts.m0[:, :nv], ts.rtqr[:, :nv], ts.dtqr[:, :, :nv], consts,
        torch.from_numpy(pm64[:, :nv]), torch.from_numpy(pp64[:, :nv]), 10,
        locked)
    for k, r in zip(kout, ref):
        assert k.shape == tuple(r.shape)
        assert rel(k, r.numpy()) <= 1e-9
