"""The port's statistics and core kernels' plain versions against the
JAX package's Pallas kernels (run in interpret mode, as the JAX tests
run them on the CPU) and against the JAX float64 references, plus the
wrappers' CPU behaviour. Inputs come from numpy (default_rng) and go
to both packages.

Float32 bounds (errors over the max |JAX value| of each quantity; the
two sides sum in different orders):
  stats  m0 1e-3 (an OLS reference point through the cond~2e8 poly
         Gram: any finite value is correct, it only has to be the one
         the other statistics were taken about), rtqr 1e-4,
         D'Qy = dtqr + A m0 1e-5 (the well-conditioned combination the
         core consumes; dtqr alone is rounding residue);
  core   every output 1e-4.
Float64 bound: 1e-9 (same algebra, same inputs).

Kernel 1 itself (csrc/spectral_stats.cu), compiled as host C++ (tests/
torch_hostcc.py, skipped without g++) in its staged form (blocks of 32
or 64 lanes run as threads, on planes whose rows start at each offset
from 16-byte alignment, with ragged last blocks) and its streamed form:
the two agree bit for bit, at double the plain version at float64
within 1e-12 (m0 in the well-conditioned synthetic design; the poly
design's m0 within 1e-9) and at float32 within the plain float32 bounds
above. Kernels 2 (csrc/spectral_core.cu, one instance per detector) and
3 (csrc/spectral_fused.cu, staged and streamed) compiled the same way:
kernel 3 in both forms equals kernel 1 staged followed by kernel 2, bit
for bit at double and at float32; at double both match the plain
versions within 1e-9 with identical decisions. The two-phase trialmode
form of kernel 2 that the probes keep (probes/csrc/core_compact.cu)
equals one launch bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.noise.white import WhiteNoiseModel as JWhite
from fabber_core_tpu.ops import fused_spectral as jfs
from fabber_core_tpu.ops import spectral as jspec
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch import FabberError, resolve_device
from fabber_core_tpu_torch.convert import design_stats_from_numpy, to_numpy
from fabber_core_tpu_torch.noise.white import WhiteNoiseModel as TWhite
from fabber_core_tpu_torch.ops import fused_spectral as tfs
from fabber_core_tpu_torch.options import RunOptions as TOptions

import torch_hostcc

torch.set_num_threads(1)


def design(p, nt):
    t = np.arange(1, nt + 1, dtype=np.float64)
    if p == 3:
        return t[:, None] ** np.arange(3)[None, :]
    u = t / nt
    return np.stack([np.ones(nt), u, np.sin(6 * np.pi * u),
                     np.cos(10 * np.pi * u)], axis=1)


def make_case(p, nt, nv, masked, seed=0):
    rng = np.random.default_rng(seed + 100 * p + nt + nv)
    d = design(p, nt)
    scale = np.array([20.0, 0.3, 0.003, 1.0])[:p] if p == 3 \
        else np.array([10.0, 4.0, 2.0, 2.0])
    truth = rng.uniform(-1, 1, (p, nv)) * scale[:, None]
    data = (d @ truth + rng.standard_normal((nt, nv))).astype(np.float32)
    q = np.ones(nt)
    if masked:
        q[[2, nt // 2]] = 0.0
    return d, q, data


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def jax_stats(p, nt, nv, d, q, data):
    call = jfs.make_spectral_stats_kernel(p, nt, nv, jnp.float32, block=128,
                                          interpret=True)
    dw8, dcol, q8, _ = jfs.pack_mxu_consts(d, q, nt, jnp.float32)
    ac = jfs.pack_solve_consts(d, q, nt, jnp.float32)
    return [np.asarray(x) for x in call(jnp.asarray(data), dw8, dcol, q8, ac)]


def port_consts(d, q, nt, dtype):
    return (tfs.pack_mxu_consts(d, q, nt, dtype),
            tfs.pack_solve_consts(d, q, nt, dtype))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("nv", [256, 200])
@pytest.mark.parametrize("nt", [30, 106])
@pytest.mark.parametrize("p", [3, 4])
def test_stats_plain_matches_pallas_kernel(p, nt, nv, masked):
    d, q, data = make_case(p, nt, nv, masked)
    jm0, jrtqr, jdtqr = jax_stats(p, nt, nv, d, q, data)
    tc, ac = port_consts(d, q, nt, torch.float32)
    m0, rtqr, dtqr = to_numpy(tfs.spectral_stats_plain(
        torch.from_numpy(data), tc, ac))
    a = ac.double().reshape(p, p).numpy()
    assert rel(m0, jm0) <= 1e-3
    assert rel(rtqr, jrtqr) <= 1e-4
    assert rel(dtqr + a @ m0, jdtqr + a @ jm0) <= 1e-5


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("p", [3, 4])
def test_stats_plain_f64_matches_design_stats(p, masked):
    """At float64 the plain statistics equal the JAX engine's
    make_design_stats (noise/white.py:278) to 1e-9, and so does the
    port's own make_design_stats."""
    nt, nv = 106, 64
    d, q, data = make_case(p, nt, nv, masked)
    data = data.astype(np.float64)
    mt = {f"mt{i + 1}": str(t + 1) for i, t in enumerate(np.flatnonzero(q == 0))}
    jnoise = JWhite(JOptions(mt), nt, [int(v) for v in mt.values()])
    js = jnoise.make_design_stats(jnp.asarray(d), jnp.asarray(data))
    tnoise = TWhite(TOptions(mt), nt, [int(v) for v in mt.values()])
    ts = tnoise.make_design_stats(torch.from_numpy(d), torch.from_numpy(data))
    tc, ac = port_consts(d, q, nt, torch.float64)
    m0, rtqr, dtqr = to_numpy(tfs.spectral_stats_plain(
        torch.from_numpy(data), tc, ac))
    jm0, jrtqr, jdtqr = (np.asarray(js.m0), np.asarray(js.rtqr),
                         np.asarray(js.dtqr)[0])
    a = d.T @ (q[:, None] * d)
    scale = np.abs(a @ jm0).max()
    for got in ((m0, rtqr, dtqr), (ts.m0.numpy(), ts.rtqr.numpy(),
                                   ts.dtqr.numpy()[0])):
        assert rel(got[0], jm0) <= 1e-9
        assert rel(got[1], jrtqr) <= 1e-9
        assert np.abs(got[2] - jdtqr).max() <= 1e-9 * scale
    jdtqd = np.asarray(js.dtqd)
    np.testing.assert_allclose(ts.dtqd.numpy(), jdtqd, rtol=1e-12,
                               atol=1e-12 * np.abs(jdtqd).max())


def core_inputs(p, nv, seed=3):
    """Statistics from the JAX stats kernel, carried over by convert.py,
    plus voxelwise prior means and the route's scalar constants."""
    nt = 106
    d, q, data = make_case(p, nt, nv, masked=False, seed=seed)
    stats = jax_stats(p, nt, nv, d, q, data)
    pm = np.random.default_rng(seed).uniform(-1, 1, (p, nv)).astype(np.float32)
    pp = np.full(p, 1e-12 if p == 3 else 0.5)
    c_post = (nt - 1) * 0.5 + 1e-6
    args = (d, q, nt, pp, 1e-6, c_post, 1e-8, 50.0)
    extra = (jspec.eigen_elbo_const(q, c_post, 1e-6, 1e6, p), c_post + 0.5)
    return stats, pm, args, extra


@pytest.mark.parametrize("n_iters", [1, 3, 10])
@pytest.mark.parametrize("p", [3, 4])
def test_core_plain_matches_pallas_kernel(p, n_iters):
    nv = 200
    stats, pm, args, extra = core_inputs(p, nv)
    jcore = jfs.make_spectral_core_kernel(p, n_iters, nv, jnp.float32,
                                          block=128, interpret=True)
    jsc = jfs.pack_spectral_consts(*args, jnp.float32, extra)
    jout = jcore(*(jnp.asarray(x) for x in stats), jnp.asarray(pm), jsc)
    tsc = tfs.pack_spectral_consts(*args, torch.float32, extra)
    tstats = design_stats_from_numpy(stats)
    tout = tfs.spectral_core_plain(*tstats, torch.from_numpy(pm), tsc,
                                   n_iters)
    names = ["means", "prec", "cov", "b", "c", "F", "tr"]
    for name, j, t in zip(names, jout, tout):
        assert t.shape == np.shape(j), name
        assert rel(t.numpy(), j) <= 1e-4, name


@pytest.mark.parametrize("n_iters", [1, 3, 10])
@pytest.mark.parametrize("p", [3, 4])
def test_core_plain_f64_matches_spectral_loop(p, n_iters):
    """At float64 the plain core equals the JAX XLA eigenbasis loop
    (ops/spectral.py make_spectral_loop) to 1e-9."""
    nv = 96
    stats, pm, args, extra = core_inputs(p, nv, seed=5)
    d, q, nt, pp, inv_b0, c_post, b_init, c_init = args
    stats64 = [s.astype(np.float64) for s in stats]
    pm64 = pm.astype(np.float64)
    jout = jspec.make_spectral_loop(d, q, pp, n_iters, b_init, c_init,
                                    inv_b0, c_post, jnp.float64)(
        *(jnp.asarray(x) for x in stats64), jnp.asarray(pm64))
    tsc = tfs.pack_spectral_consts(*args, torch.float64, extra)
    tout = tfs.spectral_core_plain(*(torch.from_numpy(x) for x in stats64),
                                   torch.from_numpy(pm64), tsc, n_iters)
    for j, t in zip(jout, tout[:5]):      # means, prec, cov, b, c
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9,
                                   atol=1e-9 * np.abs(np.asarray(j)).max())


DET_CASES = [("pointzeroone", {}), ("freduce", {}),
             ("trialmode", {"max-trials": "3"})]


def det_pair(name, extra):
    """The port's and the JAX package's detector for the same options,
    and the engine's loop bound (max_iterations + 2)."""
    from fabber_core_tpu.inference.convergence import \
        get_detector_class as jget
    from fabber_core_tpu_torch.inference.convergence import \
        get_detector_class as tget
    opts = {"max-iterations": "10", **extra}
    td = tget(name)(TOptions(dict(opts)))
    jd = jget(name)(JOptions(dict(opts)))
    return td, jd, int(td.max_iterations) + 2


@pytest.mark.parametrize("p", [3, 4])
@pytest.mark.parametrize("name,extra", DET_CASES,
                         ids=[c[0] for c in DET_CASES])
def test_core_plain_detector_matches_pallas_kernel(name, extra, p):
    """The detector mode (2d) at float32 against the TPU kernel run
    interpreted: per-lane iteration counts and engine-initial tags
    equal, every output within 1e-4 of its max."""
    nv = 200
    stats, pm, args, extra_c = core_inputs(p, nv, seed=7)
    td, jd, cap = det_pair(name, extra)
    conv1 = jd.init_state(1, jnp.float32)
    jcore = jfs.make_spectral_core_kernel(
        p, cap, nv, jnp.float32, block=128, interpret=True, detector=jd,
        det_consts={"sentinel": float(np.asarray(conv1.prev_f)[0]),
                    "init_save": bool(np.asarray(conv1.save)[0])})
    jsc = jfs.pack_spectral_consts(*args, jnp.float32, extra_c)
    jout = [np.asarray(x) for x in jcore(
        *(jnp.asarray(x) for x in stats), jnp.asarray(pm), jsc)]
    tsc = tfs.pack_spectral_consts(*args, torch.float32, extra_c)
    tout = [t.numpy() for t in tfs.spectral_core_plain(
        *design_stats_from_numpy(stats), torch.from_numpy(pm), tsc, cap,
        td)]
    np.testing.assert_array_equal(tout[6], jout[6])          # its
    np.testing.assert_array_equal(tout[3] < 0, jout[3] < 0)  # initial tag
    names = ["means", "prec", "cov", "b", "c", "F", "its"]
    for name_, j, t in zip(names, jout, tout):
        assert t.shape == j.shape, name_
        assert rel(t, j) <= 1e-4, name_


@pytest.mark.parametrize("name,extra", DET_CASES,
                         ids=[c[0] for c in DET_CASES])
def test_core_plain_detector_f64_matches_spectral_detector_loop(name,
                                                                extra):
    """At float64 the detector mode equals the JAX XLA eigenbasis loop
    under the same detector (ops/spectral.py
    make_spectral_detector_loop): iteration counts and initial-state
    flags equal, the selected posterior to 1e-9."""
    p, nv = 3, 96
    stats, pm, args, extra_c = core_inputs(p, nv, seed=9)
    d, q, nt, pp, inv_b0, c_post, b_init, c_init = args
    stats64 = [s.astype(np.float64) for s in stats]
    pm64 = pm.astype(np.float64)
    td, jd, cap = det_pair(name, extra)
    loop = jspec.make_spectral_detector_loop(
        d, q, pp, jd, cap, b_init, c_init, inv_b0=inv_b0, c_post=c_post,
        b0=1.0 / inv_b0, c0=1e-6, dtype=jnp.float64)
    jmeans, jprec, jcov, jb, jsel, jconv = loop(
        *(jnp.asarray(x) for x in stats64), jnp.asarray(pm64),
        jd.init_state(nv, jnp.float64))
    tsc = tfs.pack_spectral_consts(*args, torch.float64, extra_c)
    tout = tfs.spectral_core_plain(*(torch.from_numpy(x) for x in stats64),
                                   torch.from_numpy(pm64), tsc, cap, td)
    np.testing.assert_array_equal(tout[6][0].numpy().astype(np.int32),
                                  np.asarray(jconv.its))
    sel = np.asarray(jsel)
    np.testing.assert_array_equal(tout[3][0].numpy() < 0, sel)
    keep = ~sel          # initial-state lanes are the engine's to fill
    tout = list(tout[:3]) + [tout[3].abs()]      # b without its tag
    for j, t in zip((jmeans, jprec, jcov, jb), tout):
        j = np.asarray(j)[..., keep]
        t = t.numpy()[..., keep]
        np.testing.assert_allclose(t, j, rtol=1e-9,
                                   atol=1e-9 * np.abs(j).max())


def test_pack_consts_match_jax_layout():
    """The port's constant vectors are the JAX blocks without the
    ROWS (8x) replication and the MXU padding."""
    p, nt = 3, 30
    d, q, _ = make_case(p, nt, 8, masked=True)
    args = (d, q, nt, np.full(p, 1e-12), 1e-6, 14.5, 1e-8, 50.0)
    jsc = np.asarray(jfs.pack_spectral_consts(*args, jnp.float64, (1.0, 2.0)))
    tsc = tfs.pack_spectral_consts(*args, torch.float64, (1.0, 2.0))
    np.testing.assert_array_equal(tsc.numpy(), jsc[::8, 0])
    jac = np.asarray(jfs.pack_solve_consts(d, q, nt, jnp.float64))
    np.testing.assert_array_equal(
        tfs.pack_solve_consts(d, q, nt, torch.float64).numpy(), jac[::8, 0])
    dw8, dcol, q8, _ = (np.asarray(x) if not isinstance(x, int) else x
                        for x in jfs.pack_mxu_consts(d, q, nt, jnp.float64))
    tc = tfs.pack_mxu_consts(d, q, nt, torch.float64).numpy()
    np.testing.assert_array_equal(tc[:p], dcol[:nt, :p].T)
    np.testing.assert_array_equal(tc[p:2 * p], dw8[:p, :nt])
    np.testing.assert_array_equal(tc[2 * p], q8[0, :nt])


def test_wrappers_on_cpu_run_the_plain_versions():
    p, nt, nv = 3, 30, 64
    d, q, data = make_case(p, nt, nv, masked=False)
    tc, ac = port_consts(d, q, nt, torch.float32)
    x = torch.from_numpy(data)
    tfs.spectral_stats.launches = 0
    tfs.spectral_core.launches = 0
    stats = tfs.spectral_stats(x, tc, ac)
    for a, b in zip(stats, tfs.spectral_stats_plain(x, tc, ac)):
        assert torch.equal(a, b)
    sc = tfs.pack_spectral_consts(d, q, nt, np.full(p, 1e-12), 1e-6, 14.5,
                                  1e-8, 50.0, torch.float32)
    pm = torch.zeros((p, nv))
    for a, b in zip(tfs.spectral_core(*stats, pm, sc, 4),
                    tfs.spectral_core_plain(*stats, pm, sc, 4)):
        assert torch.equal(a, b)
    assert tfs.spectral_stats.launches == 0
    assert tfs.spectral_core.launches == 0


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card has no
    kernel: the wrappers raise instead of falling back."""
    p, nt, nv = 3, 30, 16
    d, q, _ = make_case(p, nt, nv, masked=False)
    tc, ac = port_consts(d, q, nt, torch.float32)
    data = torch.empty((nt, nv), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfs.spectral_stats(data, tc, ac)
    sc = tfs.pack_spectral_consts(d, q, nt, np.full(p, 1e-12), 1e-6, 14.5,
                                  1e-8, 50.0, torch.float32)
    m = torch.empty((p, nv), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfs.spectral_core(m, m[:1], m, m, sc, 3)
    with pytest.raises(ValueError, match="n_iters"):
        tfs.spectral_core(m, m[:1], m, m, sc, 0)


def test_kernel_argument_checks():
    """What the CUDA wrappers check before a launch (device, float32,
    shape, contiguity, host constants), exercised on CPU tensors."""
    dev = torch.device("cpu")
    good = torch.zeros((3, 8))
    tfs._check(good, "x", (3, 8), dev)
    with pytest.raises(TypeError):
        tfs._check(good.double(), "x", (3, 8), dev)
    with pytest.raises(ValueError, match="shape"):
        tfs._check(good, "x", (3, 9), dev)
    with pytest.raises(ValueError, match="contiguous"):
        tfs._check(torch.zeros((8, 3)).t(), "x", (3, 8), dev)
    with pytest.raises(ValueError, match="is on"):
        tfs._check(torch.empty((3, 8), device="meta"), "x", (3, 8), dev)
    tfs._check_host(torch.zeros(9), "a", 9)
    with pytest.raises(ValueError, match="host"):
        tfs._check_host(torch.zeros(9, device="meta"), "a", 9)
    with pytest.raises(ValueError):
        tfs._check_host(torch.zeros(8), "a", 9)


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FabberError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(FabberError):
        resolve_device("meta")


# -- kernel 1 compiled as host C++ (tests/torch_hostcc.py) ------------------

@pytest.fixture(scope="module")
def stats_host(tmp_path_factory):
    """(P, double) -> kernel 1 on the host, both forms (built once per
    module; skipped without g++)."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    libs = {}

    def get(p, double):
        if (p, double) not in libs:
            libs[p, double] = torch_hostcc.stats_kernel_fn(
                p, tmp_path_factory.mktemp(f"stats{p}{int(double)}"), double)
        return libs[p, double]
    return get


# (V, offset of the plane in its buffer, VB): V mod 4 = 0, 2, 1, 3, 0,
# so the tile's rows rotate by a fixed offset, two offsets in turn, and
# every offset in turn; every last block ragged but the first case's;
# VB 96 is not a power of two
STATS_PLANES = [(64, 0, 32), (70, 1, 32), (61, 2, 64), (75, 3, 32),
                (200, 1, 96)]
STATS_PLANE_IDS = [f"v{v}-off{o}-vb{vb}" for v, o, vb in STATS_PLANES]


@pytest.mark.parametrize("plane", STATS_PLANES, ids=STATS_PLANE_IDS)
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("p", [3, 4])
def test_stats_kernel_on_host_staged_equals_streamed_f64(p, masked, plane,
                                                        stats_host):
    """Kernel 1's staged form (the block's tile and rows in shared
    memory) equals its streamed form bit for bit at double, and both
    match the plain version at float64: rtqr and D'Qy = dtqr + A m0
    within 1e-12 of their max, m0 within 1e-12 on the synthetic P=4
    design and 1e-9 on the poly cubic, whose Gram (cond ~1e9 at T=106)
    scales two orders of float64 rounding into it."""
    nt = 106
    nv, offset, vb = plane
    d, q, data = make_case(p, nt, nv, masked)
    tc, ac = port_consts(d, q, nt, torch.float64)
    fn = stats_host(p, True)
    staged = fn(True, data, tc.numpy(), ac.numpy(), vb, offset)
    streamed = fn(False, data, tc.numpy(), ac.numpy())
    for a, b in zip(staged, streamed):
        assert np.array_equal(a, b)
    m0, rtqr, dtqr = to_numpy(tfs.spectral_stats_plain(
        torch.from_numpy(data.astype(np.float64)), tc, ac))
    a = ac.numpy().reshape(p, p)
    assert rel(staged[0], m0) <= (1e-9 if p == 3 else 1e-12)
    assert rel(staged[1], rtqr) <= 1e-12
    assert rel(staged[2] + a @ staged[0], dtqr + a @ m0) <= 1e-12


@pytest.mark.parametrize("plane", STATS_PLANES, ids=STATS_PLANE_IDS)
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("p", [3, 4])
def test_stats_kernel_on_host_staged_equals_streamed_f32(p, masked, plane,
                                                        stats_host):
    """At float32 (the card's rounding: fmaf fused, the rest apart) the
    two forms agree bit for bit, and both meet the plain float32
    version's bounds of the module docstring (m0 1e-3, rtqr 1e-4,
    D'Qy 1e-5)."""
    nt = 106
    nv, offset, vb = plane
    d, q, data = make_case(p, nt, nv, masked, seed=1)
    tc, ac = port_consts(d, q, nt, torch.float32)
    fn = stats_host(p, False)
    staged = fn(True, data, tc.numpy(), ac.numpy(), vb, offset)
    streamed = fn(False, data, tc.numpy(), ac.numpy())
    for a, b in zip(staged, streamed):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    m0, rtqr, dtqr = to_numpy(tfs.spectral_stats_plain(
        torch.from_numpy(data), tc, ac))
    a = ac.double().reshape(p, p).numpy()
    km0 = staged[0].astype(np.float64)
    assert rel(km0, m0) <= 1e-3
    assert rel(staged[1], rtqr) <= 1e-4
    assert rel(staged[2] + a @ km0, dtqr + a @ m0) <= 1e-5


# -- kernels 2 and 3 compiled as host C++ (tests/torch_hostcc.py) -----------

@pytest.fixture(scope="module")
def spectral_host(tmp_path_factory):
    """(name, P, double) -> kernel 2 ("core", every detector instance),
    the two-phase form of its trialmode instance that probes/csrc/
    core_compact.cu keeps ("two_phase") or kernel 3 ("fused", both forms
    too) on the host (built once per module; skipped without g++)."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    build = {"core": torch_hostcc.core_kernel_fn,
             "two_phase": torch_hostcc.core_two_phase_fn,
             "fused": torch_hostcc.fused_kernel_fn}
    libs = {}

    def get(name, p, double):
        key = (name, p, double)
        if key not in libs:
            libs[key] = build[name](p, tmp_path_factory.mktemp(
                f"{name}{p}{int(double)}"), double)
        return libs[key]
    return get


KINDS = ["maxits", "pointzeroone", "freduce", "trialmode"]


def host_detector(kind):
    """(detector or None, the launch's detector arguments, loop bound) of
    a run at max-iterations 10 (trialmode: max-trials 3)."""
    from fabber_core_tpu_torch.ops import _cuda
    if kind == "maxits":
        return None, _cuda.detector_args(None), 10
    extra = {"max-trials": "3"} if kind == "trialmode" else {}
    td, _, cap = det_pair(kind, extra)
    return td, _cuda.detector_args(td), cap


def host_consts(p, d, q, nt, dtype):
    c_post = (q.sum() - 1) * 0.5 + 1e-6
    extra = (jspec.eigen_elbo_const(q, c_post, 1e-6, 1e6, p), c_post + 0.5)
    return tfs.pack_spectral_consts(d, q, nt, np.full(p, 1e-6), 1e-6,
                                    c_post, 1e-8, 50.0, dtype, extra)


# (V, offset of the plane in its buffer, VB): aligned, then ragged last
# blocks on planes 1-3 floats off 16-byte alignment
FUSED_PLANES = [(64, 0, 32), (70, 1, 32), (61, 2, 64), (75, 3, 32)]
FUSED_PLANE_IDS = [f"v{v}-off{o}-vb{vb}" for v, o, vb in FUSED_PLANES]


@pytest.mark.parametrize("plane", FUSED_PLANES, ids=FUSED_PLANE_IDS)
@pytest.mark.parametrize("double", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", [3, 4])
def test_fused_kernel_on_host_equals_split_pair(p, kind, double, plane,
                                                stats_host, spectral_host):
    """Kernel 3 staged (the block's lanes as threads meeting at the
    staging barrier) == kernel 3 streamed == kernel 1 staged followed by
    kernel 2, every output bit for bit, at double and at float32 (the
    card's rounding), in maxits and each detector instance; at double
    also the plain version at float64 within 1e-9 of each output's max,
    its iteration counts and engine-initial tags identical."""
    nt = 106
    nv, offset, vb = plane
    dt = torch.float64 if double else torch.float32
    d, q, data = make_case(p, nt, nv, masked=True, seed=2)
    tc, ac = port_consts(d, q, nt, dt)
    sc = host_consts(p, d, q, nt, dt)
    pm = np.random.default_rng(nv).uniform(-1, 1, (p, nv))
    det, dargs, n_it = host_detector(kind)
    k3 = spectral_host("fused", p, double)
    args = (tc.numpy(), ac.numpy(), pm, sc.numpy(), n_it, dargs)
    staged = k3(True, data, *args, vb, offset)
    streamed = k3(False, data, *args)
    stats = stats_host(p, double)(True, data, tc.numpy(), ac.numpy(), vb,
                                  offset)
    split = spectral_host("core", p, double)(*stats, pm, sc.numpy(), n_it,
                                             dargs)
    for a, b, c in zip(staged, streamed, split):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    if double:
        ref = [r.numpy() for r in tfs.spectral_fused_plain(
            torch.from_numpy(data.astype(np.float64)), tc, ac,
            torch.from_numpy(pm), sc, n_it, det)]
        if det is not None:
            np.testing.assert_array_equal(staged[6], ref[6])
            np.testing.assert_array_equal(staged[3] < 0, ref[3] < 0)
        for a, r in zip(staged, ref):
            assert rel(a, r) <= 1e-9


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("p", [3, 4])
def test_core_kernel_on_host_matches_plain_f64(p, kind, spectral_host):
    """Kernel 2's instance for each detector (maxits and the three F
    detectors, each compiled alone: detectors.cuh det_test_kind) at
    double against its plain version at float64: iteration counts and
    engine-initial tags identical, every output within 1e-9 of its
    max."""
    nt, nv = 106, 200
    d, q, data = make_case(p, nt, nv, masked=False, seed=4)
    tc, ac = port_consts(d, q, nt, torch.float64)
    stats = tfs.spectral_stats_plain(torch.from_numpy(
        data.astype(np.float64)), tc, ac)
    sc = host_consts(p, d, q, nt, torch.float64)
    pm = torch.from_numpy(np.random.default_rng(p).uniform(-1, 1, (p, nv)))
    det, dargs, n_it = host_detector(kind)
    k = spectral_host("core", p, True)(*(s.numpy() for s in stats),
                                       pm.numpy(), sc.numpy(), n_it, dargs)
    ref = [r.numpy() for r in tfs.spectral_core_plain(*stats, pm, sc, n_it,
                                                      det)]
    if det is not None:
        np.testing.assert_array_equal(k[6], ref[6])
        np.testing.assert_array_equal(k[3] < 0, ref[3] < 0)
        assert len(np.unique(k[6])) > 1      # lanes stop apart
    for a, r in zip(k, ref):
        assert a.shape == r.shape
        assert rel(a, r) <= 1e-9


@pytest.mark.parametrize("double", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("trials", ["3", "10"])
@pytest.mark.parametrize("p", [3, 4])
def test_core_kernel_on_host_two_phase_equals_one_phase(p, trials, double,
                                                        spectral_host):
    """Kernel 2's two-phase trialmode form (the probe's patched copy
    probes/csrc/core_compact.cu: phase 1 to a fixed number of trips, the
    unfinished lanes appended to the compact buffer by their warp's
    atomicAdd, phase 2 over them) equals its one launch bit for bit, at double and at float32, on lanes that stop within 8 trips and
    lanes that enter their trials and run to 10-17 (its count reset to
    1), so both phases write outputs."""
    from fabber_core_tpu_torch.ops import _cuda
    nt, nv = 106, 400
    dt = torch.float64 if double else torch.float32
    d, q, data = make_case(p, nt, nv, masked=False, seed=4)
    tc, ac = port_consts(d, q, nt, dt)
    stats = [s.numpy() for s in tfs.spectral_stats_plain(
        torch.from_numpy(data.astype(np.float64 if double else np.float32)),
        tc, ac)]
    sc = host_consts(p, d, q, nt, dt).numpy()
    pm = np.random.default_rng(p).uniform(-1, 1, (p, nv))
    td, _, cap = det_pair("trialmode", {"max-trials": trials})
    one = spectral_host("core", p, double)(*stats, pm, sc, cap,
                                           _cuda.detector_args(td))
    two = spectral_host("two_phase", p, double)(*stats, pm, sc, cap,
                                                _cuda.detector_args(td))
    assert (one[6] == 1).any() and (one[6] > 1).any()
    for a, b in zip(one, two):
        assert np.array_equal(a, b)
