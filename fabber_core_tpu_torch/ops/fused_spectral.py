"""Whole-program spectral route: the statistics kernel, the
eigenbasis core kernel and the one-kernel form, each with its
plain-torch version.

Port of fabber_core_tpu/ops/fused_spectral.py, split and fused forms.
Three hand-written CUDA kernels for Hopper (csrc/spectral_stats.cu,
csrc/spectral_core.cu, csrc/spectral_fused.cu; their per-voxel bodies
are csrc/spectral_device.cuh) carry the route:

  spectral_stats  reads the [T,V] data once (its staged form: each
                  block's [T, VB] tile copied into shared memory in
                  16-byte chunks; the streamed form reads the plane in
                  both passes) and
                  writes the single-group sufficient statistics m0 [P,V],
                  rtqr [1,V], dtqr [P,V] (replaces
                  make_spectral_stats_kernel);
  spectral_core   rotates them into the whitened design eigenbasis,
                  runs the n_iters-1 scalar-rational noise updates and
                  rebuilds means [P,V], prec/cov [P,P,V] and the noise
                  b, c, the per-voxel free energy F and tr [1,V]
                  (replaces make_spectral_core_kernel, maxits mode); in
                  detector mode (pointzeroone / freduce / trialmode) it
                  runs each lane's state machine inside the loop with
                  the engine's save/revert on the generating phi, and
                  writes the lane's iteration count in place of tr and
                  a minus sign on b where the selected state is the
                  engine-initial posterior;
  spectral_fused  both in one thread (replaces make_fused_spectral_loop,
                  spectral-impl=fused; staged as spectral_stats is, or
                  streamed): the statistics stay in registers, the
                  outputs are spectral_core's, in both modes; its plain
                  version is the plain statistics followed by the plain
                  core.

Each wrapper takes its plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. Each keeps an integer
``launches`` count of kernel launches (never of plain calls);
spectral_core and spectral_fused also count their detector-mode
launches in ``det_launches``, spectral_stats and spectral_fused their
staged ones in ``staged_launches``; all three their launches of a
per-shape instance (P > PREBUILT_MAX_P) in ``instance_launches``.

Constant layout (host-built in float64, cast once):
  pack_mxu_consts     [2P+1, T] device rows: raw design D (P rows),
                      mask-weighted design DW = D*q (P rows), q (1 row)
  pack_solve_consts   [P*P] host vector, A = D'QD (f64 -> f32: the
                      in-kernel Cholesky sees the rounding the stats
                      see, fused_spectral.py:39-41 of the JAX package)
  pack_spectral_consts [4P^2+2P+6] host vector: A, E'W, E'W^-1, WE,
                      lam, pp, then 1/b0, c_post, b_init, c_init,
                      f_const, lb_coeff (same order as the JAX block)
The TPU forms' ROWS-replicated [K*8,1] columns, the K=8 MXU operand
padding and the 128-padded time axis existed only for Mosaic and are
gone. The host vectors ride into the kernels as by-value parameters
(constant memory), so they stay on the CPU.
"""

import numpy as np
import torch

from . import smallmat as sm
from .spectral import spectral_basis

# The largest P of the prebuilt library's instances (template<int P>,
# P = 1..8), and the largest P the kernels serve: P 9..25 are per-shape
# instances (ops/_cuda.py build_instance, built at their first launch),
# 25 the largest P the JAX engine's spectral gate admits at any T
# (pick_spectral_block below). The engine's route gate enforces MAX_P.
PREBUILT_MAX_P = 8
MAX_P = 25


def _design_q(design, qmask, nt):
    d = np.asarray(design, np.float64)[:nt]
    q = np.asarray(qmask, np.float64).reshape(-1)[:nt]
    return d, q


def pack_mxu_consts(design, qmask, nt, dtype, device="cpu"):
    """[2P+1, T] per-timepoint rows for the stats kernel: D' (P rows),
    (D*q)' (P rows), q (1 row)."""
    d, q = _design_q(design, qmask, nt)
    rows = np.concatenate([d.T, (d * q[:, None]).T, q[None, :]])
    return torch.as_tensor(np.ascontiguousarray(rows), dtype=dtype,
                           device=device)


def pack_solve_consts(design, qmask, nt, dtype):
    """[P*P] host vector A = D'QD for the in-kernel m0 solve."""
    d, q = _design_q(design, qmask, nt)
    a = (d * q[:, None]).T @ d
    return torch.as_tensor(a.reshape(-1), dtype=dtype)


def pack_spectral_consts(design, qmask, nt, pp, inv_b0, c_post,
                         init_b, init_c, dtype, elbo_extra=(0.0, 0.0)):
    """[4P^2+2P+6] host vector of the core kernel's scalar constants:
    A (P*P), etw / etwi / ew (P*P each), lam (P), pp (P), then inv_b0,
    c_post, b_init, c_init, then the eigenbasis-ELBO constant pair
    (f_const, lb_coeff) for the in-kernel F output."""
    d, q = _design_q(design, qmask, nt)
    a, lam, ew, winv = spectral_basis(d, q, pp)
    e = ew / winv[:, None]
    etw = ew.T                       # applies E' W
    etwi = (e / winv[:, None]).T     # applies E' W^-1
    flat = np.concatenate([
        a.reshape(-1), etw.reshape(-1), etwi.reshape(-1), ew.reshape(-1),
        lam, np.asarray(pp, np.float64).reshape(-1),
        [float(inv_b0), float(c_post), float(init_b), float(init_c)],
        list(elbo_extra)])
    return torch.as_tensor(flat, dtype=dtype)


def core_floats(p):
    """Length of pack_spectral_consts' vector at P."""
    return 4 * p * p + 2 * p + 6


def wide_extra(p, fused=False):
    """Shared floats a per-shape instance (P > PREBUILT_MAX_P) keeps after
    the design rows: the block's factor of A (P*P; kernels 1 and 3) and,
    in kernel 3, the core constants (csrc/spectral_stats.cu,
    spectral_fused.cu)."""
    if p <= PREBUILT_MAX_P:
        return 0
    return p * p + (core_floats(p) if fused else 0)


def spectral_smem(p, nt):
    """Shared memory of kernel 3's streamed form at (P, T), the most a
    block of kernels 1-3 needs beside a data tile: the (2P+1) x T design
    rows and wide_extra. The engine's gate asks that it fit a block."""
    return 4 * ((2 * p + 1) * nt + wide_extra(p, fused=True))


# The JAX engine's spectral gate on a TPU (fabber_core_tpu/ops/
# fused_spectral.py n_spectral_planes, pick_spectral_block,
# pick_core_block; the port's own copy), asked with the gate's 1,024
# voxels: whether a [8, B/8]-plane tile of B voxels fits its VMEM budget.
# The port's route gate takes from them only where the JAX engine stops
# running its kernels (the caps, and route parity in the tests); the
# card's own limit is shared memory (spectral_smem).
VMEM_BUDGET = 8 << 20


def n_spectral_planes(p, nt, det=False):
    """Live [8, B/8]-plane estimate of the JAX one-kernel spectral
    form: the data tile 4x, then the stats, eigen rows, loop carry and
    outputs; det adds the detector lanes and the best-state pair."""
    return (4 * nt + p + 3 * p + 1 + 4 * p + 2 + p + 2 * p * p + 4
            + ((9 + 4 + 4) if det else 0))


def pick_spectral_block(nvoxels, p, nt, det=False):
    """The JAX engine's tile for its spectral-whole gate: None where no
    tile fits (then it takes another route)."""
    planes = n_spectral_planes(p, nt, det)
    budget = max(VMEM_BUDGET, 12 << 20)
    fitting = [bb for bb in (8192, 4096, 2048, 1024)
               if planes * bb * 4 * 2 <= budget]
    if not fitting:
        return None
    for bb in fitting:
        if nvoxels % bb == 0:
            return bb, 0
    return fitting[-1], (-nvoxels) % fitting[-1]


def pick_core_block(nvoxels, p, det=False):
    """The JAX engine's core-kernel tile (its split and xstats forms):
    None where none fits, which its gate does not ask (P 21-25 pass the
    gate at short T and then fail; ROADMAP Queue 3)."""
    planes = 10 * p + 2 * p * p + 12 + ((9 + 4) if det else 0)
    fitting = [bb for bb in (16384, 8192, 4096, 2048, 1024)
               if planes * bb * 4 * 2 <= VMEM_BUDGET]
    if not fitting:
        return None
    return fitting[0], (-nvoxels) % 1024


def jax_spectral_cap(det=False):
    """The largest P the JAX spectral gate admits at any T (at T = 1, where
    the data tile is least): 25."""
    return max(p for p in range(1, 64)
               if pick_spectral_block(1024, p, 1, det) is not None)


def _nparams_from_solve(aconsts):
    p = int(round(aconsts.numel() ** 0.5))
    if p * p != aconsts.numel():
        raise ValueError(f"aconsts has {aconsts.numel()} entries, not P*P")
    return p


def _nparams_from_core(consts):
    n = consts.numel()
    for p in range(1, 64):
        if core_floats(p) == n:
            return p
    raise ValueError(f"consts has {n} entries, not 4P^2+2P+6")


# ---------------------------------------------------------------------------
# Plain versions: dtype-generic, any P, any device. The CPU path of the
# wrappers and the reference each kernel is held against on the card.
# ---------------------------------------------------------------------------

def spectral_stats_plain(data, tconsts, aconsts):
    """Plain torch: data [T,V], tconsts [2P+1,T], aconsts [P*P] ->
    (m0 [P,V], rtqr [1,V], dtqr [P,V]) in data's dtype."""
    p = _nparams_from_solve(aconsts)
    dt, dev = data.dtype, data.device
    tc = tconsts.to(device=dev, dtype=dt)
    dcol, dw, q = tc[:p], tc[p:2 * p], tc[2 * p:]
    dty = dw @ data                                          # [P,V]
    a = aconsts.to(device=dev, dtype=dt).reshape(p, p, 1)
    m0 = sm.solve_chol_vec(sm.cholesky_planes(a), dty)
    ok = torch.all(torch.isfinite(m0), dim=0)
    m0 = torch.where(ok, m0, torch.zeros_like(m0))
    r0 = data - dcol.T @ m0                                  # [T,V]
    rtqr = q @ (r0 * r0)                                     # [1,V]
    dtqr = dw @ r0
    return m0, rtqr, dtqr


def spectral_core_plain(m0, rtqr, dtqr, pm, consts, n_iters, detector=None):
    """Plain torch, same algebra and operation order as the kernel:
    m0/dtqr/pm [P,V], rtqr [1,V], consts [4P^2+2P+6] ->
    (means [P,V], prec [P,P,V], cov [P,P,V], b, c, f, tr [1,V]).

    detector: a pointzeroone / freduce / trialmode detector object
    (inference/convergence.py) for the detector mode of
    _spectral_core (fused_spectral.py:238-315 of the JAX package):
    n_iters is then the loop bound (the engine's max_iterations + 2),
    the last output is the lane's iteration count and b carries a minus
    sign where the selected state is the engine-initial posterior."""
    p = _nparams_from_core(consts)
    k = consts.to(m0.dtype).tolist()      # values rounded to the dtype

    def A(i, j):
        return k[i * p + j]

    def ETW(i, a):
        return k[p * p + i * p + a]

    def ETWI(i, a):
        return k[2 * p * p + i * p + a]

    def EW(a, i):
        return k[3 * p * p + a * p + i]

    lam = k[4 * p * p:4 * p * p + p]
    pp = k[4 * p * p + p:4 * p * p + 2 * p]
    inv_b0, c_post, b_init, c_init, f_const, lb_coeff = k[4 * p * p + 2 * p:]

    m0 = list(m0)
    dtqr = list(dtqr)
    pm = list(pm)
    rtqr = rtqr[0]
    dtqy = [dtqr[a] + sum(A(a, j) * m0[j] for j in range(p))
            for a in range(p)]
    ut = [sum(ETW(i, a) * dtqy[a] for a in range(p)) for i in range(p)]
    u0t = [sum(ETW(i, a) * dtqr[a] for a in range(p)) for i in range(p)]
    vt = [sum(ETW(i, a) * (pp[a] * pm[a]) for a in range(p))
          for i in range(p)]
    m0t = [sum(ETWI(i, a) * m0[a] for a in range(p)) for i in range(p)]

    def quadratics(s):
        cross = quad = tr = 0.0
        mt, rden = [], []
        for i in range(p):
            rd = 1.0 / (s * lam[i] + 1.0)
            mt_i = (s * ut[i] + vt[i]) * rd
            d_ = mt_i - m0t[i]
            cross = cross + d_ * u0t[i]
            quad = quad + lam[i] * d_ * d_
            tr = tr + lam[i] * rd
            mt.append(mt_i)
            rden.append(rd)
        return mt, cross, quad, tr, rden

    def elbo(s):
        """F at the posterior generated by s and its noise b."""
        mt, cross, quad, tr, rden = quadratics(s)
        kqk = torch.clamp(rtqr - 2.0 * cross + quad, min=0.0)
        b = 1.0 / ((kqk + tr) * 0.5 + inv_b0)
        logden = rdensum = mv2 = 0.0
        for i in range(p):
            logden = logden + torch.log(s * lam[i] + 1.0)
            rdensum = rdensum + rden[i]
            mv2 = mv2 + (mt[i] - vt[i]) ** 2
        f = (f_const - 0.5 * logden + lb_coeff * torch.log(b)
             - b * c_post * (inv_b0 + 0.5 * kqk)
             - 0.5 * tr - 0.5 * mv2 - 0.5 * rdensum)
        return f, b, tr

    s = torch.full_like(rtqr, b_init) * c_init     # s0, rounded as b*c
    if detector is None:
        for _ in range(n_iters - 1):
            _, cross, quad, tr, _ = quadratics(s)
            kqk = torch.clamp(rtqr - 2.0 * cross + quad, min=0.0)
            s = 1.0 / ((kqk + tr) * 0.5 + inv_b0) * c_post
    else:
        s, sel_init, its = _detector_loop(detector, n_iters, s, elbo,
                                          c_post)

    # reconstruction from the phi that generated the last (selected)
    # posterior
    mt, cross, quad, tr, rden = quadratics(s)
    f, b, tr = elbo(s)
    means = torch.stack([sum(EW(a, i) * mt[i] for i in range(p))
                         for a in range(p)])
    cov = torch.stack([torch.stack([
        sum(EW(i, kk) * EW(j, kk) * rden[kk] for kk in range(p))
        for j in range(p)]) for i in range(p)])
    prec = torch.stack([torch.stack([
        s * A(i, j) + (pp[i] if i == j else 0.0)
        for j in range(p)]) for i in range(p)])
    c = torch.full_like(b, c_post)
    if detector is not None:
        b = torch.where(sel_init, -b, b)
        tr = its.to(b.dtype)
    return (means, prec, cov, b[None], c[None], f[None], tr[None])


def _detector_loop(detector, n_iters, s0, elbo, c_post):
    """The detector mode's loop on the scalar pair (current phi,
    generating phi) with the engine's best-save, freeze and finalize:
    -> (selected phi, selected-state-is-initial flag, iteration count)."""
    nv = s0.shape[0]
    conv = detector.init_state(nv, s0.dtype, device=s0.device)
    cur_s, gen_s, best_s = s0, s0, s0
    is_init = torch.ones(nv, dtype=torch.bool, device=s0.device)
    best_init = is_init
    it = 0
    while it < n_iters and not bool(conv.done.all()):
        # 1. best-save where flagged
        best_s = torch.where(conv.save, gen_s, best_s)
        best_init = torch.where(conv.save, is_init, best_init)
        # 2-4. the update generated by cur_s, its noise, its F, the test
        g = cur_s
        f, b_new, _ = elbo(g)
        new = detector.test(conv, f)
        # 5. lanes done before this iteration keep their state
        act = ~conv.done
        conv = type(conv)(*(torch.where(act, n, o)
                            for n, o in zip(new, conv)))
        cur_s = torch.where(act, b_new * c_post, cur_s)
        gen_s = torch.where(act, g, gen_s)
        is_init = is_init & ~act
        it += 1
    # the engine's finalize: best-save, then revert
    best_s = torch.where(conv.save, gen_s, best_s)
    best_init = torch.where(conv.save, is_init, best_init)
    s = torch.where(conv.revert, best_s, gen_s)
    sel_init = torch.where(conv.revert, best_init, is_init)
    return s, sel_init, conv.its


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(t, name, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_host(t, name, n):
    if t.device.type != "cpu":
        raise ValueError(f"{name} must be a host tensor: it is passed to "
                         "the kernel by value")
    if t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{name} must be {n} contiguous float32 values")


def _cuda_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return t.device


def spectral_stats(data, tconsts, aconsts, _vb=None):
    """One-read single-group statistics: data [T,V], tconsts [2P+1,T]
    (pack_mxu_consts), aconsts [P*P] host (pack_solve_consts) ->
    (m0 [P,V], rtqr [1,V], dtqr [P,V]). _vb: private, for the tests and
    chip_smoke.py: forces the kernel's form (0 streamed, > 0 staged in
    blocks of that many lanes; ops/_cuda.py launch_vb)."""
    if data.device.type == "cpu":
        return spectral_stats_plain(data, tconsts, aconsts)
    dev = _cuda_device(data)
    p = _nparams_from_solve(aconsts)
    if not 1 <= p <= MAX_P:
        raise ValueError(f"P={p} outside the kernel's 1..{MAX_P}")
    nt, nv = data.shape
    _check(data, "data", (nt, nv), dev)
    _check(tconsts, "tconsts", (2 * p + 1, nt), dev)
    _check_host(aconsts, "aconsts", p * p)
    m0 = torch.empty((p, nv), dtype=torch.float32, device=dev)
    rtqr = torch.empty((1, nv), dtype=torch.float32, device=dev)
    dtqr = torch.empty((p, nv), dtype=torch.float32, device=dev)
    if nv:
        from . import _cuda
        vb = _cuda.launch_vb(nt, 2 * p + 1, _vb, _cuda.STATS_WIDTHS,
                             wide_extra(p))
        if _cuda.launch_stats(p, data, tconsts, aconsts, m0, rtqr, dtqr, vb):
            spectral_stats.instance_launches += 1
        spectral_stats.launches += 1
        if vb > 0:
            spectral_stats.staged_launches += 1
    return m0, rtqr, dtqr


spectral_stats.launches = 0
spectral_stats.staged_launches = 0
spectral_stats.instance_launches = 0


DETECTOR_KINDS = ("pointzeroone", "freduce", "trialmode")


def spectral_core(m0, rtqr, dtqr, pm, consts, n_iters, detector=None):
    """Eigenbasis fixed point + posterior reconstruction: m0/dtqr/pm
    [P,V], rtqr [1,V], consts [4P^2+2P+6] host (pack_spectral_consts)
    -> (means [P,V], prec [P,P,V], cov [P,P,V], b [1,V], c [1,V],
    F [1,V], tr [1,V]); with a detector (one of DETECTOR_KINDS) the
    detector mode of spectral_core_plain."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    if detector is not None and type(detector).name not in DETECTOR_KINDS:
        raise ValueError(f"no detector mode for '{type(detector).name}'")
    if m0.device.type == "cpu":
        return spectral_core_plain(m0, rtqr, dtqr, pm, consts, n_iters,
                                   detector)
    dev = _cuda_device(m0)
    p = _nparams_from_core(consts)
    if not 1 <= p <= MAX_P:
        raise ValueError(f"P={p} outside the kernel's 1..{MAX_P}")
    nv = m0.shape[-1]
    for t, name, shape in ((m0, "m0", (p, nv)), (rtqr, "rtqr", (1, nv)),
                           (dtqr, "dtqr", (p, nv)), (pm, "pm", (p, nv))):
        _check(t, name, shape, dev)
    _check_host(consts, "consts", 4 * p * p + 2 * p + 6)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (out(p, nv), out(p, p, nv), out(p, p, nv),
            out(1, nv), out(1, nv), out(1, nv), out(1, nv))
    if nv:
        from . import _cuda
        if _cuda.launch_core(p, n_iters, m0, rtqr, dtqr, pm, consts,
                             detector, outs):
            spectral_core.instance_launches += 1
        spectral_core.launches += 1
        if detector is not None:
            spectral_core.det_launches += 1
    return outs


spectral_core.launches = 0
spectral_core.det_launches = 0
spectral_core.instance_launches = 0


def spectral_fused_plain(data, tconsts, aconsts, pm, consts, n_iters,
                         detector=None):
    """Plain torch: spectral_stats_plain, then spectral_core_plain."""
    m0, rtqr, dtqr = spectral_stats_plain(data, tconsts, aconsts)
    return spectral_core_plain(m0, rtqr, dtqr, pm, consts, n_iters,
                               detector)


def fused_vb(nt, p, vb=None):
    """The vb argument of kernel 3's launch at nt samples and P = p (0
    streamed, > 0 staged in blocks of vb lanes): kernel 1's plan (ops/
    _cuda.py tile_plan at 2P + 1 rows per sample, STATS_WIDTHS), in every
    mode. A detector's lanes keep the block's tile through their loop,
    yet staged at VB 128 beat streamed and the narrower blocks under
    trialmode as in maxits on an H100 (PERF.md §6 row 3). An int vb
    forces the form."""
    from . import _cuda
    return _cuda.launch_vb(nt, 2 * p + 1, vb, _cuda.STATS_WIDTHS,
                           wide_extra(p, fused=True))


def spectral_fused(data, tconsts, aconsts, pm, consts, n_iters,
                   detector=None, _vb=None):
    """The one-kernel spectral form: data [T,V], tconsts [2P+1,T]
    (pack_mxu_consts), aconsts [P*P] host (pack_solve_consts), pm [P,V],
    consts [4P^2+2P+6] host (pack_spectral_consts) -> spectral_core's
    outputs, in maxits or (with a detector) its detector mode. _vb:
    private, for the tests and chip_smoke.py: forces the kernel's form
    (0 streamed, > 0 staged in blocks of that many lanes); by default
    fused_vb's plan."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    if detector is not None and type(detector).name not in DETECTOR_KINDS:
        raise ValueError(f"no detector mode for '{type(detector).name}'")
    if data.device.type == "cpu":
        return spectral_fused_plain(data, tconsts, aconsts, pm, consts,
                                    n_iters, detector)
    dev = _cuda_device(data)
    p = _nparams_from_core(consts)
    if not 1 <= p <= MAX_P:
        raise ValueError(f"P={p} outside the kernel's 1..{MAX_P}")
    nt, nv = data.shape
    _check(data, "data", (nt, nv), dev)
    _check(tconsts, "tconsts", (2 * p + 1, nt), dev)
    _check(pm, "pm", (p, nv), dev)
    _check_host(aconsts, "aconsts", p * p)
    _check_host(consts, "consts", 4 * p * p + 2 * p + 6)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (out(p, nv), out(p, p, nv), out(p, p, nv),
            out(1, nv), out(1, nv), out(1, nv), out(1, nv))
    if nv:
        from . import _cuda
        vb = fused_vb(nt, p, _vb)
        if _cuda.launch_spectral_fused(p, n_iters, data, tconsts, aconsts,
                                       pm, consts, detector, outs, vb):
            spectral_fused.instance_launches += 1
        spectral_fused.launches += 1
        if detector is not None:
            spectral_fused.det_launches += 1
        if vb > 0:
            spectral_fused.staged_launches += 1
    return outs


spectral_fused.launches = 0
spectral_fused.det_launches = 0
spectral_fused.staged_launches = 0
spectral_fused.instance_launches = 0
