"""Whole-loop AR(1) fixed-design kernel (kernel 9) and its plain version.

Port of fabber_core_tpu/ops/fused_loop_ar.py. With a constant design
and AR(1) noise without cross terms (noise/ar1.py, 1 or 2 interleaved
echoes), every VB iteration depends on the data only through the
statistics of Ar1NoiseModel.make_design_stats: m0 [P,V], r0'M_s r0
[S,V], D'M_s r0 [S,P,V] and the constant D'M_s D, S = 3 nq (per echo
group the basis specs (0,0), (1,0), (2,0)). The echoes are independent
AR chains: alpha_n is updated by group n alone, the alpha precision
stays diagonal, and the alpha MVN update is nq scalar planes (with one
echo alpha_2 keeps its prior). One hand-written CUDA kernel
(csrc/fused_ar_loop.cu) replaces make_fused_ar_loop: per voxel the
whole fixed point runs in registers from one read of the statistics,
and the posterior and the AR noise state are written once —

  theta: w = (phi_n, phi_n mu_n, phi_n (acov_n + mu_n^2)) per group,
      prec = sum_s w_s D'M_sD + diag(pp), the jitter-retry Cholesky,
      cov, means = cov (sum_s w_s D'M_sy + pp pm), D'M_sy = D'M_sr0 +
      D'M_sD m0;
  noise: op_s = r0'M_sr0 - 2 d'D'M_sr0 + sum_aj D'M_sD_aj (d_a d_j +
      cov_aj) (d = means - m0); aprec_n = ap_n + phi_n op_{3n+2},
      acov_n = 1/aprec_n, mu_n = -phi_n op_{3n+1} acov_n / 2; with
      tmp1_n = op_{3n} + mu_n op_{3n+1} + (acov_n + mu_n^2) op_{3n+2}:
      b_n = 1/(tmp1_n/2 + 1/b0_n), c_n = c_post_n —

the arithmetic of noise/ar1.py update_theta_stats / update_noise_stats
in the TPU kernel's order (fused_loop_ar.py:133-230), from zero alpha
means and the model-default noise. Two modes:

  maxits        the static fixed point of n_iters steps;
  detector      pointzeroone / freduce: the lane state machine of
                inference/convergence.py runs each iteration on the
                degenerate AR(1) ELBO at the new state (each group's
                part2 is its phi update's tmp1; the Gamma-function terms
                fold into the host constant f_const at c = c_post; the
                ap11 log terms cancel: fused_loop_ar.py:202-223), with
                the engine's freeze and finalize, to n_iters = the
                engine's loop cap. Neither detector ever sets its save
                flag, so a freduce revert selects the engine-initial
                posterior: those lanes come back with b < 0 (and the
                kernel's initial planes) for the engine to restore.
                Outputs f and its [1,V] follow the eight planes.

The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. ``fused_ar_loop.launches``
counts kernel launches, ``.det_launches`` those in detector mode,
``.instance_launches`` those of a per-shape instance (P > 8, ops/_cuda.py
build_instance). The
TPU form's ROWS=8 voxel fold, edge padding, sublane-replicated constant
column and VMEM block picker are not ported: the constants are one host
vector passed by value.
"""

import math

import numpy as np
import torch

from . import smallmat as sm
from .fused_loop import check_host_consts
from .fused_vb import check_plane

NSPECS = 3  # (0,0), (1,0), (2,0) per echo group: no cross terms
DETECTOR_KINDS = ("pointzeroone", "freduce")


def ar_instantiated(p, nq):
    """True when kernel 9 can run at P and nq on the card: the prebuilt
    library holds it (csrc/fused_ar_loop.cu FABBER_AR_INSTANCES: P =
    1..8, nq = 1..2; asked of the built library), or a per-shape instance
    can be built at the route's first launch (ops/_cuda.py
    build_instance: P 9..16). Nothing is built here."""
    from . import _cuda
    return (_cuda.has_ar_instance(p, nq)
            or _cuda.instance_buildable("ar", p, nq))


def n_consts(p, nq):
    return NSPECS * nq * p * p + 2 + 6 * nq


def pack_ar_consts(dmd, alpha_prior_prec, noise_prior_b, noise_prior_c,
                   ntimes, init_b, init_c, init_acov, init_aprec, nq=1):
    """[S*P*P + 2 + 6nq] float64 host vector (the JAX pack_ar_consts'
    order, without its ROWS replication): D'M_sD [S,P,P] row-major, the
    alpha prior precision's diagonal ap00, ap11 (the engine gates on the
    diagonal model-default prior), then per group 1/b0, c_post =
    (ntimes-1)/2 + c0, init_b, init_c, init_acov, init_aprec (each a
    scalar or [nq])."""
    def host(x):
        if torch.is_tensor(x):
            return x.detach().to("cpu", torch.float64).reshape(-1)
        return torch.as_tensor(np.array(x, np.float64)).reshape(-1)

    def seq(x):
        a = host(x)
        return a.expand(nq) if a.shape[0] != nq else a

    app = host(alpha_prior_prec).reshape(2, 2)
    b0, c0 = seq(noise_prior_b), seq(noise_prior_c)
    return torch.cat([host(dmd), torch.stack([app[0, 0], app[1, 1]]),
                      1.0 / b0, (float(ntimes) - 1.0) * 0.5 + c0,
                      seq(init_b), seq(init_c), seq(init_acov),
                      seq(init_aprec)])


def _unpack(consts, p, nq, dtype):
    """The constants as dtype-rounded floats: (dmd(s, i, j) accessor,
    ap [2], and per group inv_b0, c_post, init_b, init_c, init_acov,
    init_aprec lists)."""
    k = consts.to(dtype).tolist()
    base = NSPECS * nq * p * p

    def dmd(s, i, j):
        return k[(s * p + i) * p + j]

    groups = [k[base + 2 + g * nq:base + 2 + (g + 1) * nq] for g in range(6)]
    return (dmd, k[base:base + 2], *groups)


def _where(mask, new, old):
    """Per-lane select over the loop state's nested lists and tuples of
    [..., V] planes."""
    if isinstance(new, (list, tuple)):
        return type(new)(_where(mask, n, o) for n, o in zip(new, old))
    return torch.where(mask, new, old)


def _check_detector(detector):
    if detector is not None \
            and type(detector["det"]).name not in DETECTOR_KINDS:
        raise ValueError(f"the AR(1) kernel's detector mode runs "
                         f"{' and '.join(DETECTOR_KINDS)}, not "
                         f"{type(detector['det']).name}")


def fused_ar_loop_plain(m0, rmr, dmr, consts, prior_means, prior_prec,
                        n_iters, detector=None):
    """Plain torch: m0 [P,V], rmr [S,V], dmr [S,P,V] (S = 3 nq), consts
    (pack_ar_consts), prior_means/prior_prec [P,V] -> (means [P,V], prec
    [P,P,V], cov [P,P,V], amu, acov, aprec, b, c [nq,V]) and, with a
    detector, (f [1,V], its [1,V]).

    detector: {"det": a pointzeroone or freduce detector object,
    "f_const", "lb_coeff"} (VBInference._ar_fdet_consts: the host float64
    ELBO constants); n_iters is then the loop cap. b is negated on lanes
    whose selected state is the engine-initial posterior."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    _check_detector(detector)
    p, nv = m0.shape
    nq = rmr.shape[0] // NSPECS
    s_n = NSPECS * nq
    dt, dev = m0.dtype, m0.device
    (dmd, ap, inv_b0, c_post, init_b, init_c, init_acov,
     init_aprec) = _unpack(consts, p, nq, dt)
    m0 = list(m0)
    pm, pp = list(prior_means), list(prior_prec)
    rmr = list(rmr)
    dmr = [list(dmr[s]) for s in range(s_n)]
    # D'M_s y = D'M_s r0 + (D'M_s D) m0, iteration-invariant
    dmy = [[dmr[s][a] + sum(dmd(s, a, j) * m0[j] for j in range(p))
            for a in range(p)] for s in range(s_n)]
    ones = torch.ones(nv, dtype=dt, device=dev)

    def step(st):
        """One fixed-point step from the noise state st = (b, c, amu,
        acov, aprec) lists: -> (new st, means, prec, cov, chol, tmp1)."""
        bq, cq, amu, acov, _ = st
        sici = [bq[n] * cq[n] for n in range(nq)]
        w = []
        for n in range(nq):
            w += [sici[n], sici[n] * amu[n],
                  sici[n] * (acov[n] + amu[n] * amu[n])]
        rows = [[None] * p for _ in range(p)]
        for i in range(p):
            for j in range(i + 1):
                v = 0.0
                for s in range(s_n):
                    v = v + w[s] * dmd(s, i, j)
                if i == j:
                    v = v + pp[i]
                rows[i][j] = rows[j][i] = v
        prec = torch.stack([torch.stack(r) for r in rows])
        chol, _ = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        rhs = []
        for a in range(p):
            v = 0.0
            for s in range(s_n):
                v = v + w[s] * dmy[s][a]
            rhs.append(v + pp[a] * pm[a])
        means = [sum(cov[i, j] * rhs[j] for j in range(p)) for i in range(p)]

        # noise quadratics: op_s = k'M_s k + tr(cov D'M_s D)
        delta = [means[a] - m0[a] for a in range(p)]
        op = []
        for s in range(s_n):
            cross = sum(delta[a] * dmr[s][a] for a in range(p))
            acc = rmr[s] - 2.0 * cross
            for a in range(p):
                for j in range(p):
                    acc = acc + dmd(s, a, j) * (delta[a] * delta[j]
                                                + cov[a, j])
            op.append(acc)

        # alpha updates (diagonal), then phi with the new alpha marginals
        new_aprec = [ap[n] + sici[n] * op[3 * n + 2] for n in range(nq)]
        new_acov = [1.0 / new_aprec[n] for n in range(nq)]
        new_amu = [(-0.5) * sici[n] * op[3 * n + 1] * new_acov[n]
                   for n in range(nq)]
        tmp1, new_b = [], []
        for n in range(nq):
            c2 = new_acov[n] + new_amu[n] * new_amu[n]
            t1 = op[3 * n] + new_amu[n] * op[3 * n + 1] + c2 * op[3 * n + 2]
            tmp1.append(t1)
            new_b.append(1.0 / (t1 * 0.5 + inv_b0[n]))
        new_c = [c_post[n] * ones for n in range(nq)]
        return ((new_b, new_c, new_amu, new_acov, new_aprec),
                torch.stack(means), prec, cov, chol, tmp1)

    st = ([init_b[n] * ones for n in range(nq)],
          [init_c[n] * ones for n in range(nq)],
          [0.0 * ones for _ in range(nq)],
          [init_acov[n] * ones for n in range(nq)],
          [init_aprec[n] * ones for n in range(nq)])
    zmeans = torch.zeros((p, nv), dtype=dt, device=dev)
    zmat = torch.zeros((p, p, nv), dtype=dt, device=dev)
    if detector is None:
        means, prec, cov = zmeans, zmat, zmat
        for _ in range(n_iters):
            st, means, prec, cov, _, _ = step(st)
        return _outputs(means, prec, cov, st)

    det = detector["det"]
    f_const = float(torch.tensor(detector["f_const"], dtype=dt))
    lb = float(torch.tensor(detector["lb_coeff"], dtype=dt))
    # loop-invariant ELBO pieces: part3 plus the surviving alpha-prior
    # logs of the updated alphas
    f_base = torch.zeros(nv, dtype=dt, device=dev)
    for n in range(nq):
        f_base = f_base + 0.5 * torch.log(torch.tensor(ap[n], dtype=dt)) \
            * ones
    for i in range(p):
        f_base = f_base + 0.5 * torch.log(pp[i])

    def elbo(new, means, cov, chol, tmp1):
        """The degenerate AR(1) ELBO at the new state."""
        new_b, _, new_amu, new_acov, new_aprec = new
        logdet = 0.0
        for i in range(p):
            logdet = logdet + 2.0 * torch.log(chol[i, i])
        dmsum = 0.0
        for i in range(p):
            dm = means[i] - pm[i]
            dmsum = dmsum + (dm * dm + cov[i, i]) * pp[i]
        f = f_const + f_base - 0.5 * logdet - 0.5 * dmsum
        for n in range(nq):
            new_sici = new_b[n] * c_post[n]
            f = (f - 0.5 * torch.log(new_aprec[n])
                 + lb * torch.log(new_b[n])
                 - 0.5 * new_sici * tmp1[n]
                 - new_b[n] * c_post[n] * inv_b0[n]
                 - 0.5 * ap[n] * (new_amu[n] * new_amu[n] + new_acov[n]))
        return f

    conv = det.init_state(nv, dt, device=dev)
    cur = [st, zmeans, zmat, zmat]
    best = list(cur)
    is_init = torch.ones(nv, dtype=torch.bool, device=dev)
    best_init = is_init
    f_lane = conv.prev_f.clone()
    it = 0
    while it < n_iters and not bool(conv.done.all()):
        # 1. best-save where flagged (neither detector sets it: the best
        #    copy stays the engine-initial state)
        best = _where(conv.save, cur, best)
        best_init = torch.where(conv.save, is_init, best_init)
        # 2-4. update, ELBO, test
        new, means, prec, cov, chol, tmp1 = step(cur[0])
        f = elbo(new, means, cov, chol, tmp1)
        tested = det.test(conv, f)
        # 5. lanes done before this iteration keep their state
        act = ~conv.done
        conv = type(conv)(*(torch.where(act, n, o)
                             for n, o in zip(tested, conv)))
        cur = _where(act, [new, means, prec, cov], cur)
        f_lane = torch.where(act, f, f_lane)
        is_init = is_init & ~act
        it += 1
    # the engine's finalize: best-save, then revert
    best = _where(conv.save, cur, best)
    best_init = torch.where(conv.save, is_init, best_init)
    cur = _where(conv.revert, best, cur)
    sel_init = conv.revert & best_init
    out = _outputs(*cur[1:], cur[0])
    b = torch.where(sel_init, -out[6], out[6])
    return out[:6] + (b, out[7], f_lane[None], conv.its.to(dt)[None])


def _outputs(means, prec, cov, st):
    return (means, prec, cov) + tuple(torch.stack(x) for x in (
        st[2], st[3], st[4], st[0], st[1]))


def fused_ar_loop(m0, rmr, dmr, consts, prior_means, prior_prec, n_iters,
                  detector=None):
    """The AR(1) fixed point from statistics (see fused_ar_loop_plain
    for the shapes and the detector dict)."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    _check_detector(detector)
    if m0.device.type == "cpu":
        return fused_ar_loop_plain(m0, rmr, dmr, consts, prior_means,
                                   prior_prec, n_iters, detector)
    dev = m0.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for tensors on {dev}")
    p, nv = m0.shape
    s_n = rmr.shape[0]
    nq = s_n // NSPECS
    if s_n % NSPECS or not ar_instantiated(p, nq):
        raise ValueError(f"no CUDA kernel instantiation for P={p}, "
                         f"{s_n} specs (csrc/fused_ar_loop.cu "
                         "FABBER_AR_INSTANCES)")
    for t, name, shape in ((m0, "m0", (p, nv)), (rmr, "rmr", (s_n, nv)),
                           (dmr, "dmr", (s_n, p, nv)),
                           (prior_means, "prior_means", (p, nv)),
                           (prior_prec, "prior_prec", (p, nv))):
        check_plane(t, name, shape, dev)
    check_host_consts(consts, n_consts(p, nq))

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (out(p, nv), out(p, p, nv), out(p, p, nv)) \
        + tuple(out(nq, nv) for _ in range(5))
    if detector is not None:
        outs += (out(1, nv), out(1, nv))
    if nv:
        from . import _cuda
        if _cuda.launch_ar_loop(
                p, nq, int(n_iters), consts.to(torch.float32).contiguous(),
                None if detector is None else detector["det"],
                None if detector is None else (float(detector["f_const"]),
                                               float(detector["lb_coeff"])),
                m0, rmr, dmr, prior_means, prior_prec, outs):
            fused_ar_loop.instance_launches += 1
        fused_ar_loop.launches += 1
        if detector is not None:
            fused_ar_loop.det_launches += 1
    return outs


fused_ar_loop.launches = 0
fused_ar_loop.det_launches = 0
fused_ar_loop.instance_launches = 0


def ar_elbo_consts(p, nq, ntimes, b0, c0):
    """The host float64 constants of the degenerate AR(1) ELBO
    (fabber_core_tpu/inference/vb.py:1356-1369): (f_const, lb_coeff).
    The digamma terms of -exp_phi and part0 cancel at c = c_post;
    alphas not updated (alpha_2 with one echo) contribute part8's
    -1/2 each."""
    cp = (ntimes - 1.0) * 0.5 + c0
    l2p = math.log(2.0 * math.pi)
    f_const = ((1.0 + 0.5 * p) * (l2p + 1.0)
               + nq * (math.lgamma(cp) + cp)
               - l2p * ((ntimes - 1.0) + 1.0 + 0.5 * p)
               - 0.5 * (2 - nq)
               - nq * (2.0 * math.lgamma(c0) + 2.0 * c0 * math.log(b0)))
    return f_const, cp
