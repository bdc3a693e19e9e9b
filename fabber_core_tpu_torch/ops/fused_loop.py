"""Whole-loop fixed-design kernel from precomputed statistics (kernel 5),
its plain-torch version, and the fixed-point step it shares with the
whole-program kernel (ops/fused_whole.py).

Port of fabber_core_tpu/ops/fused_loop.py. With a constant design D
and white noise, the VB fixed point (Eq 19-22) depends on the data only
through the sufficient statistics of noise/white.py make_design_stats:
m0 [P,V], r0'Q_qr0 [Q,V], D'Q_qr0 [Q,P,V] and the constant D'Q_qD. One
hand-written CUDA kernel (csrc/fused_loop.cu) replaces
make_fused_vb_loop: per voxel, the n_iters fixed-point steps run in
registers from one read of the statistics, and the posterior is written
once —

  theta: prec = sum_q phi_q D'Q_qD + diag(pp), the jitter-retry
      Cholesky, cov, means = cov (sum_q phi_q D'Q_qy + pp pm) with
      D'Q_qy = D'Q_qr0 + D'Q_qD m0;
  noise: k'Q_qk = r0'Q_qr0 - 2 d'D'Q_qr0 + d'D'Q_qDd (d = means - m0),
      clamped at 0, tr_q = tr(Sigma D'Q_qD), b = 1/((k'Qk + tr)/2 +
      1/b0), c = c_post (a locked sd: b = 1/(c sd^2)) —

from zero means and the noise at (b_init, c_init), maxits only (the JAX
package's gate). The plain version's arithmetic and its order are
noise/white.py update_theta_stats / update_noise_stats'; the kernel's
step takes fewer instructions (whole_device.cuh whole_step, LEAN: it
multiplies by the Cholesky's diagonal reciprocals where the plain version
divides, and sums the noise quadratic and trace over the distinct terms),
so its float32 rounding differs and the card checks hold it to the plain
version at float64 (chip_smoke.py near_f64).

The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. ``fused_vb_loop.
launches`` counts kernel launches, ``instance_launches`` those of a
per-shape instance (ops/_cuda.py build_instance). The TPU form's ROWS=8 voxel fold and
sublane-replicated constant column are gone: the constants are one
host vector passed by value.
"""

import numpy as np
import torch

from . import smallmat as sm
from .fused_vb import check_plane


def whole_instantiated(p, nq):
    """True when kernels 4 and 5 can run at P and Q on the card: the
    prebuilt library holds them (csrc/whole_device.cuh
    FABBER_WHOLE_INSTANCES: Q = 1..3 at P = 1..5, Q = 1, 2 at P = 6..8;
    asked of the built library), or a per-shape instance can be built at
    the route's first launch (ops/_cuda.py build_instance: P <= 20, Q <=
    4). Nothing is built here."""
    from . import _cuda
    return (_cuda.has_whole_instance(p, nq)
            or _cuda.instance_buildable("whole", p, nq))


# The JAX engine's whole-loop gate on a TPU (fabber_core_tpu/ops/
# fused_loop.py VMEM_BUDGET, pick_block, n_white_loop_planes,
# n_ar_loop_planes; the port's own copy): the TPU kernels' live planes
# of a 1,024-voxel tile against its VMEM budget. They do not depend on T,
# and the port's route gate takes them as they are, so kernels 5 and 9
# serve the shapes the JAX engine runs its kernels at (kernel 5 P <= 17
# at Q = 1, <= 16 at Q 2-4; kernel 9 P <= 16 at one echo, <= 15 at two)
# and past them the port takes the JAX engine's route.
VMEM_BUDGET = 8 << 20


def pick_block(nvoxels, n_planes):
    """The JAX engine's voxel tile for its whole-loop kernels, (block,
    pad), or None where none fits (it takes another route)."""
    fitting = [bb for bb in (16384, 8192, 4096, 2048, 1024)
               if n_planes * bb * 4 * 2 <= VMEM_BUDGET]
    if not fitting:
        return None
    for bb in fitting:
        if nvoxels % bb == 0:
            return bb, 0
    return fitting[-1], (-nvoxels) % fitting[-1]


def n_white_loop_planes(p, nq):
    """Live planes of the JAX stats-input loop (kernel 5)."""
    ntri = p * (p + 1) // 2
    return ((3 * p + nq + nq * p) + (p + 2 * p * p + 2 * nq)
            + (2 * nq + p + 2 * ntri) + nq * p)


def n_ar_loop_planes(p, fdet=False, nq=1):
    """Live planes of the JAX AR(1) loop (kernel 9); fdet its detector
    mode."""
    ntri = p * (p + 1) // 2
    s = 3 * nq
    return ((3 * p + s + s * p) + (p + 2 * p * p + 5 * nq)
            + (5 * nq + p + 2 * ntri) + s * p
            + ((9 + 4 + (5 * nq + p + 2 * ntri)) if fdet else 0))


def check_host_consts(consts, n):
    if consts.device.type != "cpu" or consts.numel() != n:
        raise ValueError(f"consts must be a host vector of {n} values: it "
                         "is passed to the kernel by value")


def pack_loop_consts(dtqd, noise_prior_b, noise_prior_c, ntimes_per_group,
                     init_b, init_c):
    """[Q*P*P + 4Q] float64 host vector: D'Q_qD [Q,P,P] row-major, then
    1/b0, c_post = (n_q-1)/2 + c0, b_init, c_init per group (the JAX
    pack_consts' order, without its ROWS replication)."""
    dtqd = np.asarray(dtqd.cpu() if torch.is_tensor(dtqd) else dtqd,
                      np.float64)
    nq = dtqd.shape[0]
    b0 = np.asarray(noise_prior_b, np.float64).reshape(nq)
    c0 = np.asarray(noise_prior_c, np.float64).reshape(nq)
    nt_g = np.asarray(ntimes_per_group, np.float64).reshape(nq)
    return torch.as_tensor(np.concatenate([
        dtqd.reshape(-1), 1.0 / b0, (nt_g - 1.0) * 0.5 + c0,
        np.full(nq, float(init_b)), np.full(nq, float(init_c))]))


def unpack_consts(consts, p, nq, dtype):
    """(dtqd(q, i, j) accessor, inv_b0, c_post, b_init, c_init) of a
    pack_loop_consts vector, its values rounded to the dtype."""
    k = consts.to(dtype).tolist()
    n = nq * p * p

    def dtqd(q, i, j):
        return k[(q * p + i) * p + j]

    return (dtqd, k[n:n + nq], k[n + nq:n + 2 * nq],
            k[n + 2 * nq:n + 3 * nq], k[n + 3 * nq:n + 4 * nq])


def loop_inputs(m0, rtqr, dtqr, consts, prior_means, prior_prec):
    """The fixed point's inputs as [V] planes (lists): (dtqd, m0, rtqr,
    dtqr, dtqy, pm, pp) with D'Q_qy = dtqr_q + D'Q_qD m0, the initial
    noise b, c [Q] and the constants 1/b0, c_post [Q], rounded to m0's
    dtype."""
    p, nv = m0.shape
    nq = rtqr.shape[0]
    dt, dev = m0.dtype, m0.device
    dtqd, inv_b0, c_post, b_init, c_init = unpack_consts(consts, p, nq, dt)
    m0l = list(m0)
    dtqr_l = [list(dtqr[q]) for q in range(nq)]
    dtqy = [[dtqr_l[q][a] + sum(dtqd(q, a, j) * m0l[j] for j in range(p))
             for a in range(p)] for q in range(nq)]
    b = [torch.full((nv,), b_init[q], dtype=dt, device=dev)
         for q in range(nq)]
    c = [torch.full((nv,), c_init[q], dtype=dt, device=dev)
         for q in range(nq)]
    args = (dtqd, m0l, list(rtqr), dtqr_l, dtqy, list(prior_means),
            list(prior_prec))
    return args, b, c, inv_b0, c_post


def fixed_point_step(dtqd, m0, rtqr, dtqr, dtqy, pm, pp, b, c, inv_b0,
                     c_post, locked_sd, centre=None, alpha=None):
    """One fixed-point step on [V] planes (lists), in the operation order
    of the TPU kernels (fused_loop.py:257-305, fused_whole.py:449-529):
    -> (means [P,V], prec [P,P,V], cov [P,P,V], chol [P,P,V], b [Q] and
    c [Q] lists, kqk [Q], tr [Q]). With alpha [V] the lm step about
    centre [P] where alpha > 0."""
    p, nq = len(m0), len(rtqr)
    phi = [b[q] * c[q] for q in range(nq)]
    rows = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            v = 0.0
            for q in range(nq):
                v = v + phi[q] * dtqd(q, i, j)
            if i == j:
                v = v + pp[i]
            rows[i][j] = rows[j][i] = v
    prec = torch.stack([torch.stack(r) for r in rows])
    chol, _ = sm.cholesky_jittered(prec)
    cov = sm.inverse_from_chol(chol)
    rhs = []
    for a in range(p):
        v = 0.0
        for q in range(nq):
            v = v + phi[q] * dtqy[q][a]
        rhs.append(v + pp[a] * pm[a])
    means = [sum(cov[i, j] * rhs[j] for j in range(p)) for i in range(p)]
    if alpha is not None:
        dc = [centre[a] - m0[a] for a in range(p)]
        delta = []
        for a in range(p):
            v = 0.0
            for q in range(nq):
                g = dtqr[q][a]
                for j in range(p):
                    g = g - dtqd(q, a, j) * dc[j]
                v = v + phi[q] * g
            delta.append(v + pp[a] * pm[a] - pp[a] * centre[a])
        damped = sm.add_diag(prec, alpha[None] * sm.diag_of(prec))
        dch, _ = sm.cholesky_jittered(damped)
        sol = sm.solve_chol_vec(dch, torch.stack(delta))
        use_lm = alpha > 0.0
        means = [torch.where(use_lm, centre[a] + sol[a], means[a])
                 for a in range(p)]
    d = [means[a] - m0[a] for a in range(p)]
    nb, nc, kqks, trs = [], [], [], []
    for q in range(nq):
        cross = sum(d[a] * dtqr[q][a] for a in range(p))
        quad = 0.0
        tr = 0.0
        for a in range(p):
            for j in range(p):
                d_aj = dtqd(q, a, j)
                quad = quad + d_aj * d[a] * d[j]
                tr = tr + d_aj * cov[a, j]
        kqk = torch.clamp(rtqr[q] - 2.0 * cross + quad, min=0.0)
        bq = 1.0 / ((kqk + tr) * 0.5 + inv_b0[q])
        cq = torch.full_like(bq, c_post[q])
        if locked_sd > 0:
            bq = 1.0 / cq / locked_sd ** 2
        nb.append(bq)
        nc.append(cq)
        kqks.append(kqk)
        trs.append(tr)
    return (torch.stack(means), prec, cov, chol, nb, nc, kqks, trs)


def fused_vb_loop_plain(m0, rtqr, dtqr, consts, prior_means, prior_prec,
                        n_iters, locked_noise_stdev=-1.0):
    """Plain torch: m0 [P,V], rtqr [Q,V], dtqr [Q,P,V], consts
    (pack_loop_consts), prior_means/prior_prec [P,V] -> (means [P,V],
    prec [P,P,V], cov [P,P,V], b [Q,V], c [Q,V])."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    args, b, c, inv_b0, c_post = loop_inputs(m0, rtqr, dtqr, consts,
                                             prior_means, prior_prec)
    for _ in range(n_iters):
        means, prec, cov, _, b, c, _, _ = fixed_point_step(
            *args, b, c, inv_b0, c_post, locked_noise_stdev)
    return means, prec, cov, torch.stack(b), torch.stack(c)


def fused_vb_loop(m0, rtqr, dtqr, consts, prior_means, prior_prec, n_iters,
                  locked_noise_stdev=-1.0):
    """The whole maxits fixed point from statistics (see
    fused_vb_loop_plain for the shapes)."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    if m0.device.type == "cpu":
        return fused_vb_loop_plain(m0, rtqr, dtqr, consts, prior_means,
                                   prior_prec, n_iters, locked_noise_stdev)
    dev = m0.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for tensors on {dev}")
    p, nv = m0.shape
    nq = rtqr.shape[0]
    if not whole_instantiated(p, nq):
        raise ValueError(f"no CUDA kernel instantiation for P={p}, Q={nq} "
                         "(csrc/whole_device.cuh FABBER_WHOLE_INSTANCES)")
    for t, name, shape in ((m0, "m0", (p, nv)), (rtqr, "rtqr", (nq, nv)),
                           (dtqr, "dtqr", (nq, p, nv)),
                           (prior_means, "prior_means", (p, nv)),
                           (prior_prec, "prior_prec", (p, nv))):
        check_plane(t, name, shape, dev)
    check_host_consts(consts, nq * p * p + 4 * nq)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (out(p, nv), out(p, p, nv), out(p, p, nv), out(nq, nv),
            out(nq, nv))
    if nv:
        from . import _cuda
        if _cuda.launch_vb_loop(p, nq, int(n_iters),
                                float(locked_noise_stdev),
                                consts.to(torch.float32).contiguous(), m0,
                                rtqr, dtqr, prior_means, prior_prec, outs):
            fused_vb_loop.instance_launches += 1
        fused_vb_loop.launches += 1
    return outs


fused_vb_loop.launches = 0
fused_vb_loop.instance_launches = 0

