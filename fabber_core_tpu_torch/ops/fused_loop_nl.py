"""Whole-VB-loop kernel for time-local (nonlinear) models, and its
plain-torch version.

Port of fabber_core_tpu/ops/fused_loop_nl.py in its time_signal mode,
maxits (no in-kernel detector). One hand-written CUDA kernel for
Hopper (csrc/fused_nl_loop.cu) replaces make_fused_nl_loop: per voxel,
the whole fixed point of white-noise VB runs in registers —

  per iteration, one pass over the T samples: model + latent-space
      Jacobian at the centre, per group J'Q_iJ, J'Q_i r and r'Q_i r;
  solve: prec = sum_i phi_i J'Q_iJ + diag(pp), unrolled Cholesky with
      the jitter retry (+1e-10 where a diagonal is not finite),
      covariance, means;
  phi update: k'Q_ik = r'Q_ir + 2 d'J'Q_ir + d'J'Q_iJ d with
      d = centre - means, clamped at 0 (no second pass), then
      b = 1 / ((k'Qk + tr(Sigma J'Q_iJ))/2 + 1/b0), c = c_post;
  the new means become the next centre —

then, when F is needed, one pass at the final means for the free
energy's per-group k'Q_ik and tr(Sigma J'Q_iJ) (fkqk, ftr); the
digamma/lgamma assembly stays outside (noise/white.py
free_energy_from_parts). The posterior carry starts at zero and the
noise at (b_init, c_init), as the TPU kernel's.

The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. ``fused_nl_loop.
launches`` counts kernel launches.
"""

import numpy as np
import torch

from .fused_vb import (block_eval, check_plane, f_quadratics, group_masks,
                       group_quadratics, group_weights, kernel_args,
                       posterior_solve, signal_jac_fn, time_index,
                       trace_terms)


def pack_nl_consts(noise_prior_b, noise_prior_c, ntimes_per_group,
                   init_b, init_c, nq):
    """[4Q] float64 host vector: 1/b0 [Q], c_post = (n_i-1)/2 + c0 [Q],
    b_init [Q], c_init [Q] (make_fused_nl_loop's consts, flattened)."""
    b0 = np.asarray(noise_prior_b, np.float64).reshape(nq)
    c0 = np.asarray(noise_prior_c, np.float64).reshape(nq)
    nt_g = np.asarray(ntimes_per_group, np.float64).reshape(nq)
    return torch.as_tensor(np.concatenate([
        1.0 / b0, (nt_g - 1.0) * 0.5 + c0,
        np.full(nq, float(init_b)), np.full(nq, float(init_c))]))


def fused_nl_loop_plain(time_signal_jac, transforms, centre0, prior_means,
                        prior_prec, data, qmasks, consts, n_iters, need_f,
                        locked_noise_stdev=-1.0):
    """Plain torch, the whole maxits loop: centre0/prior_means/
    prior_prec [P,V], data [T,V], qmasks [Q,T], consts [4Q]
    (pack_nl_consts) -> (means [P,V], prec [P,P,V], cov [P,P,V],
    b [Q,V], c [Q,V], fkqk [Q,V], ftr [Q,V]); the last two are zeros
    when need_f is False."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    dt, dev = centre0.dtype, centre0.device
    p, nv = centre0.shape
    q = group_masks(qmasks, dt, dev)
    nq = q.shape[0]
    data = data.to(dt)
    k = consts.to(dt).tolist()      # values rounded to the dtype
    inv_b0, c_post = k[:nq], k[nq:2 * nq]
    t = time_index(data.shape[0], dt, dev)

    centre = centre0
    b = torch.full((nq, nv), k[2 * nq], dtype=dt, device=dev)
    c = torch.full((nq, nv), k[3 * nq], dtype=dt, device=dev)
    for _ in range(n_iters):
        phi = b * c
        sig, jac = block_eval(time_signal_jac, transforms, centre, t)
        r = data - sig
        jtj, _ = group_quadratics(jac, q)
        # J'Q_i r and r'Q_i r with the weight folded into r, as the
        # TPU kernel does
        wr = [q[qi][:, None] * r for qi in range(nq)]
        jtr = [torch.stack([torch.sum(jac[a] * wr[qi], dim=0)
                            for a in range(p)]) for qi in range(nq)]
        rqr = [torch.sum(wr[qi] * r, dim=0) for qi in range(nq)]
        means, prec, cov, _ = posterior_solve(
            jtj, jtr, phi, centre, prior_means, prior_prec, True)
        d = centre - means
        tr = trace_terms(cov, jtj)
        nb, nc = [], []
        for qi in range(nq):
            v = rqr[qi]
            for a in range(p):
                v = v + 2.0 * d[a] * jtr[qi][a]
            for i in range(p):
                for j in range(i + 1):
                    dd = d[i] * d[j]
                    v = v + (dd if i == j else 2.0 * dd) * jtj[qi][i, j]
            kqk = torch.clamp(v, min=0.0)
            bq = 1.0 / ((kqk + tr[qi]) * 0.5 + inv_b0[qi])
            cq = torch.full_like(bq, c_post[qi])
            if locked_noise_stdev > 0:
                bq = 1.0 / cq / locked_noise_stdev ** 2
            nb.append(bq)
            nc.append(cq)
        b, c = torch.stack(nb), torch.stack(nc)
        centre = means

    if need_f:
        fkqk, ftr = f_quadratics(time_signal_jac, transforms, means, data,
                                 q, cov)
    else:
        fkqk = torch.zeros((nq, nv), dtype=dt, device=dev)
        ftr = torch.zeros_like(fkqk)
    return means, prec, cov, b, c, fkqk, ftr


def fused_nl_loop(model, transforms, centre0, prior_means, prior_prec, data,
                  qmasks, consts, n_iters, need_f, locked_noise_stdev=-1.0):
    """The whole maxits VB loop (see fused_nl_loop_plain for the
    shapes). model: the forward model (signal_jac_fn(model) on the
    CPU, kernel_model() for the CUDA functor)."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    if centre0.device.type == "cpu":
        return fused_nl_loop_plain(signal_jac_fn(model), transforms,
                                   centre0, prior_means, prior_prec, data,
                                   qmasks, consts, n_iters, need_f,
                                   locked_noise_stdev)
    dev = centre0.device
    p, nv = centre0.shape
    nq = len(qmasks)
    km, tcodes = kernel_args(model, transforms, nq, dev)
    nt = data.shape[0]
    for t, name, shape in ((centre0, "centre0", (p, nv)),
                           (prior_means, "prior_means", (p, nv)),
                           (prior_prec, "prior_prec", (p, nv)),
                           (data, "data", (nt, nv))):
        check_plane(t, name, shape, dev)
    if consts.device.type != "cpu" or consts.numel() != 4 * nq:
        raise ValueError(f"consts must be a host vector of {4 * nq} "
                         "values: it is passed to the kernel by value")
    qw = group_weights(qmasks, dev)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (out(p, nv), out(p, p, nv), out(p, p, nv), out(nq, nv),
            out(nq, nv), out(nq, nv), out(nq, nv))
    if nv:
        from . import _cuda
        _cuda.launch_nl_loop(km, nq, tcodes, int(n_iters), bool(need_f),
                             float(locked_noise_stdev),
                             consts.to(torch.float32), centre0, prior_means,
                             prior_prec, data, qw, outs)
        fused_nl_loop.launches += 1
    return outs


fused_nl_loop.launches = 0
