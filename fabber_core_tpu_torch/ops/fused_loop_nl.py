"""Whole-VB-loop kernel for time-local (nonlinear) models, and its
plain-torch version.

Port of fabber_core_tpu/ops/fused_loop_nl.py in its time_signal and
generic modes, maxits and the in-kernel detectors. One hand-written CUDA
kernel for Hopper (csrc/fused_nl_loop.cuh, with the hand-written
functors' entry points in csrc/fused_nl_loop.cu) replaces
make_fused_nl_loop: per voxel,
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

Detector mode (``detector=``, fused_loop_nl.py:56-84 of the JAX
package): pointzeroone, freduce, trialmode and lm run their lane state
machines in the loop. Pass k's evaluation at its centre (iteration
k-1's means) gives iteration k-1's quadratics, so its F is assembled
from them, the carried posterior and the host ELBO constants of
VBInference._nl_fdet_consts, and its test runs before iteration k's
update; a lane done freezes. The last test runs on the F pass at the
final means. freduce reports the initial-state ELBO for a reverted
lane and flags it (the engine restores the initial posterior);
trialmode and lm keep best-state copies and apply the engine's
save/revert after the loop; lm takes the damped step where its alpha is
> 0. The last two outputs are then F and the iteration count [1,V]
(freduce: [2,V], with the revert flag and zeros).

Generic full-time mode (fused_loop_nl.py:37-46, 204-227, 294-310 of the
JAX package, TPU kernel 6g): a model with only an ``evaluate`` that
models/kernelgen.py admits runs the same loop with the model in place
of time_signal_jac. On the card the kernel's template
(csrc/fused_nl_loop.cuh) is built with a C++ functor generated from the
traced evaluate (ops/_cuda.py build_generated), which reads the voxel's
suppdata [S,V]; its plain version evaluates the model with ops/fused_vb.py
full_eval (make_full_eval's counterpart) and sums each quadratic over
the whole time axis at once. A time_signal model without a hand-written
functor runs a functor generated from its time_signal the same way.

The kernel stages each block's [T, VB] data tile and the [T, Q] group
weights in shared memory once (csrc/tile.cuh) where ops/_cuda.py
tile_plan says they fit, and streams the plane from global memory
otherwise.

The wrapper takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises. ``fused_nl_loop.
launches`` counts kernel launches, ``det_launches`` those in detector
mode, ``generic_launches`` those in the generic full-time mode (a
functor generated from evaluate; one generated from a time_signal is
the time_signal mode), ``staged_launches`` those in the staged form.
"""

import numpy as np
import torch

from . import smallmat as sm
from .fused_vb import (TRANSFORM_CODES, block_evaluator, check_plane,
                       f_quadratics, full_eval, group_masks,
                       group_quadratics, group_weights, kernel_args,
                       posterior_solve, signal_jac_fn, trace_terms)

DETECTOR_KINDS = ("pointzeroone", "freduce", "trialmode", "lm")


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
                        locked_noise_stdev=-1.0, detector=None,
                        post_var0=None, evaluator=None):
    """Plain torch, the whole loop: centre0/prior_means/prior_prec
    [P,V], data [T,V], qmasks [Q,T], consts [4Q] (pack_nl_consts) ->
    (means [P,V], prec [P,P,V], cov [P,P,V], b [Q,V], c [Q,V],
    fkqk [Q,V], ftr [Q,V]); the last two are zeros when need_f is
    False. detector: None (maxits) or the dict of
    VBInference._nl_fdet_consts (the module docstring's detector mode;
    post_var0 [P,V] are the initial posterior variances freduce's
    initial F needs). evaluator: the model as ops/fused_vb.py full_eval
    makes it (the generic full-time mode: each quadratic summed over the
    whole time axis at once, as the TPU kernel's generic mode does);
    default, time_signal mode from time_signal_jac."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    ev = evaluator or block_evaluator(time_signal_jac, transforms,
                                      data.shape[0])
    if detector is not None:
        return _nl_loop_detector_plain(
            ev, centre0, prior_means, prior_prec, data, qmasks, consts,
            n_iters, locked_noise_stdev, detector, post_var0)
    dt, dev = centre0.dtype, centre0.device
    p, nv = centre0.shape
    q = group_masks(qmasks, dt, dev)
    nq = q.shape[0]
    data = data.to(dt)
    k = consts.to(dt).tolist()      # values rounded to the dtype
    inv_b0, c_post = k[:nq], k[nq:2 * nq]

    centre = centre0
    b = torch.full((nq, nv), k[2 * nq], dtype=dt, device=dev)
    c = torch.full((nq, nv), k[3 * nq], dtype=dt, device=dev)
    for _ in range(n_iters):
        phi = b * c
        sig, jac = ev(centre)
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
        fkqk, ftr = f_quadratics(ev, means, data, q, cov)
    else:
        fkqk = torch.zeros((nq, nv), dtype=dt, device=dev)
        ftr = torch.zeros_like(fkqk)
    return means, prec, cov, b, c, fkqk, ftr


def fused_nl_loop(model, transforms, centre0, prior_means, prior_prec, data,
                  qmasks, consts, n_iters, need_f, locked_noise_stdev=-1.0,
                  detector=None, post_var0=None, functor=None, supp=None,
                  _vb=None):
    """The whole VB loop (see fused_nl_loop_plain for the shapes and
    the detector mode). model: the forward model (signal_jac_fn(model)
    on the CPU, kernel_model() for the CUDA functor). functor: a
    models/kernelgen.py TimeLocalEval, whose kernel the card launches
    from functor.libs[Q] (built before, ops/_cuda.py build_generated):
    generated from the model's evaluate (its fn set: the generic full-time mode, whose
    plain version is ops/fused_vb.py full_eval, with supp [S,V] when the
    functor reads suppdata) or from its time_signal. _vb: private, for
    the tests and chip_smoke.py: forces the kernel's form (0 streamed,
    > 0 staged in blocks of that many lanes; ops/_cuda.py launch_vb)."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    kind = None if detector is None else type(detector["det"]).name
    if kind is not None and kind not in DETECTOR_KINDS:
        raise ValueError(f"no detector mode for '{kind}'")
    if kind == "freduce" and post_var0 is None:
        raise ValueError("freduce needs post_var0 (the initial variances)")
    nsupp = 0 if functor is None else functor.nsupp
    if nsupp and (supp is None or supp.shape[0] != nsupp):
        raise ValueError(f"the model reads {nsupp} suppdata values per "
                         f"voxel: supp must be [S,V] with S = {nsupp}")
    generic = functor is not None and functor.fn is not None
    if centre0.device.type == "cpu":
        ev = full_eval(functor.fn, transforms, supp if nsupp else None) \
            if generic else None
        return fused_nl_loop_plain(
            None if generic else signal_jac_fn(model), transforms, centre0,
            prior_means, prior_prec, data, qmasks, consts, n_iters, need_f,
            locked_noise_stdev, detector, post_var0, ev)
    dev = centre0.device
    p, nv = centre0.shape
    nq = len(qmasks)
    if functor is None:
        km, tcodes = kernel_args(model, transforms, nq, dev)
    else:
        if len(transforms) != functor.nparams:
            raise ValueError(f"{len(transforms)} transforms for "
                             f"{functor.nparams} parameters")
        tcodes = [TRANSFORM_CODES[tr.code] for tr in transforms]
    nt = data.shape[0]
    for t, name, shape in ((centre0, "centre0", (p, nv)),
                           (prior_means, "prior_means", (p, nv)),
                           (prior_prec, "prior_prec", (p, nv)),
                           (data, "data", (nt, nv))):
        check_plane(t, name, shape, dev)
    if nsupp:
        check_plane(supp, "supp", (nsupp, nv), dev)
    if consts.device.type != "cpu" or consts.numel() != 4 * nq:
        raise ValueError(f"consts must be a host vector of {4 * nq} "
                         "values: it is passed to the kernel by value")
    if kind == "freduce":
        check_plane(post_var0, "post_var0", (p, nv), dev)
    qw = group_weights(qmasks, dev)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    fq = nq if kind is None else (2 if kind == "freduce" else 1)
    outs = (out(p, nv), out(p, p, nv), out(p, p, nv), out(nq, nv),
            out(nq, nv), out(fq, nv), out(fq, nv))
    det_consts = None if kind is None else torch.tensor(
        list(detector["lb_coeff"]) + [detector["f_const"],
                                      detector["f_const_init"]],
        dtype=torch.float32)
    if nv:
        from . import _cuda
        det = None if kind is None else detector["det"]
        pd0 = post_var0 if kind == "freduce" else None
        vb = _cuda.launch_vb(nt, nq, _vb)
        if functor is None:
            _cuda.launch_nl_loop(km, nq, tcodes, int(n_iters), bool(need_f),
                                 float(locked_noise_stdev),
                                 consts.to(torch.float32), det, det_consts,
                                 centre0, prior_means, prior_prec, pd0, data,
                                 qw, outs, vb)
        else:
            lib = functor.libs.get(nq)
            if lib is None:
                raise ValueError(
                    f"no kernel built for this functor at Q={nq}: "
                    "functor.libs[Q] = ops/_cuda.py build_generated(...) "
                    "(the engine builds it at construction)")
            _cuda.launch_gen_nl_loop(
                lib, tcodes, int(n_iters), bool(need_f),
                float(locked_noise_stdev), consts.to(torch.float32), det,
                det_consts, centre0, prior_means, prior_prec, pd0, data,
                supp if nsupp else None, qw, outs, vb)
            if generic:
                fused_nl_loop.generic_launches += 1
        fused_nl_loop.launches += 1
        if kind is not None:
            fused_nl_loop.det_launches += 1
        if vb > 0:
            fused_nl_loop.staged_launches += 1
    return outs


fused_nl_loop.launches = 0
fused_nl_loop.det_launches = 0
fused_nl_loop.generic_launches = 0
fused_nl_loop.staged_launches = 0


def _round(x, dt):
    """A host float rounded to the dtype (the kernel's float32 view of
    a float64 host constant)."""
    return float(torch.tensor(float(x), dtype=dt))


def _nl_loop_detector_plain(ev, centre0, prior_means, prior_prec, data,
                            qmasks, consts, n_iters, locked_noise_stdev,
                            detector, post_var0):
    """The detector mode of fused_nl_loop_plain (module docstring),
    step for step the TPU kernel's (fused_loop_nl.py:346-857 of the JAX
    package), with the lanes' tests from inference/convergence.py."""
    dt, dev = centre0.dtype, centre0.device
    p, nv = centre0.shape
    q = group_masks(qmasks, dt, dev)
    nq = q.shape[0]
    data = data.to(dt)
    k = consts.to(dt).tolist()
    inv_b0, c_post = k[:nq], k[nq:2 * nq]
    det = detector["det"]
    kind = type(det).name
    freduce = kind == "freduce"
    tracks_best = kind in ("trialmode", "lm")
    lbc = [_round(x, dt) for x in detector["lb_coeff"]]
    pm, pp = prior_means, prior_prec

    def part3(const):
        v = torch.full((nv,), _round(const, dt), dtype=dt, device=dev)
        for i in range(p):
            v = v + 0.5 * torch.log(pp[i])
        return v

    part3vox = part3(detector["f_const"])

    def assemble_f(cen, b, c, covdiag, logdet, kqk, trace, base):
        """free_energy_from_parts with the noise shape fixed (the TPU
        kernel's assemble_f)."""
        v = base - 0.5 * logdet
        for qi in range(nq):
            phi_q = b[qi] * c[qi]
            v = (v + lbc[qi] * torch.log(b[qi]) - phi_q * inv_b0[qi]
                 - 0.5 * phi_q * kqk[qi] - 0.5 * trace[qi])
        for i in range(p):
            dm = cen[i] - pm[i]
            v = v - 0.5 * (dm * dm + covdiag[i]) * pp[i]
        return v

    def sel(mask, new, old):
        return torch.where(mask.reshape((1,) * (new.dim() - 1) + (nv,)),
                           new, old)

    centre = centre0
    b = torch.full((nq, nv), k[2 * nq], dtype=dt, device=dev)
    c = torch.full((nq, nv), k[3 * nq], dtype=dt, device=dev)
    zeros_pp = torch.zeros((p, p, nv), dtype=dt, device=dev)
    prec, cov = zeros_pp, zeros_pp
    logdet = torch.zeros(nv, dtype=dt, device=dev)
    f_st = torch.zeros(nv, dtype=dt, device=dev)
    rev_f = torch.zeros(nv, dtype=dt, device=dev)
    conv = det.init_state(nv, dt, device=dev)
    # the TPU kernel's sentinel is float32's, at every dtype
    conv = conv._replace(prev_f=torch.full_like(
        f_st, float(torch.finfo(torch.float32).min)))
    best = (torch.zeros_like(centre), torch.zeros_like(b),
            torch.zeros_like(c), zeros_pp, zeros_pp, f_st)

    def commit_test(conv, f_st, f_new):
        """The test of one iteration on lanes still running."""
        run = ~conv.done
        reduced = (f_new - conv.prev_f) < 0
        new = det.test(conv, f_new)
        conv = type(conv)(*(torch.where(run, n, o)
                            for n, o in zip(new, conv)))
        committed = torch.where(reduced, rev_f, f_new) if freduce else f_new
        return conv, torch.where(run, committed, f_st), run

    it = 0
    while it < n_iters and not bool(conv.done.all()):
        phi = b * c
        sig, jac = ev(centre)
        r = data - sig
        jtj, _ = group_quadratics(jac, q)
        wr = [q[qi][:, None] * r for qi in range(nq)]
        jtr = [torch.stack([torch.sum(jac[a] * wr[qi], dim=0)
                            for a in range(p)]) for qi in range(nq)]
        rqr = [torch.sum(wr[qi] * r, dim=0) for qi in range(nq)]

        # the deferred test of iteration it-1, from this pass's
        # quadratics at its means
        f_here = assemble_f(centre, b, c, sm.diag_of(cov), logdet, rqr,
                            trace_terms(cov, jtj), part3vox)
        if freduce and it == 0:
            pd0 = post_var0.to(dt)
            tr0 = [sum(pd0[i] * jtj[qi][i, i] for i in range(p))
                   for qi in range(nq)]
            ld0 = 0.0
            for i in range(p):
                ld0 = ld0 - torch.log(pd0[i])
            rev_f = assemble_f(centre, b, c, pd0, ld0, rqr, tr0,
                               part3(detector["f_const_init"]))
        if it >= 1:
            conv, f_st, run = commit_test(conv, f_st, f_here)
            if tracks_best:
                # the top-of-iteration save of the engine: the carry is
                # iteration it-1's state
                bsv = run & conv.save
                best = tuple(sel(bsv, n, o) for n, o in zip(
                    (centre, b, c, prec, cov, f_here), best))

        act = ~conv.done
        means, prec_n, cov_n, chol = posterior_solve(
            jtj, jtr, phi, centre, pm, pp, True)
        if kind == "lm":
            delta = []
            for i in range(p):
                v = pp[i] * (pm[i] - centre[i])
                for qi in range(nq):
                    v = v + phi[qi] * jtr[qi][i]
                delta.append(v)
            damped = sm.add_diag(prec_n, conv.alpha[None]
                                 * sm.diag_of(prec_n))
            dchol, _ = sm.cholesky_jittered(damped)
            lm_means = centre + sm.solve_chol_vec(dchol, torch.stack(delta))
            means = sel(conv.alpha > 0.0, lm_means, means)
        d = centre - means
        tr = trace_terms(cov_n, jtj)
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
        logdet_n = 0.0
        for i in range(p):
            logdet_n = logdet_n + 2.0 * torch.log(chol[i, i])
        centre = sel(act, means, centre)
        b = sel(act, torch.stack(nb), b)
        c = sel(act, torch.stack(nc), c)
        prec = sel(act, prec_n, prec)
        cov = sel(act, cov_n, cov)
        logdet = sel(act, logdet_n, logdet)
        it += 1

    # the last iteration's test, on the F pass at the final means
    kqk2, trace2 = f_quadratics(ev, centre, data, q, cov)
    f_last = assemble_f(centre, b, c, sm.diag_of(cov), logdet, kqk2, trace2,
                        part3vox)
    conv, f_st, _ = commit_test(conv, f_st, f_last)
    if tracks_best:
        # the engine's finalize: best <- final where save, then the
        # output <- best where revert (its F is the one captured at the
        # save)
        final = (centre, b, c, prec, cov, f_st)
        best = tuple(sel(conv.save, n, o) for n, o in zip(final, best))
        centre, b, c, prec, cov, f_st = (sel(conv.revert, bb, ff)
                                         for bb, ff in zip(best, final))
    its = conv.its.to(dt)
    if freduce:
        fout = torch.stack([f_st, conv.revert.to(dt)])
        tout = torch.stack([its, torch.zeros_like(its)])
    else:
        fout, tout = f_st[None], its[None]
    return centre, prec, cov, b, c, fout, tout
