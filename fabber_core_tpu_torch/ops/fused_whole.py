"""Whole-program fixed-design kernel (kernel 4): in-kernel sufficient
statistics and the whole fixed point, and its plain-torch version.

Port of fabber_core_tpu/ops/fused_whole.py. One hand-written CUDA kernel
(csrc/fused_whole.cu) replaces make_fused_whole_loop: per voxel, from
one read of its data column, any number of noise groups —

  pass 1  dty_a = sum_t (sum_q D_ta q_q[t]) y_t;
  solve   m0 by the jitter-retry Cholesky of the float32 A = sum_q
          D'Q_qD (the same rounding as the statistics: a host-float64
          inverse leaves r0 non-orthogonal to the design, 2% posterior
          drift on poly's raw Gram); non-finite -> 0;
  pass 2  about r0 = y - D m0: rtqr_q = q_q'r0^2, dtqr_q = (D*q_q)'r0;
  loop    n_iters steps of ops/fused_loop.py fixed_point_step (the
          arithmetic of the stats-input kernel 5), a locked noise sd
          included —

then the posterior, the noise and the last step's per-group F
quadratics (kqk, tr) [Q,V]; F is assembled outside
(noise/white.py free_energy_from_parts).

Detector mode (``detector=``, fused_whole.py:570-680 of the JAX
package): pointzeroone, trialmode and lm run their lane state machines
(inference/convergence.py) in the loop with the engine's order:
best-save where the last test set save, the step (lm: the damped step
with the pre-test alpha, about the previous means), F at the new state
(free_energy_from_parts with the noise shape fixed at c_post; the
Gamma-function terms in the host constants of VBInference.
_nl_fdet_consts), the test; lanes done before a test keep their state.
After the loop, the engine's finalize: best <- final where save, then
final <- best where revert. The last two outputs are then the lane's F
and iteration count [1,V]. freduce is not served: its revert target is
the engine's initial posterior (fused_whole.py:99-106).

Constants: ``pack_whole_time_consts`` [(P + QP + Q), T] rows (D', then
(D*q_q)' per group, then q_q), on the device; ``pack_whole_consts`` the
[Q*P*P + 4Q] host vector of ops/fused_loop.py pack_loop_consts with
D'Q_qD from the host design in float64. The TPU form's ROWS fold, its
time padding and its replicated constant columns are gone.

The kernel stages each block's data tile beside the design rows in
shared memory where ops/_cuda.py tile_plan says it fits (csrc/tile.cuh;
tile_weights gives the plan's weights per sample), else streams the
plane. The wrapper takes the plain version only for tensors on the CPU;
for a CUDA tensor it launches the kernel or raises.
``fused_whole.launches`` counts kernel launches, ``instance_launches``
those of a per-shape instance (ops/_cuda.py build_instance: a (P, Q)
outside FABBER_WHOLE_INSTANCES), ``det_launches`` those
in detector mode, ``lm_launches`` those under lm and ``staged_launches``
those in the staged form.
"""

import numpy as np
import torch

from . import smallmat as sm
from .fused_loop import (VMEM_BUDGET, check_host_consts, fixed_point_step,
                         loop_inputs, pack_loop_consts, whole_instantiated)
from .fused_vb import check_plane

DETECTOR_KINDS = ("pointzeroone", "trialmode", "lm")
# bytes of shared memory a block may hold (H100: 227 KB); the rows of
# pack_whole_time_consts must fit (the engine's gate)
SMEM_BYTES = 232448


def design_dtqd(design, qmasks, nt):
    """[Q,P,P] float64 D'Q_qD of the host design."""
    d = np.asarray(design, np.float64)[:nt]
    q = np.asarray(qmasks, np.float64)[:, :nt]
    return np.stack([(d * q[i][:, None]).T @ d for i in range(q.shape[0])])


def pack_whole_time_consts(design, qmasks, nt, dtype, device="cpu"):
    """[(P + Q*P + Q), T] per-timepoint rows: D' (P rows), (D*q_q)' for
    each group q (Q*P rows), q_q (Q rows)."""
    d = np.asarray(design, np.float64)[:nt]
    q = np.asarray(qmasks, np.float64)[:, :nt]
    rows = [d.T] + [(d * q[i][:, None]).T for i in range(q.shape[0])] + [q]
    return torch.as_tensor(np.ascontiguousarray(np.concatenate(rows)),
                           dtype=dtype, device=device)


def pack_whole_consts(design, qmasks, nt, noise_prior_b, noise_prior_c,
                      ntimes_per_group, init_b, init_c):
    """[Q*P*P + 4Q] float64 host vector (ops/fused_loop.py
    pack_loop_consts) with D'Q_qD from the host design."""
    return pack_loop_consts(design_dtqd(design, qmasks, nt), noise_prior_b,
                            noise_prior_c, ntimes_per_group, init_b, init_c)


def smem_bytes(p, nq, nt):
    """Shared memory kernel 4's block stages: the time rows, float32."""
    return (p + nq * p + nq) * nt * 4


# The JAX engine's whole-program gate on a TPU (fabber_core_tpu/ops/
# fused_whole.py n_whole_planes, pick_whole_block; the port's own copy):
# the live planes of a 1,024-voxel tile of the TPU kernel against its
# VMEM budget, with the time axis padded to 8 (fused_vb.py pad_time).
# The port's gate keeps its own limit, shared memory (smem_bytes), up to
# the largest P this admits at any T (whole_cap): past it the port takes
# the JAX engine's route.
def n_whole_planes(p, nq, tp, det=False):
    """Live planes of the JAX whole-program kernel at padded T tp."""
    ntri = p * (p + 1) // 2
    return (4 * tp + 2 * p + (p + nq + nq * p + p)
            + (2 * nq + p + 2 * ntri) + (p + 2 * p * p + 4 * nq) + nq * p
            + ((9 + 2 + (2 * nq + p + 2 * ntri + 1) + 4) if det else 0))


def pick_whole_block(nvoxels, p, nq, tp, det=False):
    """The JAX engine's tile for its whole-program gate, or None where
    none fits (it takes another route)."""
    planes = n_whole_planes(p, nq, tp, det)
    budget = max(VMEM_BUDGET, 12 << 20)
    fitting = [bb for bb in (8192, 4096, 2048, 1024)
               if planes * bb * 4 * 2 <= budget]
    if not fitting:
        return None
    for bb in fitting:
        if nvoxels % bb == 0:
            return bb, 0
    return fitting[-1], (-nvoxels) % fitting[-1]


def pad_time(nt):
    """The JAX kernels' padded time length (a multiple of 8)."""
    return -(-nt // 8) * 8


def whole_cap(nq, det=False):
    """The largest P the JAX whole-program gate admits at any T (at T <=
    8, where the data tile is least): 20 under maxits, 17 under a
    detector."""
    return max(p for p in range(1, 64)
               if pick_whole_block(1024, p, nq, pad_time(1), det)
               is not None)


def tile_weights(p, nq):
    """The staged form's shared floats per sample beside its data tile
    (ops/_cuda.py tile_plan's nq): the P + QP + Q design rows."""
    return p + nq * p + nq


def whole_stats_plain(data, tconsts, consts, p, nq):
    """The in-kernel statistics, plain: data [T,V], tconsts
    (pack_whole_time_consts), consts (pack_whole_consts) -> (m0 [P,V],
    rtqr [Q,V], dtqr [Q,P,V]) in data's dtype."""
    dt, dev = data.dtype, data.device
    tc = tconsts.to(device=dev, dtype=dt)
    dcol = tc[:p]
    dwq = tc[p:p + nq * p].reshape(nq, p, -1)
    qrow = tc[p + nq * p:]
    w = dwq[0]
    for q in range(1, nq):
        w = w + dwq[q]
    dty = w @ data                                           # [P,V]
    dq = consts[:nq * p * p].to(device=dev, dtype=dt).reshape(nq, p, p)
    amat = dq[0]
    for q in range(1, nq):
        amat = amat + dq[q]
    chol, _ = sm.cholesky_jittered(amat[:, :, None])
    m0 = sm.solve_chol_vec(chol, dty)
    ok = torch.all(torch.isfinite(m0), dim=0)
    m0 = torch.where(ok, m0, torch.zeros_like(m0))
    r0 = data - dcol.T @ m0                                  # [T,V]
    rtqr = qrow @ (r0 * r0)                                  # [Q,V]
    dtqr = torch.stack([dwq[q] @ r0 for q in range(nq)])     # [Q,P,V]
    return m0, rtqr, dtqr


def fused_whole_plain(data, tconsts, consts, prior_means, prior_prec,
                      n_iters, locked_noise_stdev=-1.0, detector=None):
    """Plain torch, the whole program: data [T,V], tconsts, consts,
    prior_means/prior_prec [P,V] -> (means [P,V], prec [P,P,V], cov
    [P,P,V], b [Q,V], c [Q,V], fkqk [Q,V], ftr [Q,V]) — or, with a
    detector (the dict of VBInference._nl_fdet_consts), F and the
    iteration count [1,V] in the last two."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    p = prior_means.shape[0]
    nq = (tconsts.shape[0] - p) // (p + 1)
    m0, rtqr, dtqr = whole_stats_plain(data.to(prior_means.dtype), tconsts,
                                       consts, p, nq)
    args, b, c, inv_b0, c_post = loop_inputs(m0, rtqr, dtqr, consts,
                                             prior_means, prior_prec)
    if detector is not None:
        return _whole_detector_plain(args, b, c, inv_b0, c_post,
                                     locked_noise_stdev, n_iters, detector)
    for _ in range(n_iters):
        means, prec, cov, _, b, c, kqk, tr = fixed_point_step(
            *args, b, c, inv_b0, c_post, locked_noise_stdev)
    return (means, prec, cov, torch.stack(b), torch.stack(c),
            torch.stack(kqk), torch.stack(tr))


def _whole_detector_plain(args, b, c, inv_b0, c_post, locked_sd, n_iters,
                          detector):
    """The detector mode of fused_whole_plain (module docstring)."""
    dtqd, m0, rtqr, dtqr, dtqy, pm, pp = args
    p, nq, nv = len(m0), len(rtqr), m0[0].shape[0]
    dt, dev = m0[0].dtype, m0[0].device
    det = detector["det"]
    with_lm = type(det).name == "lm"

    def rnd(x):
        return float(torch.tensor(float(x), dtype=dt))

    lbc = [rnd(x) for x in detector["lb_coeff"]]
    part3 = torch.full((nv,), rnd(detector["f_const"]), dtype=dt,
                       device=dev)
    for i in range(p):
        part3 = part3 + 0.5 * torch.log(pp[i])

    def sel(mask, new, old):
        return torch.where(mask.reshape((1,) * (new.dim() - 1) + (nv,)),
                           new, old)

    zeros_pp = torch.zeros((p, p, nv), dtype=dt, device=dev)
    state = (torch.zeros((p, nv), dtype=dt, device=dev), zeros_pp, zeros_pp,
             torch.stack(b), torch.stack(c),
             torch.full((nv,), 1234.5678, dtype=dt, device=dev))
    best = state[:5] + (torch.zeros((nv,), dtype=dt, device=dev),)
    conv = det.init_state(nv, dt, device=dev)
    # the TPU kernel's sentinel is float32's, at every dtype
    conv = conv._replace(prev_f=torch.full(
        (nv,), float(torch.finfo(torch.float32).min), dtype=dt, device=dev))
    it = 0
    while it < n_iters and not bool(conv.done.all()):
        act = ~conv.done
        best = tuple(sel(act & conv.save, n, o) for n, o in zip(state, best))
        means_c, _, _, b_c, c_c, _ = state
        means, prec, cov, chol, nb, nc, kqk, tr = fixed_point_step(
            dtqd, m0, rtqr, dtqr, dtqy, pm, pp, list(b_c), list(c_c),
            inv_b0, c_post, locked_sd, centre=list(means_c),
            alpha=conv.alpha if with_lm else None)
        logdet = 0.0
        for i in range(p):
            logdet = logdet + 2.0 * torch.log(chol[i, i])
        f = part3 - 0.5 * logdet
        for q in range(nq):
            phi_n = nb[q] * nc[q]
            f = (f + lbc[q] * torch.log(nb[q]) - phi_n * inv_b0[q]
                 - 0.5 * phi_n * kqk[q] - 0.5 * tr[q])
        for i in range(p):
            dm = means[i] - pm[i]
            f = f - 0.5 * (dm * dm + cov[i, i]) * pp[i]
        new = det.test(conv, f)
        conv = type(conv)(*(torch.where(act, n, o)
                            for n, o in zip(new, conv)))
        state = tuple(sel(act, n, o) for n, o in zip(
            (means, prec, cov, torch.stack(nb), torch.stack(nc), f), state))
        it += 1
    # the engine's finalize: best <- final where save, then final <- best
    # where revert
    best = tuple(sel(conv.save, n, o) for n, o in zip(state, best))
    state = tuple(sel(conv.revert, bb, ss) for bb, ss in zip(best, state))
    means, prec, cov, b, c, f = state
    return means, prec, cov, b, c, f[None], conv.its.to(dt)[None]


def fused_whole(data, tconsts, consts, prior_means, prior_prec, n_iters,
                locked_noise_stdev=-1.0, detector=None, _vb=None):
    """The whole program (see fused_whole_plain for the shapes and the
    detector mode). _vb: private, for the tests and chip_smoke.py:
    forces the kernel's form (0 streamed, > 0 staged in blocks of that
    many lanes; ops/_cuda.py launch_vb)."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    kind = None if detector is None else type(detector["det"]).name
    if kind is not None and kind not in DETECTOR_KINDS:
        raise ValueError(f"no detector mode for '{kind}'")
    if prior_means.device.type == "cpu":
        return fused_whole_plain(data, tconsts, consts, prior_means,
                                 prior_prec, n_iters, locked_noise_stdev,
                                 detector)
    dev = prior_means.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for tensors on {dev}")
    p, nv = prior_means.shape
    nt = data.shape[0]
    nq = (tconsts.shape[0] - p) // (p + 1)
    if not whole_instantiated(p, nq):
        raise ValueError(f"no CUDA kernel instantiation for P={p}, Q={nq} "
                         "(csrc/whole_device.cuh FABBER_WHOLE_INSTANCES)")
    if smem_bytes(p, nq, nt) > SMEM_BYTES:
        raise ValueError(f"the time rows ({smem_bytes(p, nq, nt)} bytes) "
                         "do not fit a block's shared memory")
    for t, name, shape in ((data, "data", (nt, nv)),
                           (tconsts, "tconsts", (p + nq * p + nq, nt)),
                           (prior_means, "prior_means", (p, nv)),
                           (prior_prec, "prior_prec", (p, nv))):
        check_plane(t, name, shape, dev)
    check_host_consts(consts, nq * p * p + 4 * nq)

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    fq = nq if kind is None else 1
    outs = (out(p, nv), out(p, p, nv), out(p, p, nv), out(nq, nv),
            out(nq, nv), out(fq, nv), out(fq, nv))
    det_consts = None if kind is None else torch.tensor(
        list(detector["lb_coeff"]) + [detector["f_const"]],
        dtype=torch.float32)
    if nv:
        from . import _cuda
        vb = _cuda.launch_vb(nt, tile_weights(p, nq), _vb)
        if _cuda.launch_whole(p, nq, int(n_iters), float(locked_noise_stdev),
                              consts.to(torch.float32).contiguous(),
                              None if kind is None else detector["det"],
                              det_consts, data, tconsts, prior_means,
                              prior_prec, outs, vb):
            fused_whole.instance_launches += 1
        fused_whole.launches += 1
        if vb > 0:
            fused_whole.staged_launches += 1
        if kind is not None:
            fused_whole.det_launches += 1
        if kind == "lm":
            fused_whole.lm_launches += 1
    return outs


fused_whole.launches = 0
fused_whole.det_launches = 0
fused_whole.lm_launches = 0
fused_whole.staged_launches = 0
fused_whole.instance_launches = 0
