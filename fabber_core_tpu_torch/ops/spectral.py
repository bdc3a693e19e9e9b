"""Spectral (eigenbasis) fixed point for fixed-design white-noise VB.

Port of fabber_core_tpu/ops/spectral.py. For a fixed design D, white
noise with a SINGLE phi group and voxel-uniform prior precisions, one
VB iteration is

    prec   = phi * A + diag(pp),      A = D'QD   (constant)
    means  = prec^-1 (phi * u_y + pp*pm)
    kqk    = r'Qr - 2 d'u_0 + d'A d,  d = means - m0
    tr     = tr(prec^-1 A)
    phi'   = c_post / (0.5*(kqk + tr) + 1/b0)

(noisemodel_white.cc Eq 19-22 via the sufficient-statistics form).
Whitening by W = diag(pp)^-1/2 and diagonalizing the CONSTANT matrix
W A W = E diag(lam) E' turns every iteration into P independent scalar
rationals per voxel:

    denom_i = phi*lam_i + 1
    mt_i    = (phi*ut_i + vt_i) / denom_i          (means, eigenbasis)
    tr      = sum_i lam_i / denom_i
    quad    = sum_i lam_i * (mt_i - m0t_i)^2
    cross   = sum_i (mt_i - m0t_i) * u0t_i

The eigendecomposition of the P x P constant runs in float64 numpy on
the host. make_spectral_loop below is the plain-torch algebraic
reference for the core CUDA kernel (ops/fused_spectral.py
spectral_core): same algebra, torch matmuls for the rotations. With
make_spectral_detector_loop (the F-based detectors) it also carries the
engine's `spectral` route, which the JAX package runs in XLA with no
Pallas kernel: the route's runs are those the core kernel's gate
refuses (bf16 storage, P above its instances, a design too long for
shared memory) or engine-kernel=spectral asks for.
"""

import math

import numpy as np
import torch
from scipy.special import digamma as _digamma, gammaln as _gammaln


def spectral_basis(design_host, qmask_host, pp_host):
    """Host-side f64 eigendecomposition of the whitened design Gram.

    design [T,P], qmask [T] 0/1 (single phi group), pp [P] prior
    precisions. Returns (A [P,P], lam [P], ew [P,P], winv [P]) where
    ew = W @ E (the means reconstruction operator), winv = 1/sqrt(pp)
    = W's diagonal, and columns of E are eigenvectors of W A W.
    """
    d = np.asarray(design_host, np.float64)
    q = np.asarray(qmask_host, np.float64)
    pp = np.asarray(pp_host, np.float64).reshape(-1)
    a = d.T @ (q[:, None] * d)
    w = 1.0 / np.sqrt(pp)
    lam, e = np.linalg.eigh(w[:, None] * a * w[None, :])
    lam = np.maximum(lam, 0.0)  # Gram matrix: clip f64 roundoff
    return a, lam, w[:, None] * e, w


def make_spectral_loop(design_host, qmask_host, pp_host, n_iters,
                       init_b, init_c, inv_b0, c_post):
    """Build fn(m0 [P,V], rtqr [1,V] or [V], dtqr [P,V], pm [P,V])
    -> (means [P,V], prec [P,P,V], cov [P,P,V], b [1,V], c [1,V]).

    All inputs are the single-group white DesignStats planes; pm is
    the (possibly voxelwise, e.g. image-prior) prior means. Runs in the
    inputs' dtype on the inputs' device.
    """
    a_h, lam_h, ew_h, winv_h = spectral_basis(design_host, qmask_host,
                                              pp_host)
    p = a_h.shape[0]
    pp_h = np.asarray(pp_host, np.float64).reshape(-1)
    e_h = ew_h / winv_h[:, None]                       # E (host)

    def run(m0, rtqr, dtqr, pm):
        dt, dev = m0.dtype, m0.device

        def c(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                                   device=dev)

        ew = c(ew_h)                                   # W E
        etw = c(ew_h.T)                                # E' W
        etwi = c((e_h / winv_h[:, None]).T)            # E' W^-1
        a = c(a_h)
        pp = c(pp_h)[:, None]                          # [P,1]
        rtqr = rtqr.reshape(-1)
        dtqy = dtqr + a @ m0                           # D'Qy  [P,V]
        ut = list(etw @ dtqy)
        u0t = list(etw @ dtqr)
        vt = list(etw @ (pp * pm))
        m0t = list(etwi @ m0)
        lam = [float(torch.tensor(float(x), dtype=dt)) for x in lam_h]
        s0 = torch.full_like(rtqr, float(init_b) * float(init_c))
        ib0 = float(torch.tensor(float(inv_b0), dtype=dt))
        cpost = float(torch.tensor(float(c_post), dtype=dt))

        def quadratics(s):
            cross = 0.0
            quad = 0.0
            tr = 0.0
            mt = []
            for i in range(p):
                rden = 1.0 / (s * lam[i] + 1.0)
                mt_i = (s * ut[i] + vt[i]) * rden
                d_ = mt_i - m0t[i]
                cross = cross + d_ * u0t[i]
                quad = quad + lam[i] * d_ * d_
                tr = tr + lam[i] * rden
                mt.append(mt_i)
            return mt, cross, quad, tr

        s = s0
        for _ in range(n_iters - 1):
            _, cross, quad, tr = quadratics(s)
            kqk = torch.clamp(rtqr - 2.0 * cross + quad, min=0.0)
            s = 1.0 / ((kqk + tr) * 0.5 + ib0) * cpost
        # the last iteration's posterior is reconstructed from the
        # phi that produced it (s entering iteration n)
        mt, cross, quad, tr = quadratics(s)
        means = ew @ torch.stack(mt)
        rden = torch.stack([1.0 / (s * lam[i] + 1.0) for i in range(p)])
        cov = torch.einsum("ik,jk,kv->ijv", ew, ew, rden)
        kqk = torch.clamp(rtqr - 2.0 * cross + quad, min=0.0)
        b = (1.0 / ((kqk + tr) * 0.5 + ib0))[None, :]
        cc = torch.full_like(b, cpost)
        prec = (s[None, None, :] * a[:, :, None]
                + torch.eye(p, dtype=dt, device=dev)[:, :, None]
                * pp[:, None])
        return means, prec, cov, b, cc

    return run


def eigen_elbo_const(qmask_host, c_post, c0, b0, p):
    """Host-f64 constant block of the eigenbasis ELBO (derivation in
    fabber_core_tpu/ops/spectral.py make_spectral_detector_loop).
    Rides into the core kernel's constant block (F output)."""
    t_n = float(np.asarray(qmask_host, np.float64).sum())
    cpost_f = float(c_post)
    return (0.5 * p - 0.5 * t_n * math.log(2 * math.pi)
            + float(_gammaln(cpost_f)) + cpost_f
            + 0.5 * float(_digamma(cpost_f))
            - float(_gammaln(float(c0)))
            - float(c0) * math.log(float(b0)))


def make_spectral_detector_loop(design_host, qmask_host, pp_host, detector,
                                max_iter_cap, init_b, init_c, inv_b0,
                                c_post, b0, c0):
    """The spectral fixed point under an F-based detector (pointzeroone
    / freduce / trialmode), fabber_core_tpu/ops/spectral.py
    make_spectral_detector_loop: the detector's lane state machines run
    on the eigenbasis ELBO inside the loop, each lane's save/revert
    state being the phi that generated its posterior. The algebra and
    the loop are the core kernel's detector mode, whose plain version
    (ops/fused_spectral.py spectral_core_plain) runs here on the
    statistics the caller made.

    Returns fn(m0 [P,V], rtqr [1,V], dtqr [P,V], pm [P,V]) ->
    (means [P,V], prec [P,P,V], cov [P,P,V], b [1,V], sel_init [V]
    bool, its [V] int32): lanes with sel_init select the engine's
    initial posterior, which is off the spectral manifold, and must be
    restored by the caller.
    """
    from .fused_spectral import pack_spectral_consts, spectral_core_plain
    design = np.asarray(design_host, np.float64)
    nt, p = design.shape
    elbo_extra = (eigen_elbo_const(qmask_host, c_post, c0, b0, p),
                  float(c_post) + 0.5)
    consts = pack_spectral_consts(design, qmask_host, nt, pp_host, inv_b0,
                                  c_post, init_b, init_c, torch.float64,
                                  elbo_extra)

    def run(m0, rtqr, dtqr, pm):
        means, prec, cov, b, _, _, its = spectral_core_plain(
            m0, rtqr.reshape(1, -1), dtqr, pm, consts, max_iter_cap,
            detector)
        return (means, prec, cov, torch.abs(b), b[0] < 0,
                its[0].to(torch.int32))

    return run
