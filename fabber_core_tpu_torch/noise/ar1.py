"""AR(1) autoregressive noise model with optional cross-terms.

Port of fabber_core_tpu/noise/ar1.py (the reference's Ar1cNoiseModel,
noisemodel_ar.cc): AR(1) noise for 1-2 interleaved echoes, AR
coefficients alpha inferred as a small MVN per voxel, Gamma-distributed
precisions phi per echo, and the banded "alpha matrix" algebra of the
MATLAB NPINTS derivation.

The reference materializes T x T banded matrices per voxel
(noisemodel_ar.cc:83-224). Every such matrix is a global pattern — one
(symmetrized) shifted diagonal with entries at (a + i*s, b + i*s),
i = 0..nTimes-2, s = n_echoes — so every quadratic form it enters is a
strided correlation over [T,V] planes:

    k' M k             = w * (2 - [a==b]) * sum_i k[a+is] k[b+is]
    (J' M J)[p,q]      = w * (sum_i Jp[a+is] Jq[b+is] (+ mirrored))
    tr(C J' M J)       = sum_pq C[pq] (J' M J)[q,p]

and the per-voxel alpha marginals Q_n = sum_j coeff_nj(alpha) M_j are
never formed: their coefficients multiply the per-matrix reductions. No
T x T object exists. The operation order is the JAX package's, so the
two agree at float64 to roundoff.

State: alpha means [A,V] + covariance and precision [A,A,V] (A = 2/3/4
for cross-terms none/same/dual), phi b/c [Q,V]; the prior's voxel axis
is a singleton.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.dists import gamma_mean, gamma_var, gamma_from_mean_var
from ..exceptions import InvalidOptionValue
from ..ops import smallmat as sm
from ..options import OptionSpec, OPT_STR, OPT_INT
from .base import NoiseModel, register_noise

# voxels per pass of make_design_stats (bounds its [T,V] temporaries)
STATS_CHUNK = 1 << 20


class Ar1NoiseState(NamedTuple):
    alpha_means: torch.Tensor  # [A,V]
    alpha_cov: torch.Tensor    # [A,A,V]
    alpha_prec: torch.Tensor   # [A,A,V]
    b: torch.Tensor            # [Q,V]
    c: torch.Tensor            # [Q,V]


class Ar1DesignStats(NamedTuple):
    """Fixed-design sufficient statistics, one entry per basis matrix
    M_s (the flattened (echo, alpha-power) spec list): with a constant
    design D every banded quadratic form reduces to r0' M_s r0 /
    D' M_s r0 / D' M_s D about the OLS reference point m0
    (k = r0 - D (means - m0))."""
    m0: torch.Tensor   # [P,V]
    rmr: torch.Tensor  # [S,V]
    dmr: torch.Tensor  # [S,P,V]
    dmd: torch.Tensor  # [S,P,P]


class BandSpec(NamedTuple):
    """One global alpha matrix: entries w at (a+i*s, b+i*s), 0-based,
    symmetrized when a != b (noisemodel_ar.cc:104-180)."""
    a: int
    b: int
    w: float


def _band_spec(n, a12pow, a34pow, nphis):
    """Start positions for matrix (n, a12pow, a34pow) in the interleaved
    echo layout (noisemodel_ar.cc:126-171): the reference's 1-based rows,
    converted to 0-based."""
    table = {
        (0, 0): (1 + nphis, 1 + nphis),
        (1, 0): (1, 1 + nphis),
        (2, 0): (1, 1),
        (0, 1): (4, 3),
        (1, 1): (4, 1),
        (0, 2): (4, 4),
    }
    row, col = table[(a12pow, a34pow)]
    if n == 2:
        # swap odd/even rows: 2m -> 2m-1, 2m-1 -> 2m
        row = row - 1 + 2 * (row % 2)
        col = col - 1 + 2 * (col % 2)
    value = -1.0 if (a12pow + a34pow) == 1 else 1.0
    return BandSpec(row - 1, col - 1, value)


@register_noise
class Ar1NoiseModel(NoiseModel):
    name = "ar"
    # fixed-design support is statistics-only: there is no direct design
    # route for AR noise (the engine drops the design for
    # fixed-design-route=direct and takes the generic route)
    supports_fixed_design = True
    fixed_design_direct = False

    def __init__(self, options, nt, masked_tpoints=()):
        super().__init__(options, nt, masked_tpoints)
        if masked_tpoints:
            raise InvalidOptionValue(
                "mt1", "", "Masked time points are not supported for the "
                "AR noise model")
        self.nphis = options.get_int("num-echoes", 1)
        self.ar1_type = options.get_string("ar1-cross-terms", "none")
        if self.ar1_type == "same":
            self.nalphas = 3
        elif self.ar1_type == "dual":
            self.nalphas = 4
        elif self.ar1_type == "none":
            self.nalphas = 2
        else:
            raise InvalidOptionValue("ar1-cross-terms", self.ar1_type,
                                     "Must be dual, same or none")
        if self.nphis == 1:
            if self.ar1_type != "none":
                raise InvalidOptionValue(
                    "ar1-cross-terms", self.ar1_type,
                    "You must use ar1-cross-terms=none with num-echoes=1")
        elif self.nphis != 2:
            raise InvalidOptionValue("num-echoes", self.nphis,
                                     "Must be 1 or 2")
        if nt % self.nphis != 0:
            raise InvalidOptionValue(
                "num-echoes", self.nphis,
                f"Data length {nt} not divisible by number of echoes")
        self.ntimes = nt // self.nphis  # samples per echo
        self._basis = {}
        for n in range(1, self.nphis + 1):
            specs = [(0, 0), (1, 0), (2, 0)]
            if self.nalphas >= 3:
                specs += [(0, 1), (1, 1), (0, 2)]
            self._basis[n] = {(a12, a34): _band_spec(n, a12, a34, self.nphis)
                              for a12, a34 in specs}
        # flat spec ordering of the sufficient-statistics route
        self._spec_list = [(n, key) for n in range(1, self.nphis + 1)
                           for key in self._basis[n]]

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("num-echoes", OPT_INT,
                       "Number of interleaved echoes", default="1"),
            OptionSpec("ar1-cross-terms", OPT_STR,
                       "Type of cross-linking between echoes "
                       "(dual, same or none)", default="none"),
        ]

    @property
    def num_params(self):
        """Noise parameters serialized into result MVNs: the alpha MVN,
        then the phis (Ar1cParams::OutputAsMVN)."""
        return self.nalphas + self.nphis

    # -- state ------------------------------------------------------------
    def initial_state(self, nvoxels, dtype, device="cpu"):
        """Hardcoded dists (noisemodel_ar.cc:379-403) + the Precalculate
        phi_c adjustment (noisemodel_ar.cc:749-768). The prior is
        voxel-uniform: singleton voxel axis."""
        a, q, v = self.nalphas, self.nphis, nvoxels

        def eye(scale, n):
            e = torch.zeros((a, a, n), dtype=dtype, device=device)
            for i in range(a):
                e[i, i] = scale
            return e

        def full(shape, val):
            return torch.full(shape, val, dtype=dtype, device=device)

        prior = Ar1NoiseState(
            alpha_means=full((a, 1), 0.0), alpha_cov=eye(1e4, 1),
            alpha_prec=eye(1e-4, 1), b=full((q, 1), 1e6),
            c=full((q, 1), 1e-6))
        # posterior phi_c starts at prior_c + (nTimes-1)/2 so the first
        # phi update does not cause an artificial F drop
        post = Ar1NoiseState(
            alpha_means=full((a, v), 0.0), alpha_cov=eye(1e4, v),
            alpha_prec=eye(1e-4, v), b=full((q, v), 1e-8),
            c=full((q, v), 1e-6 + (self.ntimes - 1) * 0.5))
        return prior, post

    def state_to_mvn(self, state):
        """-> (means [V,A+Q], cov [V,A+Q,A+Q]) numpy: the alpha MVN, then
        the phis' Gamma means and variances."""
        def host(x):
            return x.detach().cpu().numpy() if torch.is_tensor(x) \
                else np.asarray(x)
        am = host(state.alpha_means).T                   # [V,A]
        ac = np.moveaxis(host(state.alpha_cov), -1, 0)   # [V,A,A]
        b, c = host(state.b), host(state.c)
        pm = gamma_mean(b, c).T
        pv = gamma_var(b, c).T
        v = am.shape[0]
        a, q = self.nalphas, self.nphis
        means = np.concatenate([am, pm], axis=1)
        cov = np.zeros((v, a + q, a + q))
        cov[:, :a, :a] = ac
        cov[:, a + np.arange(q), a + np.arange(q)] = pv
        return means, cov

    def state_from_mvn(self, means, cov):
        """(means [V,A+Q], cov [V,A+Q,A+Q]) -> the state, host tensors in
        the arrays' dtype; the alpha precision is the jittered Cholesky
        inverse of the alpha covariance."""
        means = torch.as_tensor(np.asarray(means))
        cov = torch.as_tensor(np.asarray(cov))
        a = self.nalphas
        am = means[:, :a].t().contiguous()
        ac = cov[:, :a, :a].permute(1, 2, 0).contiguous()
        chol, _ = sm.cholesky_jittered(ac)
        ap = sm.inverse_from_chol(chol)
        pvar = torch.diagonal(cov[:, a:, a:], dim1=-2, dim2=-1)
        b, c = gamma_from_mean_var(means[:, a:].t(), pvar.t())
        return Ar1NoiseState(am, ac, ap, b.contiguous(), c.contiguous())

    # -- banded quadratic forms -------------------------------------------
    def _corr(self, u, w, a, b):
        """sum_i u[a+i*s] * w[b+i*s] over [T,V] planes -> [V]."""
        s = self.nphis
        n = self.ntimes - 1
        return torch.sum(u[a:a + n * s:s] * w[b:b + n * s:s], dim=0)

    def _kmk(self, k, spec):
        mult = 1.0 if spec.a == spec.b else 2.0
        return spec.w * mult * self._corr(k, k, spec.a, spec.b)

    def _jmj(self, jac, spec):
        """(J' M J)[p,q] planes: [P,P,V]."""
        p = jac.shape[0]
        rows = []
        for i in range(p):
            row = []
            for j in range(p):
                v = self._corr(jac[i], jac[j], spec.a, spec.b)
                if spec.a != spec.b:
                    v = v + self._corr(jac[i], jac[j], spec.b, spec.a)
                row.append(spec.w * v)
            rows.append(torch.stack(row))
        return torch.stack(rows)

    def _jmr(self, jac, r, spec):
        """(J' M r)[p] planes: [P,V]."""
        out = []
        for i in range(jac.shape[0]):
            v = self._corr(jac[i], r, spec.a, spec.b)
            if spec.a != spec.b:
                v = v + self._corr(jac[i], r, spec.b, spec.a)
            out.append(spec.w * v)
        return torch.stack(out)

    @staticmethod
    def _trace_form(cpl, jmj_planes):
        """tr(C J'MJ) from covariance planes [P,P,V]."""
        p = cpl.shape[0]
        s = 0.0
        for i in range(p):
            for j in range(p):
                s = s + cpl[i, j] * jmj_planes[j, i]
        return s

    def _marginal_coeffs(self, state):
        """Per-voxel coefficients of Q_n = sum_j coeff_j * M_j
        (noisemodel_ar.cc:197-222): {n: {(a12,a34): [V]}}."""
        mu = state.alpha_means
        cov_plus = state.alpha_cov + mu[:, None, :] * mu[None, :, :]
        coeffs = {}
        for n in range(1, self.nphis + 1):
            cn = {(0, 0): torch.ones_like(mu[0]),
                  (1, 0): mu[n - 1],
                  (2, 0): cov_plus[n - 1, n - 1]}
            if self.nalphas >= 3:
                t = (2 + n if self.nalphas == 4 else 3) - 1  # 0-based
                cn[(0, 1)] = mu[t]
                cn[(1, 1)] = cov_plus[n - 1, t]
                cn[(0, 2)] = cov_plus[t, t]
            coeffs[n] = cn
        return coeffs

    # -- sufficient-statistics route (fixed design) -------------------------
    def _shifted_design(self, design, spec):
        """[P,T]: row i weighs r0 into (D'M r0)_i = w (sum_k d_i[a+ks]
        r0[b+ks] (+ the mirror a <-> b when a != b))."""
        s, n = self.nphis, self.ntimes - 1
        rows = torch.zeros((design.shape[1], self.nt), dtype=design.dtype,
                           device=design.device)
        rows[:, spec.b:spec.b + n * s:s] = design[spec.a:spec.a + n * s:s].t()
        if spec.a != spec.b:
            rows[:, spec.a:spec.a + n * s:s] += \
                design[spec.b:spec.b + n * s:s].t()
        return spec.w * rows

    def make_design_stats(self, design, data, chunk=STATS_CHUNK):
        """One-time banded reductions for the fixed-design route: design
        [T,P], data [T,V] -> Ar1DesignStats, in the promoted dtype of the
        two (and at least float32).

        Memory: the voxels go in chunks of `chunk`, so at most one
        chunk's r0 and one [T-1, chunk] product for r0'M_s r0 exist
        beside the data and the outputs; D'M_s r0 is one matrix product
        of the shifted design rows (_shifted_design) against the chunk's
        r0, never a [T-1,V] product. m0, r0'M_s r0 and D'M_s D follow the
        JAX package's operation order."""
        dtype = torch.promote_types(
            torch.promote_types(data.dtype, torch.float32), design.dtype)
        dev = data.device
        design = design.to(device=dev, dtype=dtype)
        p, nv = design.shape[1], data.shape[1]
        specs = [self._basis[n][key] for n, key in self._spec_list]

        # OLS reference point (unweighted; cancellation control only)
        chol, ok = sm.cholesky_jittered((design.T @ design)[:, :, None])
        wrows = torch.cat([self._shifted_design(design, sp) for sp in specs])
        dmd = []
        for spec in specs:
            rows_d = []
            for i in range(p):
                di = design[:, i:i + 1]
                row = []
                for j in range(p):
                    dj = design[:, j:j + 1]
                    e = self._corr(di, dj, spec.a, spec.b)[0]
                    if spec.a != spec.b:
                        e = e + self._corr(di, dj, spec.b, spec.a)[0]
                    row.append(spec.w * e)
                rows_d.append(torch.stack(row))
            dmd.append(torch.stack(rows_d))

        m0 = torch.empty((p, nv), dtype=dtype, device=dev)
        rmr = torch.empty((len(specs), nv), dtype=dtype, device=dev)
        dmr = torch.empty((len(specs), p, nv), dtype=dtype, device=dev)
        for lo in range(0, nv, chunk):
            y = data[:, lo:lo + chunk].to(dtype)
            m = sm.solve_chol_vec(chol, design.T @ y)
            m = torch.where(ok & torch.all(torch.isfinite(m), dim=0), m, 0.0)
            r0 = y - design @ m   # [T,chunk]
            del y
            m0[:, lo:lo + chunk] = m
            for s, spec in enumerate(specs):
                rmr[s, lo:lo + chunk] = self._kmk(r0, spec)
            dmr[:, :, lo:lo + chunk] = (wrows @ r0).reshape(len(specs), p, -1)
        return Ar1DesignStats(m0=m0, rmr=rmr, dmr=dmr, dmd=torch.stack(dmd))

    def _stats_quadratics(self, means, cov, stats):
        """Per spec s: (k'M_s k, tr(cov J'M_s J)) from the statistics,
        k = r0 - D (means - m0)."""
        delta = means - stats.m0  # [P,V]
        p = means.shape[0]
        kmk, tr = {}, {}
        for s, sk in enumerate(self._spec_list):
            cross = sum(delta[a] * stats.dmr[s, a] for a in range(p))
            quad = 0.0
            t = 0.0
            for a in range(p):
                for b in range(p):
                    quad = quad + stats.dmd[s, a, b] * delta[a] * delta[b]
                    t = t + stats.dmd[s, a, b] * cov[a, b]
            kmk[sk] = stats.rmr[s] - 2.0 * cross + quad
            tr[sk] = t
        return kmk, tr

    @staticmethod
    def design_stats_voxel(stats, v):
        """Voxel v's slice of the statistics ([..., 1] planes; the
        Gauss-Seidel sweep's per-voxel update)."""
        return Ar1DesignStats(m0=stats.m0[:, v:v + 1],
                              rmr=stats.rmr[:, v:v + 1],
                              dmr=stats.dmr[..., v:v + 1], dmd=stats.dmd)

    def update_theta_stats(self, noise_post, prior_means, prior_prec,
                           stats, lm_alpha=None, centre=None):
        """Eq 19/20 from the statistics (update_theta's arithmetic up to
        the exact offset cancellation). lm_alpha is ignored: the LM
        variant is not defined for AR noise, in the reference either."""
        si_ci = gamma_mean(noise_post.b, noise_post.c)
        coeffs = self._marginal_coeffs(noise_post)
        p, nv = prior_means.shape
        ltmp = torch.zeros((p, p, nv), dtype=prior_means.dtype,
                           device=prior_means.device)
        m_tmp = torch.zeros_like(prior_means)
        for s, (n, key) in enumerate(self._spec_list):
            w = si_ci[n - 1] * coeffs[n][key]  # [V]
            ltmp = ltmp + w[None, None] * stats.dmd[s][:, :, None]
            # D'M y = D'M r0 + (D'M D) m0
            dmy = stats.dmr[s] + torch.einsum("ab,bv->av", stats.dmd[s],
                                              stats.m0)
            m_tmp = m_tmp + w[None] * dmy
        prec = sm.add_diag(ltmp, prior_prec)
        chol, ok = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        rhs = m_tmp + prior_prec * prior_means
        return sm.matvec_planes(cov, rhs), prec, cov, ok

    def update_noise_stats(self, noise_post, noise_prior, means, cov,
                           stats):
        """UpdateAlpha + UpdatePhi from the statistics."""
        kmk, tr = self._stats_quadratics(means, cov, stats)
        op = {sk: kmk[sk] + tr[sk] for sk in kmk}
        return self._alpha_phi_update(noise_post, noise_prior, means, op)

    def free_energy_stats(self, noise_post, noise_prior, means, prec, cov,
                          prior_means, prior_prec, stats):
        kmk, tr = self._stats_quadratics(means, cov, stats)
        si_ci = gamma_mean(noise_post.b, noise_post.c)
        coeffs = self._marginal_coeffs(noise_post)
        kqk = torch.zeros_like(means[0])
        trq = torch.zeros_like(means[0])
        for n, key in self._spec_list:
            w = si_ci[n - 1] * coeffs[n][key]
            kqk = kqk + w * kmk[(n, key)]
            trq = trq + w * tr[(n, key)]
        return self._free_energy_tail(noise_post, noise_prior, means, prec,
                                      cov, prior_means, prior_prec, kqk, trq)

    # -- VB updates of the generic-Jacobian route ---------------------------
    def update_theta(self, noise_post, means, prior_means, prior_prec,
                     centre, offset, jac, data, lm_alpha=None):
        """Eq 19/20 with X = sum_n E[phi_n] Q_n (noisemodel_ar.cc:
        558-634) on Jacobian planes jac [P,T,V]; lm_alpha is ignored, as
        the reference ignores LMalpha here."""
        si_ci = gamma_mean(noise_post.b, noise_post.c)  # [Q,V]
        coeffs = self._marginal_coeffs(noise_post)
        p = jac.shape[0]
        ltmp = torch.zeros((p, p, means.shape[1]), dtype=means.dtype,
                           device=means.device)
        resid = data - offset + torch.einsum("ptv,pv->tv", jac, centre)
        m_tmp = torch.zeros_like(means)
        for n in range(1, self.nphis + 1):
            for key, spec in self._basis[n].items():
                w = si_ci[n - 1] * coeffs[n][key]  # [V]
                ltmp = ltmp + w[None, None] * self._jmj(jac, spec)
                m_tmp = m_tmp + w[None] * self._jmr(jac, resid, spec)
        prec = sm.add_diag(ltmp, prior_prec)
        chol, ok = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        rhs = m_tmp + prior_prec * prior_means
        return sm.matvec_planes(cov, rhs), prec, cov, ok

    def update_noise(self, noise_post, noise_prior, means, cov,
                     centre, offset, jac, data):
        """UpdateAlpha then UpdatePhi (noisemodel_ar.cc:405-556)."""
        k = data - offset + torch.einsum("ptv,pv->tv", jac, centre - means)
        # OpKLJ(M) = k'Mk + tr(cov J'MJ) for each basis matrix
        op = {}
        for n in range(1, self.nphis + 1):
            for key, spec in self._basis[n].items():
                op[(n, key)] = (self._kmk(k, spec) + self._trace_form(
                    cov, self._jmj(jac, spec)))
        return self._alpha_phi_update(noise_post, noise_prior, means, op)

    def _alpha_phi_update(self, noise_post, noise_prior, means, op):
        si_ci = gamma_mean(noise_post.b, noise_post.c)
        a = self.nalphas
        nv = means.shape[1]

        # -- alpha precision update (noisemodel_ar.cc:466-500)
        aprec = noise_prior.alpha_prec.expand(a, a, nv).clone()
        for n in range(1, self.nphis + 1):
            aprec[n - 1, n - 1] = aprec[n - 1, n - 1] \
                + si_ci[n - 1] * op[(n, (2, 0))]
        if a > 2:
            t = a - 1  # 0-based index of the last alpha
            for i, j, q, key, f in ((2, 0, 0, (1, 1), 0.5),
                                    (0, 2, 0, (1, 1), 0.5),
                                    (t, 1, 1, (1, 1), 0.5),
                                    (1, t, 1, (1, 1), 0.5),
                                    (2, 2, 0, (0, 2), 1.0),
                                    (t, t, 1, (0, 2), 1.0)):
                aprec[i, j] = aprec[i, j] + f * si_ci[q] * op[(q + 1, key)]
        achol, _ = sm.cholesky_jittered(aprec)
        acov = sm.inverse_from_chol(achol)

        # -- alpha means update (noisemodel_ar.cc:501-513)
        tmp = sm.matvec_planes(noise_prior.alpha_prec,
                               noise_prior.alpha_means).expand(a, nv).clone()
        for n in range(1, self.nphis + 1):
            tmp[n - 1] = tmp[n - 1] + (-0.5 * si_ci[n - 1] * op[(n, (1, 0))])
        if a > 2:
            t = a - 1
            tmp[2] = tmp[2] + (-0.5 * si_ci[0] * op[(1, (0, 1))])
            tmp[t] = tmp[t] + (-0.5 * si_ci[1] * op[(2, (0, 1))])
        ameans = sm.matvec_planes(acov, tmp)
        new_alpha = noise_post._replace(alpha_means=ameans, alpha_cov=acov,
                                        alpha_prec=aprec)

        # -- phi update with the new alpha marginals
        # (noisemodel_ar.cc:530-556)
        coeffs = self._marginal_coeffs(new_alpha)
        new_b, new_c = [], []
        for n in range(1, self.nphis + 1):
            tmp_n = 0.0
            for key in self._basis[n]:
                tmp_n = tmp_n + coeffs[n][key] * op[(n, key)]
            b = 1.0 / (tmp_n * 0.5 + 1.0 / noise_prior.b[n - 1])
            c = torch.full_like(b, (self.ntimes - 1) * 0.5) \
                + noise_prior.c[n - 1]
            new_b.append(b)
            new_c.append(c)
        return new_alpha._replace(b=torch.stack(new_b), c=torch.stack(new_c))

    def free_energy(self, noise_post, noise_prior, means, prec, cov,
                    prior_means, prior_prec, centre, offset, jac, data):
        """Full ELBO, the reference's NPINTS port (noisemodel_ar.cc:
        643-747)."""
        k = data - offset + torch.einsum("ptv,pv->tv", jac, centre - means)
        si_ci = gamma_mean(noise_post.b, noise_post.c)
        coeffs = self._marginal_coeffs(noise_post)
        # k' Qsum k and tr(J' Qsum J Linv) via the basis decomposition
        kqk = torch.zeros_like(means[0])
        trq = torch.zeros_like(means[0])
        for n in range(1, self.nphis + 1):
            for key, spec in self._basis[n].items():
                w = si_ci[n - 1] * coeffs[n][key]
                kqk = kqk + w * self._kmk(k, spec)
                trq = trq + w * self._trace_form(cov, self._jmj(jac, spec))
        return self._free_energy_tail(noise_post, noise_prior, means, prec,
                                      cov, prior_means, prior_prec, kqk, trq)

    def _free_energy_tail(self, noise_post, noise_prior, means, prec, cov,
                          prior_means, prior_prec, kqk, trq):
        n_theta = means.shape[0]
        a = self.nalphas
        log2pi = math.log(2 * math.pi)

        achol, _ = sm.cholesky_jittered(noise_post.alpha_prec)
        exp_alpha = (0.5 * sm.logdet_from_chol(achol)
                     - 0.5 * a * (log2pi + 1.0))
        tchol, _ = sm.cholesky_jittered(prec)
        exp_theta = (0.5 * sm.logdet_from_chol(tchol)
                     - 0.5 * n_theta * (log2pi + 1.0))

        exp_phi = torch.zeros_like(means[0])
        part0 = torch.zeros_like(exp_phi)
        part9 = torch.zeros_like(exp_phi)
        for i in range(self.nphis):
            si, ci = noise_post.b[i], noise_post.c[i]
            si0, ci0 = noise_prior.b[i], noise_prior.c[i]
            dg_ls = torch.special.digamma(ci) + torch.log(si)
            exp_phi = exp_phi + (-torch.lgamma(ci) - ci * torch.log(si) - ci
                                 + (ci - 1.0) * dg_ls)
            part0 = part0 + dg_ls * ((self.ntimes - 1) * 0.5 + ci0 - 1.0)
            part9 = part9 + (-2.0 * torch.lgamma(ci0)
                             - 2.0 * ci0 * torch.log(si0) - si * ci / si0)

        part1 = -log2pi * ((self.ntimes - 1) + 0.5 * a + 0.5 * n_theta)
        part2 = -0.5 * kqk - 0.5 * trq
        part3 = 0.5 * torch.sum(torch.log(prior_prec), dim=0)
        dm = means - prior_means
        part4 = -0.5 * torch.sum(dm * prior_prec * dm, dim=0)
        part5 = -0.5 * torch.sum(sm.diag_of(cov) * prior_prec, dim=0)
        pchol, _ = sm.cholesky_jittered(noise_prior.alpha_prec)
        part6 = 0.5 * sm.logdet_from_chol(pchol)
        da = noise_post.alpha_means - noise_prior.alpha_means
        part7 = -0.5 * torch.einsum(
            "av,av->v", da, sm.matvec_planes(noise_prior.alpha_prec, da))
        part8 = -0.5 * self._trace_form(noise_post.alpha_cov,
                                        noise_prior.alpha_prec)
        return (-exp_alpha - exp_theta - exp_phi
                + part0 + part1 + part2 + part3 + part4 + part5
                + part6 + part7 + part8 + part9)
