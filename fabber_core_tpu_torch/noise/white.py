"""White-noise model in SoA layout.

Port of fabber_core_tpu/noise/white.py: the noise pattern and
masked-timepoint setup, the hardcoded initial distributions
(noisemodel_white.cc:127-164), MVN (de)serialization, the VB updates
with the LM-damped theta update (noisemodel_white.cc:228-454) from
per-voxel Jacobian planes or, on the fixed-design direct route, from the
design, the free energy, and the fixed-design
sufficient-statistics route: make_design_stats (the statistics, in
plain torch as the JAX package leaves them to XLA; also the float64
parity reference of the statistics kernels), update_theta_stats with its
LM branch, update_noise_stats, free_energy_stats and design_stats_voxel.

Array shapes: data [T,V], design [T,P], Jacobian [P,T,V], noise state
b/c [Q,V] (the prior's [Q,1]).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core.dists import gamma_mean, gamma_var, gamma_from_mean_var
from ..exceptions import FabberError, InvalidOptionValue
from ..ops import smallmat as sm
from ..options import OptionSpec, OPT_STR, OPT_FLOAT
from .base import NoiseModel, register_noise


class WhiteNoiseState(NamedTuple):
    b: torch.Tensor  # [Q, V]
    c: torch.Tensor  # [Q, V]


class DesignStats(NamedTuple):
    """Sufficient statistics for fixed-design VB, taken about a
    per-voxel ordinary-least-squares reference point m0 so that k'Qk
    assembles from residual-scale terms."""
    m0: torch.Tensor    # [P,V]   OLS reference point
    rtqr: torch.Tensor  # [Q,V]   r0' Q_i r0,  r0 = y - D m0
    dtqr: torch.Tensor  # [Q,P,V] D' Q_i r0
    dtqd: torch.Tensor  # [Q,P,P] D' Q_i D


def parse_noise_pattern(pattern, nt):
    """Expand a pattern string to a group index per timepoint.

    Characters 1-9 then A-Z/a-z index phi groups from 1
    (noisemodel_white.cc:166-201). Returns int array [nt] of 0-based
    group ids and the number of groups.
    """
    if len(pattern) == 0:
        raise InvalidOptionValue("noise-pattern", pattern, "Empty pattern")
    if len(pattern) > nt:
        raise InvalidOptionValue("noise-pattern", pattern,
                                 "Pattern length exceeds data length")
    ids = []
    for ch in pattern:
        if "1" <= ch <= "9":
            n = ord(ch) - ord("0")
        elif "A" <= ch <= "Z":
            n = ord(ch) - ord("A") + 10
        elif "a" <= ch <= "z":
            n = ord(ch) - ord("a") + 10
        else:
            raise InvalidOptionValue("noise-pattern", ch, "Invalid character")
        ids.append(n - 1)
    nq = max(ids) + 1
    full = [ids[i % len(ids)] for i in range(nt)]
    return np.array(full, dtype=np.int32), nq


@register_noise
class WhiteNoiseModel(NoiseModel):
    name = "white"
    supports_fixed_design = True

    def __init__(self, options, nt, masked_tpoints=()):
        super().__init__(options, nt, masked_tpoints)
        pattern = options.get_string("noise-pattern", "1")
        group_ids, self.nphis = parse_noise_pattern(pattern, nt)

        # Indicator masks Q_i [Q, T]; masked timepoints belong to no group
        unmasked = np.ones(nt, dtype=bool)
        for t in self.masked_tpoints:  # 1-indexed
            unmasked[t - 1] = False
        self.qmasks = np.zeros((self.nphis, nt))
        for t in range(nt):
            if unmasked[t]:
                self.qmasks[group_ids[t], t] = 1.0
        self.ntimes_per_group = self.qmasks.sum(axis=1)  # Qi.Trace()
        self.n_unmasked = int(unmasked.sum())

        self.locked_noise_stdev = options.get_float("locked-noise-stdev", -1.0)
        self.phiprior = options.get_float("prior-noise-stddev", -1.0)
        if self.phiprior < 0 and self.phiprior != -1:
            raise InvalidOptionValue("prior-noise-stddev", self.phiprior, "Must be > 0")

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("noise-pattern", OPT_STR,
                       "Repeating pattern of noise variances for each point "
                       "(e.g. 12 gives odd/even different variances)", default="1"),
            OptionSpec("locked-noise-stdev", OPT_FLOAT,
                       "Fix noise std dev to this value", default="-1"),
            OptionSpec("prior-noise-stddev", OPT_FLOAT,
                       "Prior noise std dev", default="-1"),
        ]

    @property
    def num_params(self):
        return self.nphis

    # -- state ------------------------------------------------------------
    def initial_state(self, nvoxels, dtype, device="cpu"):
        """Hardcoded initial dists (noisemodel_white.cc:127-164). The
        prior is voxel-uniform: a [Q,1] plane that broadcasts."""
        if self.phiprior == -1:
            prior_b, prior_c = 1e6, 1e-6
            # tiny initial noise precision helps (reference's observation)
            post_b, post_c = 1e-8, 50.0
        else:
            prior_c = post_c = 0.5
            prior_b = post_b = 1.0 / (self.phiprior ** 2 * prior_c)

        def full(shape, val):
            return torch.full(shape, val, dtype=dtype, device=device)

        prior = WhiteNoiseState(full((self.nphis, 1), prior_b),
                                full((self.nphis, 1), prior_c))
        shape = (self.nphis, nvoxels)
        return prior, WhiteNoiseState(full(shape, post_b), full(shape, post_c))

    def state_to_mvn(self, state):
        """-> (means [V,Q], cov [V,Q,Q]) numpy, for serialization."""
        b = np.asarray(state.b.cpu() if torch.is_tensor(state.b) else state.b)
        c = np.asarray(state.c.cpu() if torch.is_tensor(state.c) else state.c)
        means = gamma_mean(b, c).T
        var = gamma_var(b, c).T
        v, q = means.shape
        cov = np.zeros((v, q, q), means.dtype)
        cov[:, np.arange(q), np.arange(q)] = var
        return means, cov

    def state_from_mvn(self, means, cov):
        cov = np.asarray(cov)
        offdiag = cov - np.einsum("vij,ij->vij", cov,
                                  np.eye(cov.shape[-1]))
        if cov.shape[-1] > 1 and np.any(offdiag != 0.0):
            raise FabberError("Phis should have zero covariance!")
        var = np.diagonal(cov, axis1=-2, axis2=-1)
        b, c = gamma_from_mean_var(np.asarray(means).T, var.T)
        return WhiteNoiseState(torch.as_tensor(b), torch.as_tensor(c))

    # -- VB updates of the generic-Jacobian route ---------------------------
    def phi_timepoint_weights(self, state):
        """X diagonal [T,V]: E[phi] at each unmasked timepoint."""
        phimeans = gamma_mean(state.b, state.c)  # [Q,V]
        q = torch.as_tensor(self.qmasks, dtype=state.b.dtype,
                            device=state.b.device)  # [Q,T]
        return torch.einsum("qt,qv->tv", q, phimeans)

    def update_theta(self, noise_post, means, prior_means, prior_prec,
                     centre, offset, jac, data, lm_alpha=None, design=None):
        """Eq 19/20: returns (new_means [P,V], prec, cov [P,P,V], ok
        [V]), from per-voxel Jacobian planes jac [P,T,V] or, on the
        fixed-design direct route, the design [T,P] (jac unused: J is
        the design). lm_alpha [V] (the lm detector's damping) takes the
        Levenberg-Marquardt step where it is > 0."""
        x = self.phi_timepoint_weights(noise_post)   # [T,V]
        if design is not None:
            ltmp = torch.einsum("tp,tq,tv->pqv", design, design, x)
            resid = data - offset + design @ centre
            m_tmp = design.T @ (x * resid)
        else:
            p = jac.shape[0]
            jx = jac * x[None]                           # [P,T,V]
            ltmp = torch.stack([
                torch.stack([torch.sum(jx[i] * jac[j], dim=0)
                             for j in range(p)])
                for i in range(p)])                      # [P,P,V]
            resid = data - offset + torch.einsum("ptv,pv->tv", jac, centre)
            m_tmp = torch.einsum("ptv,tv->pv", jx, resid)

        prec = sm.add_diag(ltmp, prior_prec)
        chol, ok = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        rhs = m_tmp + prior_prec * prior_means
        # the reference's op order: covariance, then multiply
        new_means = sm.matvec_planes(cov, rhs)

        if lm_alpha is not None:
            # Levenberg-Marquardt damped update (Appendix C form)
            if design is not None:
                jxr = design.T @ (x * (data - offset))
            else:
                jxr = torch.einsum("ptv,tv->pv", jx, data - offset)
            delta = jxr + prior_prec * prior_means - prior_prec * centre
            damped = sm.add_diag(prec, lm_alpha[None] * sm.diag_of(prec))
            dchol, dok = sm.cholesky_jittered(damped)
            lm_means = centre + sm.solve_chol_vec(dchol, delta)
            use_lm = lm_alpha > 0.0
            new_means = torch.where(use_lm[None], lm_means, new_means)
            ok = torch.where(use_lm, dok, ok)
        return new_means, prec, cov, ok

    def _group_quadratics(self, k, cov, jac, design=None):
        """Per phi group: (k'Q k [V], tr(Sigma J'Q J) [V]) lists; with
        a design, J'Q_i J is the constant [P,P] design Gram."""
        kqk, trace = [], []
        for i in range(self.nphis):
            qi = torch.as_tensor(self.qmasks[i], dtype=k.dtype,
                                 device=k.device)[:, None]  # [T,1]
            kqk.append(torch.sum(k * k * qi, dim=0))
            tr = 0.0
            if design is not None:
                g = torch.einsum("tp,tq->pq", design * qi, design)
                p = design.shape[1]
                for a in range(p):
                    for b in range(p):
                        tr = tr + g[a, b] * cov[a, b]
            else:
                p = jac.shape[0]
                for a in range(p):
                    for b in range(p):
                        g_ab = torch.sum(jac[a] * jac[b] * qi, dim=0)
                        tr = tr + cov[a, b] * g_ab
            trace.append(tr)
        return kqk, trace

    def _residual_at(self, means, centre, offset, jac, data, design=None):
        """k = y - g(centre) + J (centre - means) [T,V]."""
        if design is not None:
            return data - offset + design @ (centre - means)
        return data - offset + torch.einsum("ptv,pv->tv", jac,
                                            centre - means)

    def update_noise(self, noise_post, noise_prior, means, cov,
                     centre, offset, jac, data, design=None):
        """Eq 21/22 per phi group; returns the new WhiteNoiseState."""
        k = self._residual_at(means, centre, offset, jac, data, design)
        kqk, trace = self._group_quadratics(k, cov, jac, design)
        return self._noise_from_quadratics(kqk, trace, noise_prior)

    def _noise_from_quadratics(self, kqk, trace, noise_prior):
        new_b, new_c = [], []
        for i in range(self.nphis):
            tmp = kqk[i] + trace[i]
            b = 1.0 / (tmp * 0.5 + 1.0 / noise_prior.b[i])
            c = torch.full_like(
                b, (float(self.ntimes_per_group[i]) - 1) * 0.5) \
                + noise_prior.c[i]
            if self.locked_noise_stdev > 0:
                b = 1.0 / c / self.locked_noise_stdev ** 2
            new_b.append(b)
            new_c.append(c)
        return WhiteNoiseState(torch.stack(new_b), torch.stack(new_c))

    def free_energy(self, noise_post, noise_prior, means, prec, cov,
                    prior_means, prior_prec, centre, offset, jac, data,
                    design=None):
        """Full ELBO (noisemodel_white.cc:365-454). Returns F [V]."""
        k = self._residual_at(means, centre, offset, jac, data, design)
        kqk, trace = self._group_quadratics(k, cov, jac, design)
        return self.free_energy_from_parts(
            noise_post, noise_prior, means, prec, cov,
            prior_means, prior_prec, kqk, trace)

    def free_energy_from_parts(self, noise_post, noise_prior, means, prec,
                               cov, prior_means, prior_prec, kqk, trace):
        """ELBO assembly given the per-group quadratics k'Q_ik and
        tr(J'Q_iJ Sigma) (noisemodel_white.cc:365-454)."""
        dtype, dev = means.dtype, means.device
        p, nv = means.shape
        log2pi = float(np.log(2 * np.pi))

        chol, _ = sm.cholesky_jittered(prec)
        logdet_prec = sm.logdet_from_chol(chol)
        exp_log_theta_dist = 0.5 * logdet_prec - 0.5 * p * (log2pi + 1.0)

        exp_log_phi_dist = torch.zeros(nv, dtype=dtype, device=dev)
        part0 = torch.zeros_like(exp_log_phi_dist)
        part2 = torch.zeros_like(exp_log_phi_dist)
        part9 = torch.zeros_like(exp_log_phi_dist)
        for i in range(self.nphis):
            si, ci = noise_post.b[i], noise_post.c[i]
            si0, ci0 = noise_prior.b[i], noise_prior.c[i]
            dg_ls = torch.special.digamma(ci) + torch.log(si)
            exp_log_phi_dist = exp_log_phi_dist + (
                -torch.lgamma(ci) - ci * torch.log(si) - ci
                + (ci - 1.0) * dg_ls)
            part0 = part0 + dg_ls * (
                float(self.ntimes_per_group[i]) * 0.5 + ci0 - 1.0)
            part9 = part9 + (-torch.lgamma(ci0) - ci0 * torch.log(si0)
                             - si * ci / si0)
            # the trace term carries no phi weighting, as in the
            # reference (noisemodel_white.cc:413-417)
            part2 = part2 + (-0.5 * si * ci * kqk[i] - 0.5 * trace[i])

        part3 = (0.5 * torch.sum(torch.log(prior_prec), dim=0)
                 - 0.5 * self.n_unmasked * log2pi - 0.5 * p * log2pi)
        dm = means - prior_means
        part4 = -0.5 * torch.sum(dm * prior_prec * dm, dim=0)
        part5 = -0.5 * torch.sum(sm.diag_of(cov) * prior_prec, dim=0)

        return (-exp_log_theta_dist - exp_log_phi_dist
                + part0 + part2 + part3 + part4 + part5 + part9)

    # -- sufficient-statistics route (fixed design) -------------------------
    def _group_quadratics_stats(self, means, cov, stats):
        """(k'Q_i k, tr(Sigma J'Q_i J)) from sufficient statistics:
        k = y - D means = r0 - D (means - m0)."""
        delta = means - stats.m0  # [P,V]
        p = means.shape[0]
        kqk, trace = [], []
        for i in range(self.nphis):
            cross = sum(delta[a] * stats.dtqr[i, a] for a in range(p))
            quad = 0.0
            tr = 0.0
            for a in range(p):
                for b in range(p):
                    quad = quad + stats.dtqd[i, a, b] * delta[a] * delta[b]
                    tr = tr + stats.dtqd[i, a, b] * cov[a, b]
            # true k'Qk >= 0; clamp away the tiny negative rounding tail
            kqk.append(torch.clamp(stats.rtqr[i] - 2.0 * cross + quad,
                                   min=0.0))
            trace.append(tr)
        return kqk, trace

    @staticmethod
    def design_stats_voxel(stats, v):
        """Voxel v's slice of the statistics ([..., 1] planes; the
        Gauss-Seidel sweep's per-voxel update)."""
        return DesignStats(m0=stats.m0[:, v:v + 1],
                           rtqr=stats.rtqr[:, v:v + 1],
                           dtqr=stats.dtqr[..., v:v + 1], dtqd=stats.dtqd)

    def update_theta_stats(self, noise_post, prior_means, prior_prec,
                           stats, lm_alpha=None, centre=None):
        """Eq 19/20 from sufficient statistics: update_theta's
        arithmetic up to the exact cancellation of the linearization
        offset (noisemodel_white.cc:275-363). Returns (new_means [P,V],
        prec, cov [P,P,V], ok [V]); lm_alpha [V] takes the damped step
        about centre [P,V] where it is > 0."""
        phim = gamma_mean(noise_post.b, noise_post.c)  # [Q,V]
        dtqd = stats.dtqd.to(phim.dtype)
        ltmp = torch.einsum("iab,iv->abv", dtqd, phim)
        # D'Q_i y = D'Q_i r0 + (D'Q_i D) m0
        dtqy = stats.dtqr + torch.einsum("iab,bv->iav", dtqd, stats.m0)
        m_tmp = torch.einsum("iv,ipv->pv", phim, dtqy)

        prec = sm.add_diag(ltmp, prior_prec)
        chol, ok = sm.cholesky_jittered(prec)
        cov = sm.inverse_from_chol(chol)
        rhs = m_tmp + prior_prec * prior_means
        new_means = sm.matvec_planes(cov, rhs)

        if lm_alpha is not None:
            # J'X(y - D centre) = sum_i phi_i (D'Q_i r0 - D'Q_i D (c-m0))
            dc = centre - stats.m0
            jxr = torch.einsum(
                "iv,ipv->pv", phim,
                stats.dtqr - torch.einsum("iab,bv->iav", dtqd, dc))
            delta = jxr + prior_prec * prior_means - prior_prec * centre
            damped = sm.add_diag(prec, lm_alpha[None] * sm.diag_of(prec))
            dchol, dok = sm.cholesky_jittered(damped)
            lm_means = centre + sm.solve_chol_vec(dchol, delta)
            use_lm = lm_alpha > 0.0
            new_means = torch.where(use_lm[None], lm_means, new_means)
            ok = torch.where(use_lm, dok, ok)
        return new_means, prec, cov, ok

    def update_noise_stats(self, noise_post, noise_prior, means, cov, stats):
        """Eq 21/22 per phi group from sufficient statistics."""
        kqk, trace = self._group_quadratics_stats(means, cov, stats)
        return self._noise_from_quadratics(kqk, trace, noise_prior)

    def free_energy_stats(self, noise_post, noise_prior, means, prec, cov,
                          prior_means, prior_prec, stats):
        """F from sufficient statistics (noise/white.py
        free_energy_stats of the JAX package)."""
        kqk, trace = self._group_quadratics_stats(means, cov, stats)
        return self.free_energy_from_parts(
            noise_post, noise_prior, means, prec, cov,
            prior_means, prior_prec, kqk, trace)

    def make_design_stats(self, design, data):
        """One-time reductions for the fixed-design route.

        design [T,P], data [T,V] tensors -> DesignStats, computed in
        the promoted dtype of data and float32 (float64 data stays
        float64: the parity reference for the statistics kernel).
        """
        dtype = torch.promote_types(data.dtype, torch.float32)
        dev = data.device
        data = data.to(dtype)
        design = design.to(device=dev)
        q = torch.as_tensor(self.qmasks, dtype=dtype, device=dev)  # [Q,T]
        dtqd = torch.einsum("it,tp,tq->ipq", q.to(design.dtype), design,
                            design)

        # OLS reference point over unmasked timepoints; lanes where the
        # normal matrix fails to factor fall back to m0 = 0 (raw
        # expansion — still correct, just less cancellation headroom)
        w = torch.sum(q, dim=0)  # [T] 0/1
        dty = (design * w[:, None].to(design.dtype)).T @ data  # [P,V]
        chol, ok = sm.cholesky_jittered(torch.sum(dtqd, dim=0)[:, :, None])
        m0 = sm.solve_chol_vec(chol, dty)
        keep = ok & torch.all(torch.isfinite(m0), dim=0)
        m0 = torch.where(keep, m0, torch.zeros_like(m0))

        r0 = data - design @ m0  # [T,V]
        ones_mask = [bool(np.all(self.qmasks[i] == 1.0))
                     for i in range(self.nphis)]
        rtqr = torch.stack([
            torch.sum(r0 * r0 if ones_mask[i]
                      else q[i][:, None] * r0 * r0, dim=0)
            for i in range(self.nphis)])
        dtqr = torch.stack([
            design.T @ (r0 if ones_mask[i] else q[i][:, None] * r0)
            for i in range(self.nphis)])
        return DesignStats(m0=m0, rtqr=rtqr, dtqr=dtqr, dtqd=dtqd)
