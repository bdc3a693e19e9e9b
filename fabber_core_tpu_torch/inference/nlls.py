"""Batched nonlinear least squares (Levenberg / Levenberg-Marquardt).

Port of fabber_core_tpu/inference/nlls.py (method=nlls; the reference's
inference_nlls.cc:90-293, which drives the MISCMATHS nonlin optimizer
per voxel). All voxels run a damped Gauss-Newton loop at once, voxels
on the last axis, with per-lane damping factors and accept/reject
decisions:

    cost     = ||y - f(p)||^2 (masked timepoints excluded)
    step     solve (J'J + lambda D) delta = J'r
    L mode   D = I        (the reference default)
    LM mode  D = diag(J'J) (--lm)

Posterior: precision = J'J / mse with a 1e-6 diagonal floor
(inference_nlls.cc:175-192); failed lanes get precision 1e-12 I.

Routes (ROUTES), chosen by the JAX engine's gates in its order (its
`auto` as on the TPU), the same way on "cpu" and "cuda":

  nlls-stats    models linear in their untransformed parameters (poly,
                linear): the Jacobian is the constant design D, so the
                loop runs on P-dim planes from one [T,V] pass of
                sufficient statistics (m0, r0'r0, D'r0, D'D), and the
                damped solve is P scalar rationals in the eigenbasis of
                the damp-whitened Gram (host float64). Plain torch: the
                JAX package runs it in XLA, so it has no kernel;
  nlls-kernel   time-local models at float32 with linearization=auto,
                no suppdata, the model-default start and engine-kernel
                auto or pallas-loop: the whole loop in the NLLS kernel
                (ops/fused_nlls.py, csrc/fused_nlls.cu), with the
                two-phase straggler compaction (a phase 1 capped at
                nlls-phase1-iterations, the lanes sorted by their done
                flag, the resumed launch, the inverse permutation);
  nlls-generic  everything else (dtype=double, the CLI default;
                linearization=fd; engine-kernel=xla; an initial
                posterior from a file): the per-iteration loop through
                the Linearizer, plain torch (XLA in the JAX package).

The kernel route is taken where the JAX engine's picker admits kernel 8
(ops/fused_nlls.py pick_nlls_block, the port's copy: P <= 42 at T = 100),
else nlls-generic, as the JAX engine (nlls.py:200-220), on "cpu" and
"cuda" alike. On "cuda" the kernel route needs the model's functor: a
hand-written one (kernel_model()) in a prebuilt instance
(csrc/vb_device.cuh FABBER_NL_INSTANCES) or a per-shape one, built at its
first launch (ops/_cuda.py build_instance "nl"), else one generated from
its time_signal (models/kernelgen.py), built at construction
(ops/_cuda.py build_generated, kernel "nlls"). A run with neither (a
time_signal the generator refuses) raises at construction (vb.py
require_card_instance), never runs plain torch on the card. The
whole volume runs in one pass; the JAX engine's voxel windows
and its per-shard dispatch are not ported (ROADMAP Queue 1 item 18).
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..models.base import resolve_parameters, PRIOR_IMAGE
from ..ops import smallmat as sm
from ..ops.fused_nlls import (LAMBDA_INIT, PREC_DIAG_FLOOR, accept,
                              fused_nlls_loop, pick_nlls_block)
from ..ops.fused_vb import nl_instantiated
from ..ops.fused_whole import pad_time
from ..options import OptionSpec, OPT_BOOL, OPT_INT, OPT_STR
from ..models.kernelgen import derive_time_signal_functor
from .linearize import Linearizer
from .vb import (VBResult, generatable, require_card_instance,
                 supp_plane)

FAIL_PRECISION = 1e-12

# route name -> what it is (the JAX engine's route_description strings)
ROUTES = {
    "nlls-stats": ("fixed-design sufficient-statistics NLLS "
                   "(P-dim LM loop in the damp-whitened eigenbasis)"),
    "nlls-kernel": ("whole-loop nonlinear NLLS kernel "
                    "(in-kernel model re-evaluation)"),
    "nlls-generic": "generic-Jacobian NLLS (per-iteration linearization)",
}


class NLLSState(NamedTuple):
    params: Any  # [P,V] latent
    cost: Any    # [V]
    lam: Any     # [V]
    done: Any    # [V] bool
    its: Any     # [V] optimizer steps per lane (a lane stops counting
                 # once done, inference_nlls.cc:110-153)


class NLLSStats(NamedTuple):
    """Fixed-design sufficient statistics (nlls-stats)."""
    m0: Any    # [P,V] OLS reference point
    rtr: Any   # [V]   r0'r0, r0 = y - D m0 (masked rows zeroed)
    dtr: Any   # [P,V] D'r0
    dtd: Any   # [P,P] D'D (voxel-invariant)


class NLLSInference:
    """method=nlls. Shares the model/linearization stack with VB."""

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("vb-init", OPT_BOOL,
                       "Whether NLLS is being run as a pre-step for VB"),
            OptionSpec("lm", OPT_BOOL,
                       "Use Levenberg-Marquardt damping (default Levenberg)"),
            OptionSpec("nlls-max-iterations", OPT_INT,
                       "Maximum optimizer iterations", default="100"),
            OptionSpec("nlls-phase1-iterations", OPT_INT,
                       "Kernel route: iteration cap of the first "
                       "(full-volume) pass before straggler lanes are "
                       "compacted and resumed (0 disables compaction)",
                       default="32"),
            OptionSpec("fwd-initial-posterior", OPT_STR,
                       "MVN matrix file with initial parameter estimates"),
        ]

    def __init__(self, model, options, data, voxel_data_getter=None,
                 data_plane=None, device="cuda", coords=None,
                 suppdata=None):
        """data [V,T] (voxel-major, as at the API boundary), or
        data_plane a [T,V] tensor already on the device; device "cuda"
        (the kernel) or "cpu" (its plain version); coords [V,3] voxel
        grid coordinates for the model evaluation context (zeros if
        None); suppdata [V,S] per-voxel supplemental data for the
        model's ctx.suppdata, or None."""
        self.model = model
        self.options = options
        self.device = resolve_device(device)
        self.dtype = torch.float64 if options.get_string(
            "dtype", "double") == "double" else torch.float32
        if data_plane is not None:
            if data_plane.device != self.device or data_plane.ndim != 2:
                raise ValueError(f"data_plane must be a [T,V] tensor on "
                                 f"{self.device}")
            self.data = data_plane.to(self.dtype)
        else:
            self.data = torch.as_tensor(np.asarray(data), dtype=self.dtype) \
                .to(self.device).t().contiguous()              # [T,V]
        self.nt, self.nvoxels = self.data.shape
        if coords is None:
            self.coords = torch.zeros((3, self.nvoxels), dtype=self.dtype,
                                      device=self.device)
        else:
            self.coords = torch.as_tensor(
                np.asarray(coords), dtype=self.dtype).t().contiguous().to(
                    self.device)                               # [3,V]
        self.supp = supp_plane(suppdata, self.nvoxels, self.dtype,
                               self.device)                    # [S,V]

        tmask = np.ones(self.nt)
        for t in options.get_int_list("mt", 1):
            tmask[t - 1] = 0.0
        self.tmask_host = tmask                                # [T]
        self.tmask = torch.as_tensor(tmask[:, None], dtype=self.dtype,
                                     device=self.device)       # [T,1]
        self.n_unmasked = int(tmask.sum())

        self.params = resolve_parameters(model, options)
        self.nparams = len(self.params)
        self._voxel_data = voxel_data_getter or _no_voxel_data

        self.marquardt = options.get_bool("lm")
        options.get_bool("vb-init")   # the reference's flag: no effect here
        self.max_its = options.get_int("nlls-max-iterations", 100, minval=1)
        self.phase1_its = options.get_int("nlls-phase1-iterations", 32,
                                          minval=0)
        self.init_file = options.get_string("fwd-initial-posterior",
                                            "modeldefault")

        lin_mode = options.get_string("linearization", "auto")
        self.linearizer = Linearizer(model, self.params, self.nt,
                                     mode=lin_mode)

        # the constant-Jacobian tier's gate (the VB engine's): a model
        # linear in its parameters, identity transforms, autodiff
        # linearization
        self.design = None
        if (lin_mode == "auto"
                and all(pm.transform.is_identity for pm in self.params)):
            d = model.fixed_design(self.nt)
            if d is not None:
                self.design = np.asarray(d, np.float64)

        mode = options.get_string("engine-kernel", "auto")
        if self.design is not None:
            self.route = "nlls-stats"
        elif (hasattr(model, "time_signal") and lin_mode == "auto"
              and self.supp is None
              and self.dtype == torch.float32
              and self.init_file == "modeldefault"
              and mode in ("auto", "pallas-loop")
              and pick_nlls_block(1024, self.nparams,
                                  pad_time(self.nt)) is not None):
            self.route = "nlls-kernel"
        else:
            self.route = "nlls-generic"
        # the NLLS kernel's functor generated from the model's
        # time_signal, where it has no hand-written one (on "cuda")
        self.functor = None
        self._require_kernel_instance()
        if self.route == "nlls-stats":
            self._eig = self._eigenbasis()
        self.progress_cb = None

    def _require_kernel_instance(self):
        """On "cuda" the kernel route needs the NLLS kernel for the
        model's functor: a hand-written one's prebuilt or per-shape
        instance (nl_instantiated; a per-shape one is built at its first
        launch), else a functor generated from the model's time_signal,
        built (or loaded) now into functor.libs[("nlls", None)]; a run
        with neither raises here (require_card_instance), before anything
        is built or launched. On "cpu" the route runs the plain version,
        which takes any time-local model."""
        if self.device.type != "cuda" or self.route != "nlls-kernel":
            return
        has = nl_instantiated(self.model.kernel_model(), None, "nlls")
        functor = None if has else derive_time_signal_functor(
            self.model, self.nparams)
        require_card_instance(
            self.route, self.nparams, None, lambda r: has,
            lambda r: generatable(functor, self.nparams, None, "nlls"))
        if has:
            return
        from ..ops import _cuda
        functor.libs[("nlls", None)] = _cuda.build_generated(
            functor.source, self.nparams, None, "nlls")
        self.functor = functor

    def route_description(self):
        """Which optimizer arithmetic this configuration landed on
        (logged by the runner)."""
        return ROUTES[self.route]

    # -- initial estimates and outputs ------------------------------------
    def initial_means(self):
        """Latent initial estimates [P,V]: the model's posterior defaults
        (image priors from their voxel data), its init_posterior hook,
        or the means of the fwd-initial-posterior MVN file
        (inference_nlls.cc:75-81). Built in the compute dtype, as the
        JAX engine's device path; in float64 where it takes its host
        path (image priors, an initial-posterior file)."""
        v = self.nvoxels
        host = self.init_file != "modeldefault" or any(
            spec.prior_type == PRIOR_IMAGE for spec in self.params)
        wdt = torch.float64 if host else self.dtype
        cols = []
        for spec in self.params:
            if spec.prior_type == PRIOR_IMAGE:
                img = np.asarray(self._voxel_data(spec.options["image"]))
                cols.append(torch.as_tensor(img.reshape(v, -1)[:, 0],
                                            dtype=wdt, device=self.device))
            else:
                cols.append(torch.full((v,), spec.post.mean, dtype=wdt,
                                       device=self.device))
        means = self.model.init_posterior(self.data.t(),
                                          torch.stack(cols, dim=1))
        if self.init_file != "modeldefault":
            from ..io import mvn as mvn_io
            fmeans, _ = mvn_io.load_matrix(self.init_file)
            means = torch.as_tensor(fmeans, dtype=wdt,
                                    device=self.device).expand(v, -1)
        lat = [spec.transform.to_latent(means[:, i])
               for i, spec in enumerate(self.params)]
        return torch.stack(lat).to(self.dtype).contiguous()

    def evaluate_model(self, means_planes):
        """Model prediction [T,V] tensor at latent means [P,V] (for the
        model-fit and residual outputs)."""
        means = torch.as_tensor(means_planes, dtype=self.dtype,
                                device=self.device)
        return self.linearizer.evaluate(means, self.data, self.coords,
                                        self.supp)

    # -- nlls-generic -------------------------------------------------------
    def _cost(self, params):
        pred = self.linearizer.evaluate(params, self.data, self.coords,
                                        self.supp)
        r = (self.data - pred) * self.tmask
        return torch.sum(r * r, dim=0)

    def _jtj_jtr(self, params):
        offset, jac = self.linearizer(params, self.data, self.coords,
                                      self.supp)
        jac = jac * self.tmask[None]
        r = (self.data - offset) * self.tmask
        p = self.nparams
        jtj = torch.stack([
            torch.stack([torch.sum(jac[i] * jac[j], dim=0) for j in range(p)])
            for i in range(p)])
        jtr = torch.stack([torch.sum(jac[i] * r, dim=0) for i in range(p)])
        return jtj, jtr

    def _step(self, s):
        """One damped step of every lane (the JAX engine's _step)."""
        jtj, jtr = self._jtj_jtr(s.params)
        damp = sm.diag_of(jtj) if self.marquardt \
            else torch.ones_like(s.params)
        chol, _ = sm.cholesky_jittered(sm.add_diag(jtj, s.lam[None] * damp))
        trial = s.params + sm.solve_chol_vec(chol, jtr)
        tcost = self._cost(trial)
        take, lam, done = accept(s.cost, tcost, s.lam, s.done)
        return NLLSState(torch.where(take[None], trial, s.params),
                         torch.where(take, tcost, s.cost), lam, done,
                         s.its + (~s.done).to(s.its.dtype))

    def _posterior(self, jtj, cost):
        """precision J'J / mse with the diagonal floor, and its inverse
        (jtj [P,P,V], or [P,P] voxel-invariant)."""
        nv = cost.shape[0]
        if jtj.dim() == 2:
            jtj = jtj[:, :, None].expand(-1, -1, nv)
        mse = cost / (self.n_unmasked - self.nparams)
        prec = jtj / mse[None, None]
        d = torch.maximum(sm.diag_of(prec),
                          torch.full_like(cost, PREC_DIAG_FLOOR)[None])
        eye = torch.eye(self.nparams, dtype=torch.bool,
                        device=prec.device)[:, :, None]
        prec = sm.add_diag(torch.where(eye, torch.zeros_like(prec), prec), d)
        chol, _ = sm.cholesky_jittered(prec)
        return prec, sm.inverse_from_chol(chol)

    def _solve_generic(self, p0):
        nv = self.nvoxels
        s = NLLSState(
            params=p0, cost=self._cost(p0),
            lam=torch.full((nv,), LAMBDA_INIT, dtype=self.dtype,
                           device=self.device),
            done=torch.zeros(nv, dtype=torch.bool, device=self.device),
            its=torch.zeros(nv, dtype=torch.int32, device=self.device))
        it = 0
        while it < self.max_its and not bool(s.done.all()):
            s = self._step(s)
            it += 1
        jtj, _ = self._jtj_jtr(s.params)
        return (s,) + self._posterior(jtj, s.cost)

    # -- nlls-kernel --------------------------------------------------------
    def _solve_kernel(self, p0):
        """The NLLS kernel over the whole volume: one fresh launch, or
        (max its above nlls-phase1-iterations > 0) the two-phase
        straggler compaction — a few degenerate lanes (flat cost
        valleys) would otherwise keep their warps at the iteration cap:
        phase 1 is capped, the lanes are sorted so the unfinished ones
        pack densely, the resumed launch continues each lane's exact
        carry, and the outputs return to voxel order (the fresh run's
        outcome, lane for lane)."""
        tr = [pm.transform for pm in self.params]
        cap = self.phase1_its
        if cap == 0 or self.max_its <= cap:
            params, cost, its, prec, cov = fused_nlls_loop(
                self.model, tr, p0, self.data.contiguous(), self.tmask_host,
                self.max_its, self.marquardt, functor=self.functor)
        else:
            (params1, data1, state1), inv = self._phase1(p0)
            outs = fused_nlls_loop(self.model, tr, params1, data1,
                                   self.tmask_host, self.max_its - cap,
                                   self.marquardt, state=state1,
                                   functor=self.functor)
            params, cost, its, prec, cov = (o[..., inv] for o in outs)
        nv = self.nvoxels
        s = NLLSState(params=params, cost=cost,
                      lam=torch.zeros(nv, dtype=self.dtype,
                                      device=self.device),
                      done=torch.ones(nv, dtype=torch.bool,
                                      device=self.device),
                      its=its.to(torch.int32))
        return s, prec, cov

    def _phase1(self, p0):
        """Phase 1 of the compaction from p0 (capped at
        nlls-phase1-iterations), and the lanes sorted by their done flag
        -> ((params, data, state) of the resumed launch in that order,
        the inverse permutation)."""
        data = self.data.contiguous()
        params1, state1 = fused_nlls_loop(
            self.model, [pm.transform for pm in self.params], p0, data,
            self.tmask_host, self.phase1_its, self.marquardt,
            posterior=False, functor=self.functor)
        order = torch.argsort(state1[2], stable=True)
        return ((params1[:, order].contiguous(), data[:, order].contiguous(),
                 state1[:, order].contiguous()), torch.argsort(order))

    # -- nlls-stats ---------------------------------------------------------
    def _eigenbasis(self):
        """Host float64 eigenbasis of the damp-whitened Gram W D'D W
        (W = damp^-1/2): the eigenvalues, and the maps z = Bz d, the
        gradient's coordinates Bg J'r, d = Bback z."""
        dw = self.design * self.tmask_host[:, None]
        dtd = dw.T @ dw
        damp = np.diag(dtd).copy() if self.marquardt \
            else np.ones(self.nparams)
        w = 1.0 / np.sqrt(np.maximum(damp, 1e-300))
        lam_h, e_h = np.linalg.eigh(w[:, None] * dtd * w[None, :])
        return ([float(x) for x in np.maximum(lam_h, 0.0)],
                e_h.T * (1.0 / w)[None, :], e_h.T * w[None, :],
                w[:, None] * e_h)

    def make_stats(self):
        """One [T,V] pass -> NLLSStats."""
        dw = torch.as_tensor(self.design, dtype=self.dtype,
                             device=self.device) * self.tmask
        yw = self.data * self.tmask
        dtd = dw.t() @ dw
        dty = dw.t() @ yw
        chol, ok = sm.cholesky_jittered(dtd[:, :, None])
        m0 = sm.solve_chol_vec(chol, dty)
        m0 = torch.where(ok & torch.isfinite(m0).all(dim=0), m0,
                         torch.zeros_like(m0))
        r0 = yw - dw @ m0
        return NLLSStats(m0=m0, rtr=torch.sum(r0 * r0, dim=0),
                         dtr=dw.t() @ r0, dtd=dtd)

    def _solve_eigen(self, p0, stats=None):
        """The fixed-design loop in the damp-whitened eigenbasis: P
        independent scalar rationals per lane per step, with the
        accept/reject and convergence tests of the generic route."""
        stats = stats or self.make_stats()
        nv, p = self.nvoxels, self.nparams
        lam_h, bz_h, bg_h, bback_h = self._eig

        def mat(x):
            return torch.as_tensor(x, dtype=self.dtype, device=self.device)

        # the eigenvalues as dtype-rounded scalars (jnp.asarray(x, dt))
        lam_c = [float(torch.tensor(x, dtype=self.dtype)) for x in lam_h]
        u = list(mat(bg_h) @ stats.dtr)
        z = list(mat(bz_h) @ (p0 - stats.m0))
        rtr = stats.rtr

        def cost_of(z):
            c = rtr
            for i in range(p):
                c = c + lam_c[i] * z[i] * z[i] - 2.0 * z[i] * u[i]
            return c

        cost = cost_of(z)
        lam = torch.full((nv,), LAMBDA_INIT, dtype=self.dtype,
                         device=self.device)
        done = torch.zeros(nv, dtype=torch.bool, device=self.device)
        its = torch.zeros(nv, dtype=torch.int32, device=self.device)
        it = 0
        while it < self.max_its and not bool(done.all()):
            trial = [z[i] + (u[i] - lam_c[i] * z[i]) / (lam_c[i] + lam)
                     for i in range(p)]
            tcost = cost_of(trial)
            its = its + (~done).to(its.dtype)
            take, lam, done = accept(cost, tcost, lam, done)
            z = [torch.where(take, trial[i], z[i]) for i in range(p)]
            cost = torch.where(take, tcost, cost)
            it += 1
        params = stats.m0 + mat(bback_h) @ torch.stack(z)
        s = NLLSState(params=params, cost=cost, lam=lam, done=done, its=its)
        return (s,) + self._posterior(stats.dtd, cost)

    # -- the run ------------------------------------------------------------
    def solve(self, p0):
        """The route's loop from the latent start p0 [P,V] -> (NLLSState,
        prec [P,P,V], cov [P,P,V])."""
        if self.route == "nlls-stats":
            return self._solve_eigen(p0)
        if self.route == "nlls-kernel":
            return self._solve_kernel(p0)
        return self._solve_generic(p0)

    def run(self):
        s, _prec, cov = self.solve(self.initial_means())
        if self.progress_cb is not None:
            self.progress_cb(self.nvoxels, self.nvoxels)
        return self._to_result(s, cov)

    def _to_result(self, s, cov):
        means = s.params.t().contiguous().cpu().numpy()           # [V,P]
        cov = cov.permute(2, 0, 1).contiguous().cpu().numpy()     # [V,P,P]
        nv = means.shape[0]
        bad = ~(np.isfinite(means).all(axis=1)
                & np.isfinite(cov).reshape(nv, -1).all(axis=1))
        if bad.any():
            # failed lanes keep their params, precision 1e-12 I
            # (inference_nlls.cc:195-214)
            cov[bad] = np.eye(self.nparams) / FAIL_PRECISION
            means[bad] = np.nan_to_num(means[bad])
        return VBResult(
            means=means, cov=cov,
            noise_means=np.zeros((nv, 0)), noise_cov=np.zeros((nv, 0, 0)),
            free_energy=None, fhistory=None,
            iterations=s.its.cpu().numpy().astype(np.int32),
            bad_voxels=bad)


def _no_voxel_data(key):
    raise KeyError(key)
