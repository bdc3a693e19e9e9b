"""Batched Variational Bayes engine (voxelwise mode), SoA layout.

Port of the part of fabber_core_tpu/inference/vb.py that the
fixed-design main path runs: every voxel is a lane of [..., V] planes
(posterior means [P,V], precision/covariance [P,P,V], noise [Q,V]), and
the run is the JAX package's whole-program spectral route
(_compiled_loop_spectral_whole, vb.py:1611-1866, split form): one
statistics kernel reads the [T,V] data, one core kernel runs the
maxits fixed point in the whitened design eigenbasis and writes the
posterior (ops/fused_spectral.py).

Routes are one named table (ROUTES) instead of the JAX engine's dozen
interacting use_* flags (vb.py:340-660). The port has one live route,
"spectral-whole"; _select_route applies the JAX gates of that route
(vb.py:408-420, 465-467, 568-581) and a run those gates would send
elsewhere raises NotImplementedError naming the JAX route it needs.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..exceptions import InvalidOptionValue
from ..models.base import resolve_parameters, PRIOR_IMAGE
from ..noise import get_noise_class
from ..noise.white import WhiteNoiseState
from ..ops import smallmat as sm
from ..ops.fused_spectral import (MAX_P, pack_mxu_consts, pack_solve_consts,
                                  pack_spectral_consts, spectral_core,
                                  spectral_stats)
from ..ops.spectral import eigen_elbo_const
from ..options import OptionSpec, OPT_STR, OPT_INT, OPT_BOOL, OPT_MVN
from .convergence import get_detector_class
from .priors import PriorSetup

# Named route table: JAX route name -> (what it is, None if ported here
# else the ROADMAP item that ports it). Names follow the JAX package's
# --engine-kernel values and route_description strings.
ROUTES = {
    "spectral-whole": (
        "whole-program spectral route (CUDA statistics kernel + "
        "eigenbasis core kernel)", None),
    "xla": ("fixed-design sufficient-statistics route (XLA)",
            "ROADMAP Queue 1 item 8"),
    "xla-direct": ("fixed-design direct route (XLA)",
                   "ROADMAP Queue 1 item 8"),
    "xla-generic": ("generic-Jacobian XLA route",
                    "ROADMAP Queue 1 item 13"),
    "spectral": ("spectral eigenbasis fixed point (pure XLA)",
                 "ROADMAP Queue 1 item 8"),
    "spectral-xstats": ("XLA statistics + spectral core kernel "
                        "(spectral-impl=xstats)", "ROADMAP Queue 1 item 8"),
    "spectral-fused": ("one-kernel spectral form (spectral-impl=fused)",
                       "ROADMAP Queue 2 item 3"),
    "pallas-whole": ("whole-program fixed-design kernel (multi-group / "
                     "locked noise)", "ROADMAP Queue 2 item 4"),
    "pallas-loop": ("whole-loop fixed-design / nonlinear kernel",
                    "ROADMAP Queue 2 items 5, 6, 9"),
    "pallas": ("per-iteration fused kernel (time_signal mode)",
               "ROADMAP Queue 2 item 7"),
    "motion-correction": ("VB with interleaved motion correction "
                          "(mcsteps > 0)", "ROADMAP Queue 1 item 17"),
    "noprior-output": ("likelihood-only posterior output "
                       "(spatial-prior-output-correction)",
                       "ROADMAP Queue 1 item 17"),
}
LIVE_ROUTE = "spectral-whole"


class PosteriorState(NamedTuple):
    means: Any       # [P,V] latent
    prec: Any        # [P,P,V]
    cov: Any         # [P,P,V]
    prior_means: Any  # [P,V]
    prior_prec: Any  # [P,V] diagonal prior precision
    noise: Any       # noise-model state (WhiteNoiseState)


class VBLoopState(NamedTuple):
    it: int          # iterations run
    post: PosteriorState
    f: Any           # [V] free energy
    conv: Any        # ConvState


class VBResult(NamedTuple):
    means: np.ndarray        # [V,P] latent posterior means
    cov: np.ndarray          # [V,P,P]
    noise_means: np.ndarray  # [V,Q]
    noise_cov: np.ndarray    # [V,Q,Q]
    free_energy: np.ndarray  # [V] or None
    fhistory: np.ndarray     # [iters,V] or None
    iterations: np.ndarray   # [V]
    bad_voxels: np.ndarray   # [V] bool
    # likelihood-only posterior (thetaWithoutPrior, set only under
    # --spatial-prior-output-correction; noisemodel.h:132)
    noprior_means: np.ndarray = None  # [V,P] or None
    noprior_cov: np.ndarray = None    # [V,P,P] or None


class VBInference:
    """Voxelwise VB (method=vb) on the spectral-whole route."""

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("noise", OPT_STR, "Noise model to use (white or ar1)", True),
            OptionSpec("convergence", OPT_STR,
                       "Name of method for detecting convergence", default="maxits"),
            OptionSpec("max-iterations", OPT_INT,
                       "Iterations for the maxits convergence detector", default="10"),
            OptionSpec("min-fchange", OPT_STR,
                       "Change in F to stop at (fchange detector)", default="0.01"),
            OptionSpec("max-trials", OPT_STR,
                       "Max trials after F reduction (trialmode)", default="10"),
            OptionSpec("print-free-energy", OPT_BOOL, "Output the free energy"),
            OptionSpec("continue-from-mvn", OPT_MVN,
                       "Continue previous run from output MVN files"),
            OptionSpec("output-only", OPT_BOOL,
                       "Skip model fitting, just output requested data from supplied MVN"),
            OptionSpec("noise-pattern", OPT_STR,
                       "Repeating noise-variance pattern", default="1"),
            OptionSpec("allow-bad-voxels", OPT_BOOL,
                       "Continue if numerical error found in a voxel"),
            OptionSpec("linearization", OPT_STR,
                       "Jacobian source: auto or fd", default="auto"),
            OptionSpec("save-free-energy-history", OPT_BOOL,
                       "Record free energy at every iteration"),
            OptionSpec("noise-initial-prior", OPT_STR,
                       "MVN matrix file for the initial noise prior"),
            OptionSpec("noise-initial-posterior", OPT_STR,
                       "MVN matrix file for the initial noise posterior"),
            OptionSpec("locked-linear-from-mvn", OPT_MVN,
                       "MVN data containing fixed centres for linearization"),
            OptionSpec("spatial-prior-output-correction", OPT_BOOL,
                       "Also output the likelihood-only posterior"),
            OptionSpec("mcsteps", OPT_INT,
                       "Number of motion correction steps", default="0"),
            OptionSpec("engine-kernel", OPT_STR,
                       "Iteration route: auto or spectral-whole (the "
                       "port's one live route; the JAX package's other "
                       "route names raise)", default="auto"),
            OptionSpec("fixed-design-route", OPT_STR,
                       "Fixed-design update arithmetic: stats", default="stats"),
            OptionSpec("spectral-impl", OPT_STR,
                       "Whole-program spectral kernel form: split",
                       default="split"),
        ]

    def __init__(self, model, options, data, voxel_data_getter=None,
                 data_plane=None, device="cuda"):
        """data [V,T] (voxel-major, as at the API boundary; uploaded,
        then transposed to [T,V] on the device).

        data_plane: a [T,V] tensor already on the device, used as is
        instead of `data` (e.g. a volume generated on the card).
        device: "cuda" (the kernels) or "cpu" (their plain versions);
        "cuda" without a card raises.
        """
        self.model = model
        self.options = options
        self.device = resolve_device(device)
        dstr = options.get_string("dtype", "double")
        if dstr not in ("double", "single", "bf16"):
            raise InvalidOptionValue("dtype", dstr,
                                     "Must be double, single or bf16")
        self.dtype = torch.float64 if dstr == "double" else torch.float32
        self.store_dtype = torch.bfloat16 if dstr == "bf16" else self.dtype

        if data_plane is not None:
            if data_plane.device != self.device or data_plane.ndim != 2:
                raise ValueError(f"data_plane must be a [T,V] tensor on "
                                 f"{self.device}")
            self.data = data_plane
        else:
            host = torch.as_tensor(np.asarray(data), dtype=self.store_dtype)
            self.data = host.to(self.device).t().contiguous()   # [T,V]
        self.nt, self.nvoxels = self.data.shape

        self.params = resolve_parameters(model, options)
        self.nparams = len(self.params)

        noise_cls = get_noise_class(options.get_string("noise"))
        self.noise = noise_cls(options, self.nt,
                               options.get_int_list("mt", 1))

        conv_name = options.get_string("convergence", "maxits")
        self.detector = get_detector_class(conv_name)(options)

        self.need_f = (self.detector.uses_f
                       or options.get_bool("print-free-energy")
                       or options.get_bool("save-free-energy")
                       or options.get_bool("save-free-energy-history"))
        self.save_fhist = options.get_bool("save-free-energy-history")

        self._voxel_data = voxel_data_getter or _no_voxel_data
        self.prior_setup = PriorSetup(self.params, self._voxel_data,
                                      self.nvoxels, self.dtype, self.device)

        # constant design [T,P] (float64 host) for models linear in
        # their untransformed parameters
        lin_mode = options.get_string("linearization", "auto")
        self.design = None
        if (getattr(self.noise, "supports_fixed_design", False)
                and lin_mode == "auto"
                and all(pm.transform.is_identity for pm in self.params)):
            d = model.fixed_design(self.nt)
            if d is not None:
                self.design = np.asarray(d, np.float64)

        self.route = self._select_route()
        desc, todo = ROUTES[self.route]
        if todo is not None:
            raise NotImplementedError(
                f"this run needs the JAX package's '{self.route}' route "
                f"({desc}), which is not ported to fabber_core_tpu_torch "
                f"yet ({todo}); the port runs only '{LIVE_ROUTE}'")
        self.noise_prior = None
        self.progress_cb = None

    def _select_route(self):
        """Name of the route this run needs (a key of ROUTES): the JAX
        spectral-whole gates, in the JAX engine's order."""
        o = self.options
        mode = o.get_string("engine-kernel", "auto")
        impl = o.get_string("spectral-impl", "split")
        if o.get_int("mcsteps", 0) > 0:
            return "motion-correction"
        if o.get_bool("spatial-prior-output-correction"):
            return "noprior-output"
        if mode not in ("auto", LIVE_ROUTE):
            if mode not in ROUTES:
                raise InvalidOptionValue("engine-kernel", mode,
                                         "Unknown engine route")
            return mode
        if self.design is None:
            return "xla-generic"
        if o.get_string("fixed-design-route", "stats") != "stats":
            return "xla-direct"
        # loop_gates_common (vb.py:410-420)
        if (self.dtype != torch.float32
                or o.get_string("continue-from-mvn", "") != ""
                or self.save_fhist
                or self.prior_setup.has_ard
                or self.prior_setup.spatial_params
                or o.get_string("locked-linear-from-mvn", "") != ""
                or o.get_string("noise-initial-posterior",
                                "modeldefault") != "modeldefault"):
            return "xla"
        # spectral_ok (vb.py:465-467): one phi group, unlocked stdev
        if self.noise.nphis != 1 or self.noise.locked_noise_stdev > 0:
            return "pallas-whole"
        # f32 storage (vb.py:574) and the kernels' size gate (the JAX
        # VMEM gate, vb.py:577-581): P <= 8 template instantiations, the
        # (2P+1) x T constant rows in one block's shared memory
        if (self.store_dtype != torch.float32 or self.nparams > MAX_P
                or (2 * self.nparams + 1) * self.nt * 4 > 232448):
            return "spectral"
        if impl != "split":
            return {"xstats": "spectral-xstats",
                    "fused": "spectral-fused"}.get(impl, "spectral-fused")
        return LIVE_ROUTE

    def route_description(self):
        """Human-readable name of the selected update route (logged by
        the runner)."""
        return ROUTES[self.route][0]

    def evaluate_model(self, means_planes):
        """Model prediction [T,V] tensor at latent means [P,V]."""
        d = torch.as_tensor(self.design, dtype=self.dtype, device=self.device)
        return d @ torch.as_tensor(means_planes, dtype=self.dtype,
                                   device=self.device)

    # -- initial state ----------------------------------------------------
    def initial_posterior(self):
        """Latent-space initial posterior (fwdmodel.cc:284-313):
        means [P,V], prec [P,P,V], cov [P,P,V] on the device."""
        v = self.nvoxels
        cols = []
        for spec in self.params:
            if spec.prior_type == PRIOR_IMAGE:
                img = np.asarray(self._voxel_data(spec.options["image"]))
                cols.append(torch.as_tensor(img.reshape(v, -1)[:, 0],
                                            dtype=self.dtype,
                                            device=self.device))
            else:
                cols.append(torch.full((v,), spec.post.mean, dtype=self.dtype,
                                       device=self.device))
        means_vox = torch.stack(cols, dim=1)  # [V,P] model space
        means_vox = self.model.init_posterior(self.data.t(), means_vox)

        lmeans, lvars = [], []
        for i, spec in enumerate(self.params):
            var = torch.full((v,), spec.post.var, dtype=self.dtype,
                             device=self.device)
            m, lv = spec.transform.to_latent_moments(means_vox[:, i], var)
            lmeans.append(m.to(self.dtype))
            lvars.append(lv.to(self.dtype))
        lmeans = torch.stack(lmeans)
        lvars = torch.stack(lvars)
        return lmeans, sm.diag_planes(1.0 / lvars), sm.diag_planes(lvars)

    def _ensure_noise_prior(self):
        if self.noise_prior is None:
            prior, _ = self.noise.initial_state(1, self.dtype, self.device)
            filename = self.options.get_string("noise-initial-prior",
                                               "modeldefault")
            if filename != "modeldefault":
                # one MVN for every voxel (inference_vb.cc:132-142)
                from ..io import mvn as mvn_io
                means, cov = mvn_io.load_matrix(filename)
                state = self.noise.state_from_mvn(means[None, :],
                                                  cov[None, :, :])
                prior = WhiteNoiseState(
                    *(x.to(self.dtype).to(self.device) for x in state))
            self.noise_prior = prior

    def initial_state(self):
        self._ensure_noise_prior()
        v, p = self.nvoxels, self.nparams
        _, noise_post = self.noise.initial_state(v, self.dtype, self.device)
        means, prec, cov = self.initial_posterior()
        # identity prior precision, zero mean: the route writes the
        # real prior planes
        prior_means = torch.zeros((p, v), dtype=self.dtype, device=self.device)
        prior_prec = torch.ones((p, v), dtype=self.dtype, device=self.device)
        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              noise_post)
        return VBLoopState(
            it=0, post=post,
            f=torch.full((v,), 1234.5678, dtype=self.dtype,
                         device=self.device),
            conv=self.detector.init_state(v, self.dtype,
                                          device=self.device))

    # -- the spectral-whole route -----------------------------------------
    def spectral_consts(self, dtype=None, device=None):
        """The route's constants: (tconsts [2P+1,T] on `device`,
        aconsts [P*P] host, sconsts [4P^2+2P+6] host), in `dtype`
        (default the engine's). Host float64 from the design, the mask,
        the dtype-rounded prior precisions and the noise priors."""
        dtype = dtype or self.dtype
        self._ensure_noise_prior()
        _, post1 = self.noise.initial_state(1, self.dtype)
        init_b = float(post1.b[0, 0])
        init_c = float(post1.c[0, 0])
        b0 = float(self.noise_prior.b.reshape(-1)[0])
        c0 = float(self.noise_prior.c.reshape(-1)[0])
        c_post = (float(self.noise.ntimes_per_group[0]) - 1.0) * 0.5 + c0
        qm_h = np.asarray(self.noise.qmasks, np.float64)[0]
        # the prior precisions as the kernels see them (dtype-rounded)
        pp_h = self.prior_setup.base_precs.double().cpu().numpy()
        elbo_extra = (eigen_elbo_const(qm_h, c_post, c0, b0, self.nparams),
                      c_post + 0.5)
        sconsts = pack_spectral_consts(self.design, qm_h, self.nt, pp_h,
                                       1.0 / b0, c_post, init_b, init_c,
                                       dtype, elbo_extra)
        tconsts = pack_mxu_consts(self.design, qm_h, self.nt, dtype,
                                  device or self.device)
        aconsts = pack_solve_consts(self.design, qm_h, self.nt, dtype)
        return tconsts, aconsts, sconsts

    def _run_spectral_whole(self, s):
        """Statistics kernel + eigenbasis core kernel (vb.py:1611-1866,
        split form, maxits): one [T,V] read, one posterior write."""
        n_iters = int(self.detector.max_iterations)
        p, nv = self.nparams, self.nvoxels
        tconsts, aconsts, sconsts = self.spectral_consts()
        m0, rtqr, dtqr = spectral_stats(self.data.to(self.dtype), tconsts,
                                        aconsts)
        # the core kernel takes [P,V] prior means: broadcast the [P,1]
        # model-default case on the device (vb.py:1802-1806)
        prior_means = self.prior_setup.base_means.expand(p, nv).contiguous()
        prior_prec = self.prior_setup.base_precs.expand(p, nv)
        means, prec, cov, nb, nc, fk, _tr = spectral_core(
            m0, rtqr, dtqr, prior_means, sconsts, n_iters)

        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              WhiteNoiseState(nb, nc))
        # fprior is zero for the priors this route admits: the kernel's
        # eigenbasis ELBO is the free energy
        f = fk[0] if self.need_f else s.f
        conv = s.conv._replace(
            its=torch.full((nv,), n_iters, dtype=torch.int32,
                           device=self.device),
            done=torch.ones(nv, dtype=torch.bool, device=self.device))
        return s._replace(it=n_iters, post=post, f=f, conv=conv)

    def run(self, continue_means=None, continue_cov=None,
            continue_noise=None):
        if continue_means is not None or continue_noise is not None:
            raise NotImplementedError(
                "a programmatic initial posterior takes the JAX package's "
                f"'xla' route ({ROUTES['xla'][1]}), not ported yet")
        final = self._run_spectral_whole(self.initial_state())
        if self.progress_cb is not None:
            self.progress_cb(self.nvoxels, self.nvoxels)
        return self._to_result(final)

    def _to_result(self, s):
        post = s.post

        def host(x):
            return x.detach().cpu().numpy()

        noise_means, noise_cov = self.noise.state_to_mvn(post.noise)
        means = host(post.means.t().contiguous())              # [V,P]
        cov = host(post.cov.permute(2, 0, 1).contiguous())     # [V,P,P]
        nmeans = np.array(noise_means)  # writable copies
        ncov = np.array(noise_cov)      # (bad-voxel fixup)
        f = host(s.f) if self.need_f else None

        bad = ~(np.isfinite(means).all(axis=1)
                & np.isfinite(cov).reshape(cov.shape[0], -1).all(axis=1)
                & np.isfinite(nmeans).all(axis=1))
        if bad.any():
            # Degrade failed voxels to zero-mean/identity-covariance,
            # as the reference does (inference_vb.cc:556-570)
            p, q = means.shape[1], nmeans.shape[1]
            means[bad] = 0.0
            cov[bad] = np.eye(p)
            nmeans[bad] = 0.0
            ncov[bad] = np.eye(q)

        return VBResult(
            means=means, cov=cov, noise_means=nmeans, noise_cov=ncov,
            free_energy=f, fhistory=None,
            iterations=host(s.conv.its), bad_voxels=bad)


def _no_voxel_data(key):
    raise KeyError(key)
