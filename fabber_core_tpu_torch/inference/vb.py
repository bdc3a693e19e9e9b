"""Batched Variational Bayes engine (voxelwise mode), SoA layout.

Port of the parts of fabber_core_tpu/inference/vb.py that the ported
routes run: every voxel is a lane of [..., V] planes (posterior means
[P,V], precision/covariance [P,P,V], noise [Q,V]).

Routes are one named table (ROUTES) instead of the JAX engine's dozen
interacting use_* flags (vb.py:340-660). The live ones:

  spectral-whole  fixed-design models, one noise group: the
                  whole-program spectral route (vb.py:1611-1866, split
                  form), one statistics kernel and one eigenbasis core
                  kernel (ops/fused_spectral.py), maxits or an in-kernel
                  pointzeroone / freduce / trialmode detector;
  spectral-fused  the same route in one kernel (spectral-impl=fused);
  spectral-xstats the same route with the statistics in plain torch
                  (make_design_stats) and the core kernel
                  (spectral-impl=xstats);
  pallas-whole    fixed-design models with several noise groups, a
                  locked noise sd or lm: the whole-program kernel
                  (ops/fused_whole.py; vb.py:1496-1609), the statistics
                  and the fixed point in one launch, maxits or an
                  in-kernel pointzeroone / trialmode / lm detector;
  pallas-loop     the fixed point from statistics made in plain torch
                  (ops/fused_loop.py; vb.py:1050-1130), maxits:
                  engine-kernel=pallas-loop, and dtype=bf16 with several
                  noise groups;
  pallas-loop-ar  AR(1) noise (1 or 2 echoes, no cross terms, the
                  model-default noise prior) at float32: the statistics
                  in plain torch (noise/ar1.py make_design_stats), then
                  the whole fixed point in one launch of the AR(1) kernel
                  (ops/fused_loop_ar.py; vb.py:1328-1494), maxits or an
                  in-kernel pointzeroone / freduce detector;
  xla             the sufficient-statistics route (vb.py:954-1047 and
                  2028-2048 with stats): make_design_stats once, then
                  the engine's loop on [P,V] planes in plain torch, where
                  the JAX package uses XLA (no Pallas kernel, by design):
                  float64 (the CLI's default), save-free-energy-history,
                  engine-kernel=xla, continuation (continue-from-mvn or
                  programmatic), and whatever the fixed-design kernels'
                  gates refuse (for AR noise: cross terms, a noise prior
                  from a file, trialmode, lm);
  pallas-loop-nl  time-local nonlinear models (exp/biexp, poly with a
                  non-identity transform): the whole-loop kernel
                  (ops/fused_loop_nl.py; vb.py:593-660, 1132-1326),
                  maxits or any of the four F-based detectors in-kernel;
                  also, in its generic full-time mode, models with only
                  an evaluate that the probe admits (data-free, every op
                  known: models/kernelgen.py), on the card through a
                  functor generated from evaluate: a time-local one a
                  voxel a thread, one that mixes time (a sum over time,
                  a flip, a slice, a concatenation, a pad, a contraction
                  with a constant matrix) in the kernel's full-time
                  form, a warp a voxel;
  pallas          the same models, one fused-iteration kernel launch
                  per iteration (ops/fused_vb.py; vb.py:340-366,
                  891-951): save-free-energy-history, continuation
                  (continue-from-mvn or programmatic), engine-kernel=pallas;
  xla-generic     the generic-Jacobian loop in plain torch
                  (vb.py:954-1047 with stats=None), where the JAX
                  package uses XLA: float64, linearization=fd, models
                  without a time_signal, AR noise on a nonlinear model or
                  with fixed-design-route=direct. No kernel, by design;
  xla-direct      the same loop with the design as the Jacobian
                  (fixed-design-route=direct, white noise; vb.py:753-761
                  and white.py's design= updates). No kernel, by design;
  spectral        the eigenbasis fixed point from make_design_stats in
                  plain torch (vb.py:1868-2010; ops/spectral.py), where
                  the JAX package uses XLA: the spectral runs the core
                  kernel's gate refuses (bf16 storage with one noise
                  group, P above its instances, a design too long for
                  shared memory) and engine-kernel=spectral; maxits or
                  an F-based detector in the loop. No kernel, by design.

ARD priors, locked linearization centres (locked-linear-from-mvn) and
spatial priors keep a run off the whole-loop and whole-program kernels
(their priors or centres change between iterations, vb.py:409-420,
636-645): a fixed design takes 'xla' (or 'xla-direct'), a time_signal
model at float32 'pallas' (unless locked: vb.py:344-350), the rest
'xla-generic'. Spatial VB (inference/spatial.py) is this engine's
subclass with its own sweep.

The per-iteration routes run the engine's own loop: a static trip
count under maxits, else a while loop over the lanes' detector state
with the best-state save/revert protocol (vb.py:954-1047, 2028-2048,
2603-2627).

_select_route applies the JAX gates in the JAX engine's order (its
`auto` as on the TPU), the same way on "cpu" and "cuda".
The whole-loop nonlinear kernel (6) is taken where the JAX engine's
picker admits it (ops/fused_loop_nl.py pick_nl_block, the port's copy),
else the per-iteration kernel 7 or the generic route, as the JAX engine.
On "cuda" a kernel route also needs its kernels for the run's shape: a
prebuilt instance (csrc/vb_device.cuh FABBER_NL_INSTANCES for the model
functors, csrc/whole_device.cuh FABBER_WHOLE_INSTANCES for (P, Q), csrc/
fused_ar_loop.cu FABBER_AR_INSTANCES for AR's (P, echoes)), a per-shape
instance built at the route's first launch (ops/_cuda.py build_instance),
or a functor generated from the model for kernels 6-8, built at
construction; a run outside them (kernel 7 past P 42 or Q 35) raises at
construction (a continued run's route, before its first launch;
require_card_instance). Choosing a route is a decision made before any
launch, never a fallback after a failure.

run() is the route's run, then, with mcsteps > 0, the motion-correction
steps (core/motion.py: the original data registered to the model fit,
then VB continued on the realigned data through continuation_route()),
then, with spatial-prior-output-correction, the likelihood-only
posterior (compute_noprior) at the final state: features of every
route, as the JAX engine's run() (vb.py:2421-2526) has them.
"""

import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..exceptions import InvalidOptionValue
from ..models.base import resolve_parameters, PRIOR_IMAGE
from ..models.kernelgen import (derive_time_local_eval,
                                derive_time_signal_functor)
from ..noise import get_noise_class
from ..noise.ar1 import Ar1NoiseState
from ..noise.white import DesignStats, WhiteNoiseState
from ..ops import smallmat as sm
from ..ops import _cuda
from ..ops.fused_loop import (fused_vb_loop, n_ar_loop_planes,
                              n_white_loop_planes, pack_loop_consts,
                              pick_block, whole_instantiated)
from ..ops.fused_loop_ar import (DETECTOR_KINDS as AR_DETECTORS,
                                 ar_elbo_consts, ar_instantiated,
                                 fused_ar_loop, pack_ar_consts)
from ..ops.fused_loop_nl import (DETECTOR_KINDS as NL_DETECTORS,
                                 fused_nl_loop, pack_nl_consts,
                                 pick_nl_block)
from ..ops.fused_spectral import (MAX_P, pack_mxu_consts, pack_solve_consts,
                                  pack_spectral_consts, spectral_core,
                                  spectral_fused, spectral_smem,
                                  spectral_stats)
from ..ops.fused_whole import (DETECTOR_KINDS as WHOLE_DETECTORS,
                               SMEM_BYTES, fused_whole, pack_whole_consts,
                               pack_whole_time_consts, pad_time, smem_bytes,
                               whole_cap)
from ..ops.fused_vb import fused_iteration, nl_instantiated
from ..ops.spectral import (eigen_elbo_const, make_spectral_detector_loop,
                            make_spectral_loop)
from ..options import OptionSpec, OPT_STR, OPT_INT, OPT_BOOL, OPT_MVN
from .convergence import get_detector_class
from .linearize import Linearizer
from .priors import PriorSetup

# Named route table: JAX route name -> what it is. Names follow the JAX
# package's --engine-kernel values and route_description strings.
ROUTES = {
    "spectral-whole": (
        "whole-program spectral route (CUDA statistics kernel + "
        "eigenbasis core kernel)"),
    "spectral-fused": ("whole-program spectral route in one kernel "
                       "(spectral-impl=fused)"),
    "spectral-xstats": ("whole-program spectral route (plain-torch "
                        "statistics + eigenbasis core kernel, "
                        "spectral-impl=xstats)"),
    "pallas-whole": ("whole-program fixed-design kernel (in-kernel "
                     "sufficient statistics + fixed point)"),
    "pallas-loop": ("whole-loop fixed-design kernel (plain-torch "
                    "statistics input)"),
    "xla": ("fixed-design sufficient-statistics route (plain torch; the "
            "JAX package leaves it to XLA, so it has no kernel)"),
    "pallas-loop-nl": "whole-loop nonlinear kernel (time_signal mode)",
    "pallas": "per-iteration fused kernel (time_signal mode)",
    "xla-generic": ("generic-Jacobian route (plain torch; the JAX "
                    "package leaves it to XLA, so it has no kernel)"),
    "xla-direct": ("fixed-design direct route (plain torch; the JAX "
                   "package leaves it to XLA, so it has no kernel)"),
    "spectral": ("spectral eigenbasis fixed point (plain torch; the JAX "
                 "package leaves it to XLA, so it has no kernel)"),
    "pallas-loop-ar": ("whole-loop AR(1) fixed-design kernel (plain-torch "
                       "statistics input)"),
    "spatial": ("spatial VB sweeps (inference/spatial.py; plain torch, "
                "the JAX package leaves them to XLA, so they have no "
                "kernel)"),
    # features a run needs beyond its route, served by the routes above
    "motion-correction": ("VB with interleaved motion correction "
                          "(mcsteps > 0; core/motion.py)"),
    "noprior-output": ("likelihood-only posterior output "
                       "(spatial-prior-output-correction)"),
    "ard-priors": "ARD priors (an iteration-dependent prior sweep)",
    "spatial-priors": "spatial priors (spatial VB)",
    "locked-linear": ("fixed linearization centres "
                      "(locked-linear-from-mvn)"),
}
# the JAX package's --engine-kernel values
ENGINE_KERNELS = ("auto", "pallas", "pallas-loop", "pallas-whole",
                  "spectral", "spectral-whole", "xla")
# the routes whose CUDA kernels evaluate the model through a functor, and
# their kernels (ops/_cuda.py GEN_KERNELS' keys: kernel 6 and kernel 7)
FUNCTOR_ROUTES = {"pallas-loop-nl": "nl_loop", "pallas": "vb_iter"}
# the fixed-design routes whose kernels take (P, Q) instances
WHOLE_ROUTES = ("pallas-whole", "pallas-loop")
# the kernel each kernel route launches (PERF.md's numbering), and the
# list of the shapes that kernel is compiled for
ROUTE_KERNEL = {"pallas-whole": 4, "pallas-loop": 5, "pallas-loop-ar": 9,
                "pallas-loop-nl": 6, "pallas": 7, "nlls-kernel": 8}
INSTANCE_LISTS = {4: "csrc/whole_device.cuh FABBER_WHOLE_INSTANCES",
                  5: "csrc/whole_device.cuh FABBER_WHOLE_INSTANCES",
                  9: "csrc/fused_ar_loop.cu FABBER_AR_INSTANCES",
                  6: "csrc/vb_device.cuh FABBER_NL_INSTANCES and "
                     "kWideMaxP, kWideMaxQ",
                  7: "csrc/vb_device.cuh FABBER_NL_INSTANCES and "
                     "kCoopMaxP, kWideMaxQ",
                  8: "csrc/vb_device.cuh FABBER_NL_INSTANCES and "
                     "kWideMaxP"}
# the fixed-design routes that start from the model default (a
# programmatic initial posterior takes "xla" instead, vb.py:2516-2539)
DESIGN_KERNEL_ROUTES = ("spectral-whole", "spectral-fused",
                        "spectral-xstats", "pallas-loop-ar",
                        "spectral") + WHOLE_ROUTES
# the detectors the spectral kernels run in-kernel (vb.py:568-570)
SPECTRAL_DETECTORS = ("pointzeroone", "freduce", "trialmode")
SPECTRAL_IMPLS = {"split": "spectral-whole", "fused": "spectral-fused",
                  "xstats": "spectral-xstats"}


class PosteriorState(NamedTuple):
    means: Any       # [P,V] latent
    prec: Any        # [P,P,V]
    cov: Any         # [P,P,V]
    prior_means: Any  # [P,V]
    prior_prec: Any  # [P,V] diagonal prior precision
    noise: Any       # noise-model state (WhiteNoiseState, Ar1NoiseState)


class VBLoopState(NamedTuple):
    it: int          # iterations run
    post: PosteriorState
    centre: Any      # [P,V] linearization centre of the next iteration
    f: Any           # [V] free energy
    fprior: Any      # [V] the prior's free-energy term
    conv: Any        # ConvState
    fhist: Any = None  # [iters, V] F history (save-free-energy-history)
    best: Any = None   # PosteriorState, the detector's saved best state


def _lane_where(mask, new, old):
    """Per-lane select over NamedTuples of [..., V] tensors (non-tensor
    fields take the new value)."""
    if isinstance(new, tuple):
        return type(new)(*(_lane_where(mask, n, o)
                           for n, o in zip(new, old)))
    if not torch.is_tensor(new):
        return new
    return torch.where(mask.reshape((1,) * (new.dim() - 1) + mask.shape),
                       new, old)


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
    """Voxelwise VB (method=vb) on the ported routes."""

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
            OptionSpec("mc-dof", OPT_INT,
                       "Motion correction degrees of freedom: 6 (rigid) "
                       "or 12 (affine)", default="6"),
            OptionSpec("engine-kernel", OPT_STR,
                       "Iteration backend, as the JAX package names it: "
                       "auto, pallas (per-iteration time-signal kernel), "
                       "pallas-loop (whole-loop kernel: nonlinear models, "
                       "or fixed-design from statistics), pallas-whole "
                       "(whole-program fixed-design kernel), "
                       "spectral-whole, spectral (eigenbasis fixed point "
                       "in plain torch), xla (plain-torch statistics route "
                       "or generic-Jacobian route)",
                       default="auto"),
            OptionSpec("fixed-design-route", OPT_STR,
                       "Fixed-design update arithmetic: stats (sufficient "
                       "statistics) or direct (the design as the "
                       "Jacobian)", default="stats"),
            OptionSpec("spectral-impl", OPT_STR,
                       "Whole-program spectral kernel form: split "
                       "(statistics kernel + core kernel), fused (one "
                       "kernel) or xstats (plain-torch statistics + core "
                       "kernel)", default="split"),
        ]

    def __init__(self, model, options, data, voxel_data_getter=None,
                 data_plane=None, device="cuda", coords=None,
                 continued=False, suppdata=None, data_device=None):
        """data [V,T] (voxel-major, as at the API boundary; uploaded,
        then transposed to [T,V] on the device).

        data_plane: a [T,V] tensor already on the device, used as is
        instead of `data` (e.g. a volume generated on the card).
        device: "cuda" (the kernels) or "cpu" (their plain versions);
        "cuda" without a card raises.
        coords: [V,3] voxel grid coordinates for the model evaluation
        context (the JAX engine's positional coords); zeros if None.
        continued: the run starts from a previous posterior (the
        runner's loaded MVN; the continue-from-mvn option says so too),
        which the JAX gates keep off the whole-loop and whole-program
        kernels: run() then takes the continuation.
        suppdata: [V,S] per-voxel supplemental data (--suppdata), handed
        to the model's evaluate as ctx.suppdata [S] (None: none).
        data_device: where the [T,V] data plane (and the coords,
        suppdata and locked-centre planes) live, default `device`;
        spatial VB's blocked sweeps keep them on the host ("cpu").
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
        plane_device = self.device if data_device is None \
            else torch.device(data_device)

        if data_plane is not None:
            if data_plane.device != self.device or data_plane.ndim != 2:
                raise ValueError(f"data_plane must be a [T,V] tensor on "
                                 f"{self.device}")
            self.data = data_plane
        else:
            host = torch.as_tensor(np.asarray(data), dtype=self.store_dtype)
            self.data = host.to(plane_device).t().contiguous()   # [T,V]
        self.nt, self.nvoxels = self.data.shape
        if coords is None:
            self.coords = torch.zeros((3, self.nvoxels), dtype=self.dtype,
                                      device=plane_device)
        else:
            self.coords = torch.as_tensor(
                np.asarray(coords), dtype=self.dtype).t().contiguous().to(
                    plane_device)                               # [3,V]
        self.supp = supp_plane(suppdata, self.nvoxels, self.dtype,
                               plane_device)                    # [S,V]

        self.params = resolve_parameters(model, options)
        self.nparams = len(self.params)

        noise_cls = get_noise_class(options.get_string("noise"))
        self.noise = noise_cls(options, self.nt,
                               options.get_int_list("mt", 1))

        conv_name = options.get_string("convergence", "maxits")
        self.detector = get_detector_class(conv_name)(options)
        self.is_lm = conv_name == "lm"
        # iteration cap of the while loop (each detector terminates well
        # below it; a safety net, vb.py:662-664)
        self.max_iter_cap = int(self.detector.max_iterations) + 2

        self.need_f = (self.detector.uses_f
                       or options.get_bool("print-free-energy")
                       or options.get_bool("save-free-energy")
                       or options.get_bool("save-free-energy-history"))
        self.save_fhist = options.get_bool("save-free-energy-history")

        self._voxel_data = voxel_data_getter or _no_voxel_data
        self.prior_setup = PriorSetup(self.params, self._voxel_data,
                                      self.nvoxels, self.dtype, self.device)

        lin_mode = options.get_string("linearization", "auto")
        self.linearizer = Linearizer(model, self.params, self.nt,
                                     mode=lin_mode)
        # fixed linearization centres [P,V] (inference_vb.cc:169-179,
        # 227-236): the MVN's latent means, as stored (vb.py:316-325)
        self.locked_linear = options.get_string("locked-linear-from-mvn",
                                                "") != ""
        self.locked_centres = None
        if self.locked_linear:
            from ..io import mvn as mvn_io
            lmeans, _ = mvn_io.unpack(np.asarray(
                self._voxel_data("locked-linear-from-mvn")).T)
            self.locked_centres = torch.as_tensor(
                np.ascontiguousarray(lmeans[:, :self.nparams].T),
                dtype=self.dtype, device=plane_device)
        self.continued = continued or options.get_string(
            "continue-from-mvn", "") != ""
        # motion correction (core/motion.py; JAX vb.py:327-338): mcsteps
        # > 0 re-registers the original data to the model fit between VB
        # passes
        self.num_mcsteps = options.get_int("mcsteps", 0)
        self.mc_dof = options.get_int("mc-dof", 6)
        if self.mc_dof not in (6, 12):
            raise InvalidOptionValue(
                "mc-dof", str(self.mc_dof),
                "Motion-correction dof must be 6 (rigid) or 12 (affine)")
        self.mc_translations = []   # per step, max |translation| (voxels)
        self.mc_saturated = False
        self._mc_orig_data = None
        self._mc_registerer = None

        # constant design [T,P] (float64 host) for models linear in
        # their untransformed parameters
        self.design = None
        if (getattr(self.noise, "supports_fixed_design", False)
                and lin_mode == "auto"
                and all(pm.transform.is_identity for pm in self.params)):
            d = model.fixed_design(self.nt)
            if d is not None:
                self.design = np.asarray(d, np.float64)

        # the time-signal kernels' gate (vb.py:340-366): white noise, a
        # time-local model, autodiff-free linearization, float32; an
        # explicit engine-kernel=pallas drops the fixed design
        mode = options.get_string("engine-kernel", "auto")
        ts_eligible = (mode != "xla"
                       and getattr(self.noise, "name", "") == "white"
                       and not self.locked_linear
                       and lin_mode == "auto"
                       and self.dtype == torch.float32
                       and hasattr(model, "time_signal"))
        if ts_eligible and mode == "pallas":
            self.design = None
        if (self.design is not None
                and options.get_string("fixed-design-route", "stats")
                != "stats"
                and not getattr(self.noise, "fixed_design_direct", True)):
            # a statistics-only noise model (AR) has no direct design
            # route: the generic-Jacobian route instead (vb.py:376-380)
            self.design = None
        self._ts_eligible = ts_eligible and self.design is None
        # the whole-loop kernel's generic mode: the probe's TimeLocalEval
        # of evaluate (_nonlinear_route), and the generated functor the
        # card runs (_require_kernel_instance)
        self.generic = None
        self.functor = None

        self.route = self._select_route()
        self._require_kernel_instance()
        self.noise_prior = None
        self.progress_cb = None

    def _select_route(self):
        """Name of the route this run needs (a key of ROUTES), by the
        JAX engine's gates in its order."""
        o = self.options
        mode = o.get_string("engine-kernel", "auto")
        if mode not in ENGINE_KERNELS:
            raise InvalidOptionValue("engine-kernel", mode,
                                     "Unknown engine route")
        if self.design is not None:
            return self._design_route(mode)
        return self._nonlinear_route(mode)

    def _design_route(self, mode):
        """Fixed-design models: the stats route's gates (vb.py:372-591)
        and the dispatch precedence spectral-whole > whole-program >
        spectral > stats-input loop > the stats loop (vb.py:2012-2048).
        The JAX engine's VMEM pickers of the kernels that read the data
        (spectral-whole, whole-program) become the card's shared-memory
        gate, the per-timepoint rows of a block in 227 KB, up to the
        largest P each picker admits at any T (MAX_P, whole_cap); past
        it the port takes the JAX engine's route. Those of the
        stats-input loops do not depend on T and stay as they are
        (pick_block), so kernels 5 and 9 serve exactly the JAX engine's
        shapes."""
        o = self.options
        if o.get_string("fixed-design-route", "stats") != "stats":
            return "xla-direct"
        det = type(self.detector).name
        p, nq, nt = self.nparams, self.noise.nphis, self.nt
        white, ar = self.noise.name == "white", self.noise.name == "ar"
        f32 = self.dtype == torch.float32
        f32_store = self.store_dtype == torch.float32
        default_post = o.get_string("noise-initial-posterior",
                                    "modeldefault") == "modeldefault"
        # loop_gates_common (vb.py:410-420): iteration-invariant priors
        # and centres
        fixed_priors = not (self.prior_setup.has_ard
                            or self.prior_setup.spatial_params
                            or self.locked_linear)
        common = f32 and not self.is_lm and not self.save_fhist \
            and default_post and not self.continued and fixed_priors
        # spectral_ok (vb.py:465-467): white noise, one phi group,
        # unlocked stdev (AR noise has no locked_noise_stdev)
        spectral_ok = white and nq == 1 and self.noise.locked_noise_stdev <= 0
        # sw_core (vb.py:571-581): f32 storage, P up to the JAX gate's
        # largest at any T (25; P > 8 per-shape instances), the (2P+1) x
        # T rows (and a per-shape instance's factor and constants) in
        # one block's shared memory
        sw_core = (common and spectral_ok and f32_store
                   and det in ("maxits",) + SPECTRAL_DETECTORS
                   and p <= MAX_P and spectral_smem(p, nt) <= SMEM_BYTES)
        # whole_core (vb.py:494-514): admits lm; P up to the JAX gate's
        # largest at any T (20 under maxits, 19 at Q = 4, 17 under a
        # detector); the (P+QP+Q) x T rows
        whole_core = (white and f32 and f32_store and not self.save_fhist
                      and default_post and not self.continued
                      and fixed_priors
                      and det in ("maxits",) + WHOLE_DETECTORS
                      and p <= whole_cap(nq, det != "maxits")
                      and smem_bytes(p, nq, nt) <= SMEM_BYTES)
        # spectral_covers (vb.py:522-525): where the spectral routes
        # apply, auto prefers them to the whole-program kernel
        spectral_covers = spectral_ok and common \
            and det in ("maxits",) + SPECTRAL_DETECTORS
        # loop_noise_ok and ar_fdet_ok (vb.py:389-449): white noise, or
        # AR(1) without cross terms under the model-default noise prior,
        # whose kernel also runs pointzeroone / freduce; the JAX VMEM
        # picker's bound on P (pick_block, T-independent: kernel 5 P <=
        # 17, kernel 9 P <= 16 at one echo)
        loop_noise_ok = white or (
            ar and nq in (1, 2) and self.noise.nalphas == 2
            and o.get_string("noise-initial-prior",
                             "modeldefault") == "modeldefault")
        if loop_noise_ok:
            loop_noise_ok = pick_block(1024, n_white_loop_planes(p, nq)
                                       if white else
                                       n_ar_loop_planes(p, nq=nq)) \
                is not None
        ar_fdet_ok = common and ar and det in AR_DETECTORS \
            and pick_block(1024, n_ar_loop_planes(p, True, nq)) is not None
        loop_eligible = ((common and det == "maxits") or ar_fdet_ok) \
            and loop_noise_ok and mode in ("auto", "pallas-loop", "spectral")
        spectral_fdet = common and spectral_ok \
            and det in SPECTRAL_DETECTORS and mode in ("auto", "spectral")
        if mode == "spectral-whole":
            return self._spectral_impl() if sw_core else "xla"
        if mode == "pallas-whole":
            return "pallas-whole" if whole_core else "xla"
        if mode == "auto":
            if sw_core:
                return self._spectral_impl()
            if whole_core and not spectral_covers:
                return "pallas-whole"
        if spectral_fdet or (loop_eligible and spectral_ok
                             and mode != "pallas-loop"):
            return "spectral"
        if loop_eligible and mode != "spectral":
            return "pallas-loop-ar" if ar else "pallas-loop"
        return "xla"

    def _spectral_impl(self):
        impl = self.options.get_string("spectral-impl", "split")
        return SPECTRAL_IMPLS.get(impl, "spectral-fused")

    def _nonlinear_route(self, mode):
        """Models without a fixed design: the whole-loop gate
        (vb.py:593-660) with its VMEM picker, then the per-iteration
        kernel's (vb.py:355-363), then the generic-Jacobian route."""
        o = self.options
        # every detector runs in the kernel (vb.py:621-640); ARD and
        # spatial priors change between iterations (vb.py:641-642)
        nl_ok = (mode in ("auto", "pallas-loop")
                 and int(self.detector.max_iterations) >= 1
                 and not self.save_fhist and not self.continued
                 and not self.prior_setup.has_ard
                 and not self.prior_setup.spatial_params
                 and o.get_string("noise-initial-posterior",
                                  "modeldefault") == "modeldefault")

        def fits(generic):
            # the JAX kernel's tile picker at 1,024 voxels (vb.py:643-651)
            det = type(self.detector).name
            return pick_nl_block(
                1024, self.nparams, pad_time(self.nt), self.noise.nphis,
                det in NL_DETECTORS, generic is not None,
                getattr(generic, "time_planes", None),
                getattr(generic, "nsupp", 0),
                tracks_best=det in ("trialmode", "lm")) is not None
        if not self._ts_eligible:
            # the generic mode's gate (vb.py:600-617): an evaluate the
            # probe admits, decided here, before any launch
            if (mode in ("auto", "pallas-loop")
                    and getattr(self.noise, "name", "") == "white"
                    and not self.locked_linear
                    and o.get_string("linearization", "auto") == "auto"
                    and self.design is None
                    and self.dtype == torch.float32):
                nsupp = 0 if self.supp is None else self.supp.shape[0]
                self.generic = derive_time_local_eval(
                    self.model, self.nt, self.nparams, nsupp)
            if self.generic is not None and nl_ok and fits(self.generic):
                self.functor = self.generic
                return "pallas-loop-nl"
            return "xla-generic"
        if nl_ok and fits(None):
            return "pallas-loop-nl"
        return "pallas" if mode in ("auto", "pallas") else "xla-generic"

    def _require_kernel_instance(self, route=None):
        """On "cuda" a kernel route (default the run's; a continued run
        asks for continuation_route()'s) needs its kernel compiled for the
        run's (P, Q): for the model's hand-written functor a prebuilt
        instance (FABBER_NL_INSTANCES) or a per-shape one
        (nl_instantiated), else, for kernels 6 and 7, a functor generated
        from the model (its evaluate on the generic route, else its
        time_signal), built now (_require_functor). Kernels 4, 5 and 9
        serve every shape the route gate gives them: a prebuilt instance
        (FABBER_WHOLE_INSTANCES, FABBER_AR_INSTANCES) or a per-shape one.
        A model that mixes time runs kernel 6's full-time form, a warp a
        voxel, where its block fits one block's shared memory
        (_require_fulltime_fits; else it raises here, ROADMAP Queue 3 item
        35). Per-shape instances are built at the route's first launch
        (ops/_cuda.py build_instance; whole_instantiated,
        ar_instantiated, nl_instantiated). A run with none (kernel 7
        past csrc/vb_device.cuh kCoopMaxP, the largest P whose state its
        cooperative form's block holds in shared memory, or Q past
        kWideMaxQ) raises here (require_card_instance), before anything
        is built or launched.
        On "cpu" the routes run their plain versions, which take any
        shape."""
        if self.device.type != "cuda":
            return
        route = route or self.route
        p, nq = self.nparams, self.noise.nphis

        def has_instance(r):
            if r == "pallas-loop-ar":
                return ar_instantiated(p, nq)
            if r in WHOLE_ROUTES:
                return whole_instantiated(p, nq)
            return self.generic is None and nl_instantiated(
                self.model.kernel_model(), nq, FUNCTOR_ROUTES[r])

        def functor_ok(r):
            if r not in FUNCTOR_ROUTES or (r == "pallas"
                                           and self.generic is not None):
                return False
            return generatable(self._gen_functor, p, nq, self._kernel(r))
        self._require_fulltime_fits(route)
        require_card_instance(route, p, nq, has_instance, functor_ok)
        self._require_functor(route)

    def _kernel(self, route):
        """The GEN_KERNELS key of route's kernel for a generated functor:
        FUNCTOR_ROUTES', or the generic functor's own on the whole-loop
        route ("nl_loop_full" for a full-time one)."""
        if route == "pallas-loop-nl" and self.generic is not None:
            return self.generic.kernel
        return FUNCTOR_ROUTES[route]

    def _require_fulltime_fits(self, route):
        """Raise NotImplementedError, before anything is built, where a
        model that mixes time passes the JAX gate for kernel 6 but its
        full-time form's block (the fixed point's state, the voxel's
        samples, the model's signal and Jacobian and the functor's
        planes) exceeds one block's shared memory (ops/_cuda.py
        fulltime_smem; ROADMAP Queue 3 item 35)."""
        g = self.generic
        if route != "pallas-loop-nl" or g is None or not g.full_time:
            return
        nq = self.noise.nphis
        need = _cuda.fulltime_smem(self.nparams, nq, self.nt, g.smem_floats)
        if need > _cuda.MAX_BLOCK_SMEM:
            raise NotImplementedError(
                f"the full-time form of kernel 6 holds a voxel's state, its "
                f"{self.nt} samples, the model's signal and Jacobian and the "
                f"functor's planes in one block's shared memory: {need} "
                f"bytes at P={self.nparams}, Q={nq}, over the "
                f"{_cuda.MAX_BLOCK_SMEM} a block may take (ops/_cuda.py "
                "fulltime_smem; ROADMAP Queue 3 item 35), so the "
                "'pallas-loop-nl' route cannot run this on the card, where "
                "the JAX engine runs its kernel; device='cpu' runs the "
                "route's plain version")

    @functools.cached_property
    def _gen_functor(self):
        """The functor generated from the model for kernels 6 and 7: the
        generic route's (from evaluate), else one from its time_signal
        (None where the generator refuses it), derived once."""
        return self.generic or derive_time_signal_functor(self.model,
                                                          self.nparams)

    def _require_functor(self, route):
        """On "cuda", route's kernel (6 for pallas-loop-nl, 7 for pallas)
        where the model has no hand-written functor, or its functor no
        prebuilt or per-shape instance at the run's (P, Q): the generated
        one (require_card_instance admitted it), built (or loaded) now
        into functor.libs[(kernel, Q)] (kernel 6's full-time form,
        "nl_loop_full", for a functor of the full-time walk). A failed
        build raises."""
        nq = self.noise.nphis
        if route not in FUNCTOR_ROUTES or (
                self.generic is None and nl_instantiated(
                    self.model.kernel_model(), nq, FUNCTOR_ROUTES[route])):
            return
        kernel = self._kernel(route)
        functor = self._gen_functor
        functor.libs[(kernel, nq)] = _cuda.build_generated(
            functor.source, self.nparams, nq, kernel)
        self.functor = functor

    def route_description(self):
        """Human-readable name of the selected update route (logged by
        the runner)."""
        det = type(self.detector).name
        if det != "maxits" and self.route in (
                "spectral-whole", "spectral-fused", "spectral-xstats",
                "pallas-whole", "pallas-loop-nl", "pallas-loop-ar"):
            return f"{self._route_name()}, in-kernel {det} detector"
        return self._route_name()

    def _route_name(self):
        if self.route == "pallas-loop-nl" and self.generic is not None:
            # the JAX engine's words (vb.py:695-702)
            return ("whole-loop nonlinear kernel (generic full-time mode, "
                    "in-kernel evaluator derived from evaluate())")
        return ROUTES[self.route]

    def evaluate_model(self, means_planes):
        """Model prediction [T,V] tensor at latent means [P,V] (for the
        model-fit and residual outputs)."""
        means = torch.as_tensor(means_planes, dtype=self.dtype,
                                device=self.device)
        if self.design is not None:
            d = torch.as_tensor(self.design, dtype=self.dtype,
                                device=self.device)
            return d @ means
        return self.linearizer.evaluate(means, self.data.to(self.dtype),
                                        self.coords, self.supp)

    # -- initial state ----------------------------------------------------
    def initial_posterior(self, lo=0, hi=None):
        """Latent-space initial posterior (fwdmodel.cc:284-313) of the
        voxels lo:hi (default all): means [P,V], prec [P,P,V], cov
        [P,P,V] on the device."""
        hi = self.nvoxels if hi is None else hi
        v = hi - lo
        cols = []
        for spec in self.params:
            if spec.prior_type == PRIOR_IMAGE:
                img = np.asarray(self._voxel_data(spec.options["image"]))
                cols.append(torch.as_tensor(
                    img.reshape(self.nvoxels, -1)[lo:hi, 0],
                    dtype=self.dtype, device=self.device))
            else:
                cols.append(torch.full((v,), spec.post.mean, dtype=self.dtype,
                                       device=self.device))
        means_vox = torch.stack(cols, dim=1)  # [V,P] model space
        means_vox = self.model.init_posterior(
            self.data[:, lo:hi].to(self.device).t(), means_vox)

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

    def _noise_state_from_file(self, key, default_state):
        """Replace an initial noise dist from an MVN matrix file
        (inference_vb.cc:132-142): one MVN applied to every voxel."""
        filename = self.options.get_string(key, "modeldefault")
        if filename == "modeldefault":
            return default_state
        from ..io import mvn as mvn_io
        means, cov = mvn_io.load_matrix(filename)
        state = self.noise.state_from_mvn(means[None, :], cov[None, :, :])
        return type(default_state)(*(
            x.to(self.dtype).to(self.device).expand_as(d).contiguous()
            for x, d in zip(state, default_state)))

    def _ensure_noise_prior(self):
        if self.noise_prior is None:
            prior, _ = self.noise.initial_state(1, self.dtype, self.device)
            self.noise_prior = self._noise_state_from_file(
                "noise-initial-prior", prior)

    def initial_state(self, continue_means=None, continue_cov=None,
                      continue_noise=None, lo=0, hi=None):
        """The loop's initial state (vb.py:844-889) of the voxels lo:hi
        (default all): the model-default posterior, or a programmatic
        one (voxel-major continue_means [V,P], continue_cov [V,P,P],
        continue_noise a noise state of [Q,V] planes)."""
        self._ensure_noise_prior()
        hi = self.nvoxels if hi is None else hi
        v, p = hi - lo, self.nparams
        _, noise_post = self.noise.initial_state(v, self.dtype, self.device)
        noise_post = self._noise_state_from_file("noise-initial-posterior",
                                                 noise_post)
        if continue_means is not None:
            means = torch.as_tensor(np.asarray(continue_means)[lo:hi],
                                    dtype=self.dtype).t().contiguous().to(
                                        self.device)
            cov = torch.as_tensor(np.asarray(continue_cov)[lo:hi],
                                  dtype=self.dtype).permute(1, 2, 0).to(
                                      self.device)
            chol, _ = sm.cholesky_jittered(cov)
            prec = sm.inverse_from_chol(chol)
            if continue_noise is not None:
                noise_post = type(noise_post)(*(
                    torch.as_tensor(np.asarray(x)[..., lo:hi],
                                    dtype=self.dtype, device=self.device)
                    for x in continue_noise))
        else:
            means, prec, cov = self.initial_posterior(lo, hi)
        # identity prior precision, zero mean: the route writes the
        # real prior planes
        prior_means = torch.zeros((p, v), dtype=self.dtype, device=self.device)
        prior_prec = torch.ones((p, v), dtype=self.dtype, device=self.device)
        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              noise_post)
        fhist = torch.zeros((self.max_iter_cap, v), dtype=self.dtype,
                            device=self.device) if self.save_fhist else None
        return VBLoopState(
            it=0, post=post, centre=means,
            f=torch.full((v,), 1234.5678, dtype=self.dtype,
                         device=self.device),
            fprior=torch.zeros(v, dtype=self.dtype, device=self.device),
            conv=self.detector.init_state(v, self.dtype,
                                          device=self.device),
            fhist=fhist,
            # detectors without a save/revert protocol keep no best copy
            best=post if self.detector.tracks_best else None)

    # -- the spectral-whole route -----------------------------------------
    def spectral_consts(self, dtype=None, device=None):
        """The route's constants: (tconsts [2P+1,T] on `device`,
        aconsts [P*P] host, sconsts [4P^2+2P+6] host), in `dtype`
        (default the engine's). Host float64 from the design, the mask,
        the dtype-rounded prior precisions and the noise priors."""
        dtype = dtype or self.dtype
        init_b, init_c = self._noise_init()
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
        """The whole-program spectral route (vb.py:1611-1866) in the
        form of self.route: split (statistics kernel + eigenbasis core
        kernel), fused (both in one kernel) or xstats (make_design_stats
        in plain torch + the core kernel; the JAX route's window scan is
        a TPU workaround, not ported). Under an F-based detector the
        core runs the lanes' state machines to the while loop's cap;
        lanes whose selected state is the engine-initial posterior come
        back tagged (b < 0) and are restored from s, prior planes
        included (vb.py:1810-1826)."""
        fdet = type(self.detector).name != "maxits"
        n_iters = self.max_iter_cap if fdet \
            else int(self.detector.max_iterations)
        nv = self.nvoxels
        tconsts, aconsts, sconsts = self.spectral_consts()
        data = self._kernel_data()
        # the core takes [P,V] prior means: broadcast the [P,1]
        # model-default case on the device (vb.py:1802-1806)
        prior_means, prior_prec = self._prior_planes(prec_plane=False)
        det = self.detector if fdet else None
        stats = None
        if self.route == "spectral-fused":
            means, prec, cov, nb, nc, fk, tr = spectral_fused(
                data, tconsts, aconsts, prior_means, sconsts, n_iters, det)
        else:
            if self.route == "spectral-whole":
                m0, rtqr, dtqr = spectral_stats(data, tconsts, aconsts)
            else:
                stats = self.noise.make_design_stats(self._design_tensor(),
                                                     data)
                m0, rtqr, dtqr = (stats.m0.contiguous(),
                                  stats.rtqr.contiguous(),
                                  stats.dtqr[0].contiguous())
            means, prec, cov, nb, nc, fk, tr = spectral_core(
                m0, rtqr, dtqr, prior_means, sconsts, n_iters, det)
        if fdet:
            sel_init = nb[0] < 0
            nb = torch.abs(nb)
            means, prec, cov, nb, nc, prior_means, prior_prec = (
                _lane_where(sel_init, old, new) for old, new in (
                    (s.post.means, means), (s.post.prec, prec),
                    (s.post.cov, cov), (s.post.noise.b, nb),
                    (s.post.noise.c, nc), (s.post.prior_means, prior_means),
                    (s.post.prior_prec, prior_prec)))

        noise_post = WhiteNoiseState(nb, nc)
        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              noise_post)
        # fprior is zero for the priors this route admits: the kernel's
        # eigenbasis ELBO (at the selected state) is the free energy
        f = fk[0] if self.need_f else s.f
        if fdet:
            if type(self.detector).name == "freduce" and self.need_f:
                # lanes reverted to the engine-initial posterior are off
                # the eigenbasis manifold: F for every lane from the
                # statistics, as the JAX route does (vb.py:1835-1847)
                if self.route == "spectral-whole":
                    stats = self._design_stats(m0, rtqr, dtqr)
                elif stats is None:
                    stats = self.noise.make_design_stats(
                        self._design_tensor(), data)
                f = self.noise.free_energy_stats(
                    noise_post, self.noise_prior, means, prec, cov,
                    prior_means, prior_prec, stats)
            conv = s.conv._replace(
                its=tr[0].to(torch.int32), prev_f=fk[0],
                done=torch.ones(nv, dtype=torch.bool, device=self.device))
            return s._replace(it=n_iters, post=post, centre=means, f=f,
                              conv=conv)
        conv = s.conv._replace(
            its=torch.full((nv,), n_iters, dtype=torch.int32,
                           device=self.device),
            done=torch.ones(nv, dtype=torch.bool, device=self.device))
        return s._replace(it=n_iters, post=post, f=f, conv=conv)

    def _run_spectral(self, s):
        """The spectral route (vb.py:1868-2010): make_design_stats, then
        the eigenbasis fixed point in plain torch (ops/spectral.py), as
        the JAX package runs it in XLA: under maxits the static loop,
        under an F-based detector the lanes' state machines in the loop
        (the core kernel's detector algebra, plain), with lanes whose
        selected state is the engine-initial posterior restored from s,
        prior planes included. F from the statistics at the final
        state (fprior is zero for the priors this route admits)."""
        fdet = type(self.detector).name != "maxits"
        nv = self.nvoxels
        stats = self.noise.make_design_stats(self._design_tensor(),
                                             self.data)
        prior_means, prior_prec = self._prior_planes(prec_plane=False)
        init_b, init_c = self._noise_init()
        b0 = float(self.noise_prior.b.reshape(-1)[0])
        c0 = float(self.noise_prior.c.reshape(-1)[0])
        c_post = (float(self.noise.ntimes_per_group[0]) - 1.0) * 0.5 + c0
        args = (self.design, np.asarray(self.noise.qmasks, np.float64)[0],
                self.prior_setup.base_precs.double().cpu().numpy())
        planes = (stats.m0, stats.rtqr[:1].to(self.dtype),
                  stats.dtqr[0].to(self.dtype), prior_means)
        done = torch.ones(nv, dtype=torch.bool, device=self.device)
        if fdet:
            n_iters = self.max_iter_cap
            means, prec, cov, nb, sel_init, its = make_spectral_detector_loop(
                *args, self.detector, n_iters, init_b, init_c, 1.0 / b0,
                c_post, b0, c0)(*planes)
            nc = torch.full_like(nb, c_post)
            means, prec, cov, nb, nc, prior_means, prior_prec = (
                _lane_where(sel_init, old, new) for old, new in (
                    (s.post.means, means), (s.post.prec, prec),
                    (s.post.cov, cov), (s.post.noise.b, nb),
                    (s.post.noise.c, nc), (s.post.prior_means, prior_means),
                    (s.post.prior_prec, prior_prec)))
        else:
            n_iters = int(self.detector.max_iterations)
            means, prec, cov, nb, nc = make_spectral_loop(
                *args, n_iters, init_b, init_c, 1.0 / b0, c_post)(*planes)
            its = torch.full((nv,), n_iters, dtype=torch.int32,
                             device=self.device)
        noise_post = WhiteNoiseState(nb, nc)
        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              noise_post)
        f = self.noise.free_energy_stats(
            noise_post, self.noise_prior, means, prec, cov, prior_means,
            prior_prec, stats) if self.need_f else s.f
        return s._replace(it=n_iters, post=post, centre=means, f=f,
                          conv=s.conv._replace(its=its, done=done))

    def _design_stats(self, m0, rtqr, dtqr):
        """The statistics kernel's single-group outputs as DesignStats
        (D'QD from the host design)."""
        d = np.asarray(self.design, np.float64)
        qm = np.asarray(self.noise.qmasks, np.float64)
        dtqd = np.einsum("it,tp,tq->ipq", qm, d, d)
        return DesignStats(m0=m0, rtqr=rtqr, dtqr=dtqr[None],
                           dtqd=torch.as_tensor(dtqd, dtype=self.dtype,
                                                device=self.device))

    def _design_tensor(self):
        """The [T,P] design on the device in the compute dtype."""
        return torch.as_tensor(self.design, dtype=self.dtype,
                               device=self.device)

    def _noise_init(self):
        """(b, c) of the model-default initial noise posterior."""
        self._ensure_noise_prior()
        _, post1 = self.noise.initial_state(1, self.dtype)
        return float(post1.b[0, 0]), float(post1.c[0, 0])

    def _prior_planes(self, prec_plane=True):
        """The voxel-invariant prior means as a [P,V] plane, and the
        precisions as one too or (prec_plane=False: the spectral routes,
        whose kernels never read them) as a [P,V] broadcast view."""
        p, nv = self.nparams, self.nvoxels
        prec = self.prior_setup.base_precs.expand(p, nv)
        return (self.prior_setup.base_means.expand(p, nv).contiguous(),
                prec.contiguous() if prec_plane else prec)

    # -- the fixed-design kernel routes -----------------------------------
    def whole_args(self):
        """Kernel 4's inputs: (data [T,V], tconsts, consts, prior_means,
        prior_prec)."""
        init_b, init_c = self._noise_init()
        tconsts = pack_whole_time_consts(self.design, self.noise.qmasks,
                                         self.nt, self.dtype, self.device)
        consts = pack_whole_consts(
            self.design, self.noise.qmasks, self.nt,
            self.noise_prior.b.cpu(), self.noise_prior.c.cpu(),
            self.noise.ntimes_per_group, init_b, init_c)
        return (self._kernel_data(), tconsts, consts) + self._prior_planes()

    def _run_whole(self, s):
        """The whole-program kernel (vb.py:1569-1607): statistics and
        the fixed point in one launch. maxits: F assembled from the
        kernel's last-iteration quadratics; a detector (pointzeroone,
        trialmode, lm): the kernel's per-lane F and iteration counts at
        the while loop's cap."""
        fdet = type(self.detector).name != "maxits"
        n_iters = self.max_iter_cap if fdet \
            else int(self.detector.max_iterations)
        nv = self.nvoxels
        args = self.whole_args()
        prior_means, prior_prec = args[3], args[4]
        means, prec, cov, nb, nc, fkqk, ftr = fused_whole(
            *args, n_iters, self.noise.locked_noise_stdev,
            self._nl_fdet_consts() if fdet else None)
        noise_post = WhiteNoiseState(nb, nc)
        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              noise_post)
        done = torch.ones(nv, dtype=torch.bool, device=self.device)
        if fdet:
            f = fkqk[0]
            conv = s.conv._replace(its=ftr[0].to(torch.int32), prev_f=f,
                                   done=done)
        else:
            # fprior is zero for the (non-ARD, non-spatial) priors this
            # route admits
            f = self.noise.free_energy_from_parts(
                noise_post, self.noise_prior, means, prec, cov, prior_means,
                prior_prec, list(fkqk), list(ftr)) if self.need_f else s.f
            conv = s.conv._replace(
                its=torch.full((nv,), n_iters, dtype=torch.int32,
                               device=self.device), done=done)
        return s._replace(it=n_iters, post=post, centre=means, f=f,
                          conv=conv)

    def loop_kernel_args(self):
        """Kernel 5's inputs from make_design_stats (plain torch, as the
        JAX package leaves it to XLA): (m0, rtqr, dtqr, consts,
        prior_means, prior_prec), and the DesignStats."""
        init_b, init_c = self._noise_init()
        stats = self.noise.make_design_stats(self._design_tensor(),
                                             self.data)
        consts = pack_loop_consts(
            stats.dtqd, self.noise_prior.b.cpu(), self.noise_prior.c.cpu(),
            self.noise.ntimes_per_group, init_b, init_c)
        planes = tuple(x.to(self.dtype).contiguous()
                       for x in (stats.m0, stats.rtqr, stats.dtqr))
        return planes + (consts,) + self._prior_planes(), stats

    def _run_loop_kernel(self, s):
        """The stats-input whole-loop kernel (vb.py:1096-1128): the
        statistics in plain torch, then the maxits fixed point in one
        launch; F from the statistics."""
        n_iters = int(self.detector.max_iterations)
        nv = self.nvoxels
        args, stats = self.loop_kernel_args()
        prior_means, prior_prec = args[4], args[5]
        means, prec, cov, nb, nc = fused_vb_loop(
            *args, n_iters, self.noise.locked_noise_stdev)
        noise_post = WhiteNoiseState(nb, nc)
        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              noise_post)
        f = self.noise.free_energy_stats(
            noise_post, self.noise_prior, means, prec, cov, prior_means,
            prior_prec, stats) if self.need_f else s.f
        conv = s.conv._replace(
            its=torch.full((nv,), n_iters, dtype=torch.int32,
                           device=self.device),
            done=torch.ones(nv, dtype=torch.bool, device=self.device))
        return s._replace(it=n_iters, post=post, centre=means, f=f,
                          conv=conv)

    def ar_loop_args(self):
        """Kernel 9's inputs from make_design_stats (plain torch, as the
        JAX package leaves it to XLA): (m0, rmr, dmr, consts,
        prior_means, prior_prec), and the Ar1DesignStats."""
        self._ensure_noise_prior()
        nq = self.noise.nphis
        _, post1 = self.noise.initial_state(1, self.dtype)
        stats = self.noise.make_design_stats(self._design_tensor(),
                                             self.data)
        consts = pack_ar_consts(
            stats.dmd, self.noise_prior.alpha_prec, self.noise_prior.b,
            self.noise_prior.c, self.noise.ntimes, post1.b[:, 0],
            post1.c[:, 0], [post1.alpha_cov[n, n, 0] for n in range(nq)],
            [post1.alpha_prec[n, n, 0] for n in range(nq)], nq)
        planes = tuple(x.to(self.dtype).contiguous()
                       for x in (stats.m0, stats.rmr, stats.dmr))
        return planes + (consts,) + self._prior_planes(), stats

    def _ar_fdet_consts(self):
        """Kernel 9's detector dict (vb.py:1349-1374): the detector and
        the host float64 constants of the degenerate AR(1) ELBO."""
        self._ensure_noise_prior()
        f_const, lb_coeff = ar_elbo_consts(
            self.nparams, self.noise.nphis, float(self.noise.ntimes),
            float(self.noise_prior.b.reshape(-1)[0]),
            float(self.noise_prior.c.reshape(-1)[0]))
        return {"det": self.detector, "f_const": f_const,
                "lb_coeff": lb_coeff}

    def _run_ar_loop(self, s):
        """The AR(1) whole-loop kernel (vb.py:1328-1494): the statistics
        in plain torch, then the fixed point in one launch, maxits or an
        in-kernel pointzeroone / freduce detector at the while loop's
        cap. Lanes whose selected state is the engine-initial posterior
        come back tagged (b < 0) and are restored from s, prior planes
        included; the 2x2 alpha MVN is reassembled (with one echo
        alpha_2 keeps its prior); F is recomputed from the statistics at
        the final state."""
        fdet = type(self.detector).name != "maxits"
        n_iters = self.max_iter_cap if fdet \
            else int(self.detector.max_iterations)
        nv, nq = self.nvoxels, self.noise.nphis
        args, stats = self.ar_loop_args()
        prior_means, prior_prec = args[4], args[5]
        outs = fused_ar_loop(*args, n_iters,
                             self._ar_fdet_consts() if fdet else None)
        means, prec, cov, amu, acov, aprec, nb, nc = outs[:8]
        if fdet:
            sel_init = nb[0] < 0
            nb = torch.abs(nb)
            n0 = s.post.noise
            means, prec, cov, nb, nc, amu, acov, aprec, prior_means, \
                prior_prec = (_lane_where(sel_init, old, new) for old, new in (
                    (s.post.means, means), (s.post.prec, prec),
                    (s.post.cov, cov), (n0.b, nb), (n0.c, nc),
                    (n0.alpha_means[:nq], amu),
                    (torch.stack([n0.alpha_cov[n, n] for n in range(nq)]),
                     acov),
                    (torch.stack([n0.alpha_prec[n, n] for n in range(nq)]),
                     aprec),
                    (s.post.prior_means, prior_means),
                    (s.post.prior_prec, prior_prec)))
        # the 2x2 alpha MVN: alpha_n is updated by echo group n; with one
        # echo alpha_2 keeps its prior
        ap11 = float(self.noise_prior.alpha_prec[1, 1, 0])
        zero = torch.zeros_like(amu[0])
        acv = list(acov) + [torch.full_like(zero, 1.0 / ap11)] * (2 - nq)
        apr = list(aprec) + [torch.full_like(zero, ap11)] * (2 - nq)
        noise_post = Ar1NoiseState(
            alpha_means=torch.stack(list(amu) + [zero] * (2 - nq)),
            alpha_cov=torch.stack([torch.stack([acv[0], zero]),
                                   torch.stack([zero, acv[1]])]),
            alpha_prec=torch.stack([torch.stack([apr[0], zero]),
                                    torch.stack([zero, apr[1]])]),
            b=nb, c=nc)
        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              noise_post)
        # fprior is zero for the priors this route admits
        f = self.noise.free_energy_stats(
            noise_post, self.noise_prior, means, prec, cov, prior_means,
            prior_prec, stats) if self.need_f else s.f
        its = outs[9][0].to(torch.int32) if fdet else torch.full(
            (nv,), n_iters, dtype=torch.int32, device=self.device)
        conv = s.conv._replace(
            its=its, done=torch.ones(nv, dtype=torch.bool, device=self.device))
        return s._replace(it=n_iters, post=post, centre=means, f=f,
                          conv=conv)

    # -- the nonlinear routes -------------------------------------------
    def _transforms(self):
        return [pm.transform for pm in self.params]

    def _kernel_data(self):
        """The [T,V] data plane in the compute dtype."""
        return self.data.to(self.dtype).contiguous()

    def nl_loop_args(self, s):
        """The whole-loop kernel's inputs for the loop state s:
        (centre0, prior_means, prior_prec, data, qmasks, consts)."""
        init_b, init_c = self._noise_init()
        consts = pack_nl_consts(
            self.noise_prior.b.cpu(), self.noise_prior.c.cpu(),
            self.noise.ntimes_per_group, init_b, init_c, self.noise.nphis)
        # initial linearization centre: the (model-initialized)
        # posterior means of initial_state
        return (s.post.means.contiguous(), *self._prior_planes(),
                self._kernel_data(), self.noise.qmasks, consts)

    def _run_nl_loop(self, s):
        """Whole-loop nonlinear kernel (vb.py:1197-1262): the whole fixed
        point in one launch. maxits: F assembled in torch from the
        kernel's quadratics at the final means; an F-based detector: the
        kernel's per-lane F and iteration counts, and under freduce the
        engine's initial posterior restored where the kernel reverted."""
        n_iters = int(self.detector.max_iterations)
        nv = self.nvoxels
        args = self.nl_loop_args(s)
        prior_means, prior_prec = args[1], args[2]
        kind = type(self.detector).name
        det = None if kind == "maxits" else self._nl_fdet_consts()
        pd0 = sm.diag_of(s.post.cov).contiguous() if kind == "freduce" \
            else None
        means, prec, cov, nb, nc, fkqk, ftr = fused_nl_loop(
            self.model, self._transforms(), *args, n_iters, self.need_f,
            self.noise.locked_noise_stdev, detector=det, post_var0=pd0,
            functor=self.functor, supp=self.supp)
        if kind == "freduce":
            rev = fkqk[1] > 0.5
            means, prec, cov, nb, nc = (
                _lane_where(rev, old, new) for old, new in (
                    (s.post.means, means), (s.post.prec, prec),
                    (s.post.cov, cov), (s.post.noise.b, nb),
                    (s.post.noise.c, nc)))
        noise_post = WhiteNoiseState(nb, nc)
        post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                              noise_post)
        if det is not None:
            # the kernel's per-lane F and iteration counts (fprior is
            # zero for the priors this route admits)
            f = fkqk[0]
            conv = s.conv._replace(
                its=ftr[0].to(torch.int32), prev_f=f,
                done=torch.ones(nv, dtype=torch.bool, device=self.device))
            if kind == "freduce":
                conv = conv._replace(revert=rev)
            return s._replace(it=n_iters, post=post, centre=means, f=f,
                              conv=conv)
        if self.need_f:
            # fprior is zero for the (non-ARD, non-spatial) priors this
            # route admits
            f = self.noise.free_energy_from_parts(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, list(fkqk), list(ftr))
        else:
            f = s.f
        conv = s.conv._replace(
            its=torch.full((nv,), n_iters, dtype=torch.int32,
                           device=self.device),
            done=torch.ones(nv, dtype=torch.bool, device=self.device))
        return s._replace(it=n_iters, post=post, centre=means, f=f,
                          conv=conv)

    def _nl_fdet_consts(self):
        """The whole-loop kernel's detector constants (vb.py:1264-1326):
        the detector, and the voxel-invariant pieces of the white ELBO
        with the noise shape fixed at c_post (constant from the first
        update on; free_energy_from_parts, noisemodel_white.cc:
        365-454), host float64. With c = (n-1)/2 + c0 the digamma
        coefficient collapses to 1/2 per group and log(b)'s to
        n/2 + c0. f_const_init is the same block at the initial shape
        c_init (freduce's reverted-lane F)."""
        self._ensure_noise_prior()
        nq = self.noise.nphis
        b0 = self.noise_prior.b.double().cpu().numpy().reshape(nq)
        c0 = self.noise_prior.c.double().cpu().numpy().reshape(nq)
        _, post1 = self.noise.initial_state(1, self.dtype)
        c_init = float(post1.c[0, 0])
        shared = 0.5 * self.nparams \
            - 0.5 * self.noise.n_unmasked * math.log(2 * math.pi)

        def c_terms(qi, c):
            n_q = float(self.noise.ntimes_per_group[qi])
            return (math.lgamma(c) + c
                    + (n_q * 0.5 + c0[qi] - c) * _digamma(c)
                    - math.lgamma(c0[qi]) - c0[qi] * math.log(b0[qi]))

        lb_coeff, f_const, f_const_init = [], shared, shared
        for qi in range(nq):
            n_q = float(self.noise.ntimes_per_group[qi])
            c_post = (n_q - 1.0) * 0.5 + c0[qi]
            lb_coeff.append(n_q * 0.5 + c0[qi])
            f_const += c_terms(qi, c_post)
            f_const_init += c_terms(qi, c_init)
        return {"det": self.detector, "lb_coeff": lb_coeff,
                "f_const": f_const, "f_const_init": f_const_init}

    def _fused_update(self, s, prior_means, prior_prec):
        """One theta + noise update through the fused-iteration kernel
        (vb.py:891-951): (means, prec, cov, noise_post, F quadratics);
        under lm with the lanes' damping (the kernel's LM branch)."""
        post = s.post
        phi = (post.noise.b * post.noise.c).contiguous()   # [Q,V]
        means, prec, cov, nkqk, ntr, fkqk, ftr = fused_iteration(
            self.model, self._transforms(), s.centre.contiguous(),
            prior_means.contiguous(), prior_prec.contiguous(), phi,
            self._kernel_data(), self.noise.qmasks, self.need_f,
            s.conv.alpha.contiguous() if self.is_lm else None,
            functor=self.functor)
        noise_post = self.noise._noise_from_quadratics(
            list(nkqk), list(ntr), self.noise_prior)
        return means, prec, cov, noise_post, (fkqk, ftr)

    def _linearize(self, centre, data, coords=None, supp=None,
                   locked=None):
        """(offset [T,V], jac [P,T,V] or None) at centre, or at the
        locked centres when locked-linear-from-mvn is in force
        (vb.py:753-758): with a design (the direct route) the offset is
        design @ centre and J the design itself. coords/supp/locked
        default to the run's planes (a block's slices in blocked
        spatial sweeps)."""
        if self.locked_linear:
            centre = self.locked_centres if locked is None else locked
        if self.design is not None:
            return self._design_tensor() @ centre, None
        return self.linearizer(
            centre, data, self.coords if coords is None else coords,
            self.supp if supp is None else supp)

    def _design_kw(self):
        """design= for the noise model's updates on the direct route."""
        return {} if self.design is None else {"design":
                                               self._design_tensor()}

    def _iteration(self, s, route, stats=None):
        """One VB iteration (vb.py:954-1047) on the per-iteration routes:
        'pallas' (the fused kernel), 'xla' (the noise model's updates
        from the sufficient statistics `stats`), 'xla-generic'
        (linearize, then the noise model's generic updates) or
        'xla-direct' (the same with the design as the Jacobian)."""
        post = s.post
        data = self.data.to(self.dtype)
        if route in ("xla-generic", "xla-direct"):
            offset_c, jac_c = self._linearize(s.centre, data)
        # 1. save the current state as best-so-far where the detector
        #    flagged it (top of the reference do-loop, inference_vb.cc:451)
        best = _lane_where(s.conv.save, post, s.best) \
            if self.detector.tracks_best else None
        prior_means, prior_prec, f_contribs = self.prior_setup.apply(
            post.prior_means, post.prior_prec, post.means,
            sm.diag_of(post.cov), s.it,
            base_means=self.prior_setup.base_means)
        # the reference assigns (not sums) each prior's F term, so only
        # the last parameter's survives (inference_vb.cc:460-463)
        fprior = f_contribs[-1]

        if route == "pallas":
            means, prec, cov, noise_post, fparts = self._fused_update(
                s, prior_means, prior_prec)
        elif route == "xla":
            means, prec, cov, _ok = self.noise.update_theta_stats(
                post.noise, prior_means, prior_prec, stats,
                s.conv.alpha if self.is_lm else None, s.centre)
            noise_post = self.noise.update_noise_stats(
                post.noise, self.noise_prior, means, cov, stats)
        else:
            means, prec, cov, _ok = self.noise.update_theta(
                post.noise, post.means, prior_means, prior_prec,
                s.centre, offset_c, jac_c, data,
                s.conv.alpha if self.is_lm else None, **self._design_kw())
            noise_post = self.noise.update_noise(
                post.noise, self.noise_prior, means, cov,
                s.centre, offset_c, jac_c, data, **self._design_kw())
        # the next iteration relinearizes about the new means, or the
        # fixed centres under locked-linear-from-mvn (vb.py:1000)
        centre = self.locked_centres if self.locked_linear else means
        new_post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                                  noise_post)

        # free energy at the new linearization
        if self.need_f and route == "pallas":
            f = self.noise.free_energy_from_parts(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, list(fparts[0]), list(fparts[1]))
            f = f + fprior
        elif self.need_f and route == "xla":
            f = self.noise.free_energy_stats(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, stats)
            f = f + fprior
        elif self.need_f:
            offset, jac = self._linearize(centre, data)
            f = self.noise.free_energy(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, centre, offset, jac, data,
                **self._design_kw())
            f = f + fprior
        else:
            f = s.f
        conv = self.detector.test(s.conv, f)
        new = VBLoopState(it=s.it + 1, post=new_post, centre=centre, f=f,
                          fprior=fprior, conv=conv, best=best)

        # lanes already done before this iteration keep their state
        merged = _lane_where(~s.conv.done, new, s._replace(fhist=None))
        fhist = s.fhist
        if self.save_fhist:
            # frozen lanes keep writing their last F, as the reference
            # pads its history (inference_vb.cc:1035-1044)
            fhist[s.it] = merged.f
        return merged._replace(it=new.it, fhist=fhist)

    def _run_iterations(self, s, route):
        """The per-iteration loop (vb.py:2028-2048): on 'xla' the
        sufficient statistics first, once; maxits runs a static trip
        count; the F-based detectors (lm among them) a while loop that
        runs while some lane is not done, up to max_iter_cap iterations.
        Then the finalize step."""
        self._ensure_noise_prior()
        stats = self.noise.make_design_stats(self._design_tensor(),
                                             self.data) \
            if route == "xla" else None
        if type(self.detector).name == "maxits":
            for _ in range(int(self.detector.max_iterations)):
                s = self._iteration(s, route, stats)
        else:
            while s.it < self.max_iter_cap and not bool(s.conv.done.all()):
                s = self._iteration(s, route, stats)
        return self._finalize(s, stats)

    def _finalize(self, s, stats=None):
        """Post-loop save/revert (vb.py:2603-2627, inference_vb.cc:
        505-525): lanes flagged revert take the best state, and their F
        is recomputed there (from the statistics on the 'xla' route)."""
        if not self.detector.tracks_best:
            return s._replace(centre=s.post.means)
        best = _lane_where(s.conv.save, s.post, s.best)
        post = _lane_where(s.conv.revert, best, s.post)
        f = s.f
        if self.need_f and stats is not None:
            f_rev = self.noise.free_energy_stats(
                post.noise, self.noise_prior, post.means, post.prec,
                post.cov, post.prior_means, post.prior_prec,
                stats) + s.fprior
            f = torch.where(s.conv.revert, f_rev, s.f)
        elif self.need_f:
            data = self.data.to(self.dtype)
            offset, jac = self._linearize(post.means, data)
            f_rev = self.noise.free_energy(
                post.noise, self.noise_prior, post.means, post.prec,
                post.cov, post.prior_means, post.prior_prec, post.means,
                offset, jac, data, **self._design_kw()) + s.fprior
            f = torch.where(s.conv.revert, f_rev, s.f)
        return s._replace(post=post, centre=post.means, f=f)

    def continuation_route(self):
        """The route a programmatic initial posterior runs on: the
        whole-loop and whole-program kernels always start from the model
        default, so they step aside to the per-iteration routes
        (vb.py:2516-2539): the fixed-design kernel routes to 'xla'."""
        if self.route in DESIGN_KERNEL_ROUTES:
            return "xla"
        if self.route != "pallas-loop-nl":
            return self.route
        mode = self.options.get_string("engine-kernel", "auto")
        return "pallas" if mode in ("auto", "pallas") \
            and self.generic is None else "xla-generic"

    def run(self, continue_means=None, continue_cov=None,
            continue_noise=None):
        """The VB run -> VBResult. continue_means [V,P] / continue_cov
        [V,P,P] / continue_noise (a noise state of [Q,V] planes) start
        it from a programmatic posterior (the per-iteration routes).
        Then, with mcsteps > 0, the motion-correction steps (voxelwise VB
        only) and, with spatial-prior-output-correction, the
        likelihood-only posterior (JAX vb.py:2421-2427)."""
        result = self._run_vb(continue_means, continue_cov, continue_noise)
        if self.num_mcsteps > 0 and type(self) is VBInference:
            result = self._run_mc_steps(result)
        if self.options.get_bool("spatial-prior-output-correction"):
            result = self.compute_noprior(result)
        return result

    def _noprior_chunk(self):
        """Voxels per compute_noprior pass: the whole volume, or a
        blocked spatial run's block (its data stays on the host)."""
        return self.nvoxels

    def compute_noprior(self, result):
        """thetaWithoutPrior (--spatial-prior-output-correction; JAX
        vb.py:2429-2461): the likelihood-only posterior, precision J'XJ
        with no prior term and means (J'XJ)^-1 J'X(data - g(m) + Jm), at
        the final state: the noise model's update_theta with zero prior
        planes at the result's means and noise, in voxel chunks, on any
        route (a kernel route's result too). Where J'XJ is singular the
        update's jitter retry decides, as in the JAX package."""
        p, nv = self.nparams, self.nvoxels
        nst = self.noise.state_from_mvn(result.noise_means, result.noise_cov)
        chunk = self._noprior_chunk()
        # the design is the Jacobian where the noise model takes it
        # directly; a statistics-only noise model (AR) linearizes it
        direct = self.design is not None and getattr(
            self.noise, "fixed_design_direct", True)
        outs_m, outs_c = [], []
        for lo in range(0, nv, chunk):
            hi = min(lo + chunk, nv)

            def ship(x):
                return None if x is None else x[..., lo:hi].to(self.device)
            means = torch.as_tensor(np.asarray(result.means)[lo:hi].T,
                                    dtype=self.dtype, device=self.device)
            noise = type(nst)(*(ship(torch.as_tensor(x)).to(self.dtype)
                                for x in nst))
            data = ship(self.data).to(self.dtype)
            centre = ship(self.locked_centres) if self.locked_linear \
                else means
            if direct:
                offset, jac = self._design_tensor() @ centre, None
                kw = {"design": self._design_tensor()}
            else:
                offset, jac = self.linearizer(centre, data,
                                              ship(self.coords),
                                              ship(self.supp))
                kw = {}
            zeros = torch.zeros((p, hi - lo), dtype=self.dtype,
                                device=self.device)
            m, _, cov, _ = self.noise.update_theta(
                noise, means, zeros, zeros, means, offset, jac, data, None,
                **kw)
            outs_m.append(m.t().cpu().numpy())
            outs_c.append(cov.permute(2, 0, 1).cpu().numpy())
        return result._replace(noprior_means=np.concatenate(outs_m),
                               noprior_cov=np.concatenate(outs_c))

    def _run_mc_steps(self, result):
        """Motion correction interleaved with VB continuation passes
        (MCobj::run_mc; JAX vb.py:2462-2526): per step, every timepoint of
        the original data registered to the model fit at the current
        means (core/motion.py), then VB continued on the realigned data
        from the current posterior and noise (continuation_route()).
        Sets mc_translations (per step, the largest |translation| of the
        volume centre, voxels), mc_saturated (a step came within 75% of
        the pyramid's capture range) and mc_capture_range."""
        from ..core.motion import make_registerer, register_timeseries
        # repeated run() calls register from the original data, never
        # from data an earlier call realigned
        if self._mc_orig_data is None:
            self._mc_orig_data = self.data
        orig = self._mc_orig_data
        coords = self.coords.t().cpu().numpy()                 # [V,3]
        shape = tuple(int(c) + 1 for c in coords.max(axis=0))
        if self._mc_registerer is None:
            self._mc_registerer = make_registerer(
                coords, shape, dof=self.mc_dof, device=self.device)
        reg = self._mc_registerer
        self.mc_translations = []
        self.mc_saturated = False
        self.mc_capture_range = reg.capture_range
        for _ in range(self.num_mcsteps):
            fit = self.evaluate_model(np.asarray(result.means).T)  # [T,V]
            realigned, disp = register_timeseries(
                orig, fit, coords, shape, dof=self.mc_dof, reg=reg)
            step_max = float(np.abs(disp).max())
            self.mc_translations.append(step_max)
            if step_max >= 0.75 * reg.capture_range:
                self.mc_saturated = True
            self.data = realigned.to(self.data.dtype).contiguous()
            cn = self.noise.state_from_mvn(result.noise_means,
                                           result.noise_cov)
            result = self._run_vb(continue_means=result.means,
                                  continue_cov=result.cov,
                                  continue_noise=cn)
        return result

    def _run_vb(self, continue_means=None, continue_cov=None,
                continue_noise=None):
        """The route's run (a continued run on continuation_route(), its
        kernel built first) -> VBResult."""
        route = self.route
        if continue_means is not None or continue_noise is not None:
            route = self.continuation_route()
            if route != self.route:
                self._require_kernel_instance(route)
        s = self.initial_state(continue_means, continue_cov, continue_noise)
        if route in ("spectral-whole", "spectral-fused", "spectral-xstats"):
            final = self._run_spectral_whole(s)
        elif route == "pallas-whole":
            final = self._run_whole(s)
        elif route == "pallas-loop":
            final = self._run_loop_kernel(s)
        elif route == "pallas-loop-ar":
            final = self._run_ar_loop(s)
        elif route == "pallas-loop-nl":
            final = self._run_nl_loop(s)
        elif route == "spectral":
            final = self._run_spectral(s)
        else:
            final = self._run_iterations(s, route)
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

        fhist = None
        if self.save_fhist:
            # the final F is appended, as in the reference
            # (inference_vb.cc:553-554)
            fhist = host(s.fhist[:s.it])
            if f is not None:
                fhist = np.concatenate([fhist, f[None]], axis=0)

        return VBResult(
            means=means, cov=cov, noise_means=nmeans, noise_cov=ncov,
            free_energy=f, fhistory=fhist,
            iterations=host(s.conv.its), bad_voxels=bad)


def _no_voxel_data(key):
    raise KeyError(key)


def generatable(functor, nparams, nq, kernel):
    """True where a functor generated from a model can serve kernel
    (ops/_cuda.py GEN_KERNELS: "nl_loop", "vb_iter", "nlls") on the card:
    one was generated (functor not None; the generator refuses some ops)
    and P, Q (None for the NLLS kernel, which has no noise groups) lie
    within csrc/vb_device.cuh's kWideMaxP (kernel 7: kCoopMaxP),
    kWideMaxQ."""
    max_p, max_q = _cuda.gen_limits(kernel)
    return functor is not None and nparams <= max_p and (nq or 1) <= max_q


def require_card_instance(route, p, q, has_instance, functor_ok):
    """Raise NotImplementedError where route's kernel (ROUTE_KERNEL)
    cannot serve a run of P parameters and Q noise groups (None for the
    NLLS kernel) on the card: has_instance(route) is false (no
    hand-written instance at the shape) and so is functor_ok(route) (no
    functor generated from the model can serve it: kernels 6, 7 and 8
    only). The JAX engine runs its kernel at such shapes, so the card
    takes no other route in its place. Routes without a kernel pass. A
    decision from the lists alone: nothing is built or launched here."""
    if route not in ROUTE_KERNEL or has_instance(route) \
            or functor_ok(route):
        return
    kernel = ROUTE_KERNEL[route]
    shape = f"P={p}" + ("" if q is None else f", Q={q}")
    gen = (", and no functor can be generated from the model (P, Q above "
           "csrc/vb_device.cuh kWideMaxP, kWideMaxQ, or an op the "
           "generator lacks)" if kernel in (6, 8) else "")
    if kernel == 7:
        max_p, max_q = _cuda.instance_limits("nl", "vb_iter")
        gen = (f": its cooperative form holds a voxel's state in one "
               f"block's shared memory, 227 KB, which bounds P at {max_p} "
               f"(csrc/vb_device.cuh kCoopMaxP; Q at {max_q}, kWideMaxQ), "
               "for a generated functor too" if p > max_p or q > max_q
               else ", and no functor can be generated from the model (an "
               "op the generator lacks)")
    raise NotImplementedError(
        f"no ({shape}) instance of kernel {kernel} "
        f"({INSTANCE_LISTS[kernel]}){gen}, so the '{route}' route cannot run "
        "this on the card, where the JAX engine runs its kernel; "
        "device='cpu' runs the route's plain version")


def supp_plane(suppdata, nvoxels, dtype, device):
    """[V,S] suppdata (numpy, at the API boundary) as an [S,V] plane on
    the device, or None for none (S = 0), as the JAX engines keep it."""
    if suppdata is None:
        return None
    arr = np.asarray(suppdata).reshape(nvoxels, -1)
    if arr.shape[1] == 0:
        return None
    return torch.as_tensor(arr, dtype=dtype).t().contiguous().to(device)


def _digamma(x):
    """Digamma by recurrence and the asymptotic (Bernoulli) series,
    float64-exact far beyond the kernel's float32 assembly (the JAX
    engine's _nl_fdet_consts helper)."""
    r = 0.0
    while x < 6.0:
        r -= 1.0 / x
        x += 1.0
    inv2 = 1.0 / (x * x)
    return (r + math.log(x) - 0.5 / x
            - inv2 * (1 / 12 - inv2 * (1 / 120 - inv2
                                       * (1 / 252 - inv2 / 240))))
