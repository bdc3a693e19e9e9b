"""Run orchestration: options + voxel data -> inference -> outputs.

Port of fabber_core_tpu/runner.py for method=vb, method=spatialvb (also
reached through spatial prior types) and method=nlls (FabberRunData::Run
+ InferenceTechnique::SaveResults,
rundata.cc:248-311, inference.cc:112-281): creates the model, resolves
parameters, loads a previous run's MVN (continue-from-mvn, merged by
name under continue-from-params), runs the engine on the requested
device (or, under output-only, takes the loaded MVN as the result) and
assembles the output data products (means/std/var/zstat with
model-space back-transform, model fit, residuals, noise stats, free
energy, finalMVN checkpoint, the likelihood-only maps of
spatial-prior-output-correction) and logs the motion-correction steps.
Outputs are a dict of voxel-major numpy arrays; the CLI and API map
them back to volumes or files.
"""

import time

import numpy as np

from .easylog import EasyLog
from .exceptions import FabberError, BadVoxelError
from .inference.nlls import NLLSInference
from .inference.spatial import SpatialVBInference
from .inference.vb import VBInference, VBResult
from .io import mvn as mvn_io
from .models import (get_model_class, load_models_from_file,
                     resolve_parameters)
from .models.base import SPATIAL_PRIOR_TYPES
from .version import __version__

# run modes of the JAX runner the port does not have yet
_UNPORTED = {
    "shard-voxels": "ROADMAP Queue 1 item 18",
    "distributed": "ROADMAP Queue 1 item 18",
}


def _not_ported(what):
    return NotImplementedError(
        f"'{what}' is not ported to fabber_core_tpu_torch yet "
        f"({_UNPORTED[what]})")


def is_spatial(options, params):
    """Spatial mode: method name or any spatial prior type
    (inference_vb.cc:334-358)."""
    if options.get_string("method") == "spatialvb":
        return True
    return any(p.prior_type in SPATIAL_PRIOR_TYPES for p in params)


class RunResult:
    def __init__(self, outputs, log, param_names, nvoxels):
        self.outputs = outputs  # key -> [V] or [V,T] arrays
        self.log = log
        self.param_names = param_names
        self.nvoxels = nvoxels


def run(options, store, log=None, progress_cb=None, device="cuda"):
    """Execute a full run on `device` ("cuda" or "cpu").

    options: RunOptions; store: VoxelDataStore with 'data' (or data<n>)
    plus any mask-derived geometry already applied.
    """
    log = log or EasyLog()
    start = time.time()
    log.log(f"fabber_core_tpu_torch release: {__version__}")
    log.log("Start time: " + time.ctime(start))
    for k, v in sorted(options.items()):
        log.log(f"Option {k}={v}")

    if options.have("loadmodels"):
        load_models_from_file(options.get_string("loadmodels"))

    model = get_model_class(options.get_string("model"))(options)
    params = resolve_parameters(model, options)
    param_names = [p.name for p in params]
    log.log(f"Model has {len(params)} parameters: {', '.join(param_names)}")

    data = store.get_main_data(options)
    nvoxels, nt = data.shape
    log.log(f"Data size = {nt} timepoints by {nvoxels} voxels")

    method = options.get_string("method")
    if method not in ("vb", "spatialvb", "nlls"):
        raise FabberError(f"Unrecognized inference method: {method}")
    for mode in ("shard-voxels", "distributed"):
        if options.get_bool(mode):
            raise _not_ported(mode)
    if progress_cb:
        progress_cb(0, nvoxels)

    # restart state from a previous run's MVN checkpoint
    cont_means = cont_cov = None
    if store.have("continue-from-mvn") or options.have("continue-from-mvn"):
        options.mark_used("continue-from-mvn")
        cont_means, cont_cov = _load_continue_mvn(options, store, params,
                                                  log)

    getter, coords = store.get, store.geom.coords
    # per-voxel supplemental data, handed to the model as ctx.suppdata
    # (JAX runner.py:67)
    suppdata = store.get("suppdata") if store.have("suppdata") else None
    if method == "nlls":
        engine = NLLSInference(model, options, data,
                               voxel_data_getter=getter, device=device,
                               coords=coords, suppdata=suppdata)
        engine.progress_cb = progress_cb
        log.log(f"NLLS::Engine route: {engine.route_description()}")
        result = engine.run()
    else:
        engine_cls = VBInference
        if is_spatial(options, params):
            engine_cls = SpatialVBInference
            if options.get_bool("save-free-energy-history"):
                log.warn("save-free-energy-history is a voxelwise-mode "
                         "output; the spatial loop does not record "
                         "per-iteration history")
        engine = engine_cls(model, options, data, voxel_data_getter=getter,
                            device=device, coords=coords,
                            continued=cont_means is not None,
                            suppdata=suppdata)
        engine.progress_cb = progress_cb
        log.log(f"Vb::Engine route: {engine.route_description()}")
        result = _run_vb(engine, options, params, cont_means, cont_cov, log)
        _log_motion(engine, log)
        # Penny-2005 diagnostic, logged as the reference does
        # (inference_vb.cc:753-755)
        for k, val in enumerate(getattr(engine, "coefficient_resels", ())):
            log.log(f"Vb::Coefficient resels per voxel for param "
                    f"{k + 1}: {val:.6g}")

    if result.bad_voxels.any():
        n = int(result.bad_voxels.sum())
        if not options.get_bool("allow-bad-voxels"):
            raise BadVoxelError(np.flatnonzero(result.bad_voxels),
                                f"({n} voxels failed)")
        log.warn(f"{n} voxels failed numerically; output zero-mean "
                 "identity-covariance (allow-bad-voxels set)")

    outputs = _save_results(options, model, params, result, engine,
                            data, log)

    unused = options.unused()
    if unused:
        log.warn("The following options were unused - check spelling: "
                 + ", ".join(unused))
    log.reissue_warnings()
    end = time.time()
    log.log("End time: " + time.ctime(end))
    log.log(f"Duration: {end - start:.3f} seconds.")
    return RunResult(outputs, log.contents(), param_names, nvoxels)


def _run_vb(engine, options, params, cont_means, cont_cov, log):
    """The VB run, from the loaded MVN where there is one; under
    output-only the MVN itself is the result."""
    if options.get_bool("output-only"):
        if cont_means is None:
            raise FabberError(
                "output-only can only be used with continue-from-mvn")
        log.log("output-only set - not performing any calculations")
        return _result_from_mvn(engine, cont_means, cont_cov)
    cn = None
    if cont_means is not None:
        p = len(params)
        if cont_means.shape[1] > p:
            cn = engine.noise.state_from_mvn(cont_means[:, p:],
                                             cont_cov[:, p:, p:])
        else:
            # a checkpoint without a noise block (an NLLS finalMVN):
            # the default initial noise
            log.log("continue-from-mvn has no noise block; using default "
                    "initial noise")
        cont_means, cont_cov = cont_means[:, :p], cont_cov[:, :p, :p]
    return engine.run(cont_means, cont_cov, cn)


def _log_motion(engine, log):
    """Each motion-correction step's largest translation, and the
    warning where a step came near the pyramid's capture range (JAX
    runner.py:90-102)."""
    mc_shifts = getattr(engine, "mc_translations", None)
    if not mc_shifts:
        return
    for k, val in enumerate(mc_shifts):
        log.log(f"Motion correction step {k + 1}/{len(mc_shifts)}: "
                f"max |translation| {val:.4f} voxels")
    if getattr(engine, "mc_saturated", False):
        rng = getattr(engine, "mc_capture_range", 2.0)
        log.warn(
            "Motion correction estimated displacements near its "
            f"capture range (+-{rng:.0f} voxels, multi-resolution "
            "Gauss-Newton pyramid): true subject motion may exceed "
            "it and be under-corrected. Pre-register the data "
            "externally if large motion is expected.")


def _result_from_mvn(engine, means, cov):
    """A VBResult straight from a loaded MVN (output-only mode)."""
    p = engine.nparams
    return VBResult(
        means=means[:, :p], cov=cov[:, :p, :p],
        noise_means=means[:, p:], noise_cov=cov[:, p:, p:],
        free_energy=None, fhistory=None,
        iterations=np.zeros(means.shape[0], int),
        bad_voxels=np.zeros(means.shape[0], bool))


def _load_continue_mvn(options, store, params, log):
    """Load a previous run's MVN and, under continue-from-params (a file
    of the MVN's parameter names, one per line), merge it into this
    model's parameters by name: unmatched parameters take the model's
    posterior defaults, the noise block passes through
    (inference.cc:283-433)."""
    means, cov = mvn_io.unpack(np.asarray(store.get("continue-from-mvn")).T)
    param_file = options.get_string("continue-from-params", "")
    if not param_file:
        return means, cov
    with open(param_file) as f:
        file_names = [line.rstrip("\n") for line in f if line.strip()]
    log.log(f"Continuing from MVN with parameters: {file_names}")

    model_names = [p.name for p in params]
    n_file, n_model = len(file_names), len(model_names)
    nv = means.shape[0]
    n_noise = means.shape[1] - n_file
    new_means = np.zeros((nv, n_model + n_noise))
    new_cov = np.zeros((nv, n_model + n_noise, n_model + n_noise))
    for i, p in enumerate(params):
        new_means[:, i] = p.post.mean
        new_cov[:, i, i] = p.post.var
    loc = {}
    for i, name in enumerate(model_names):
        if name in file_names:
            loc[i] = file_names.index(name)
        else:
            log.log(f"{name}: not in file, set from model default")
    for name in file_names:
        if name not in model_names:
            log.warn(f"{name}: in file but not matched to model")
    for i, q in loc.items():
        new_means[:, i] = means[:, q]
        for j, r in loc.items():
            new_cov[:, i, j] = cov[:, q, r]
    new_means[:, n_model:] = means[:, n_file:]
    new_cov[:, n_model:, n_model:] = cov[:, n_file:, n_file:]
    return new_means, new_cov


def _save_results(options, model, params, result, engine, data, log):
    """Assemble output products (inference.cc:112-281 +
    inference_vb.cc:966-1051)."""
    outputs = {}
    nparams = len(params)

    if options.get_bool("save-mvn"):
        all_means = np.concatenate([result.means, result.noise_means], axis=1)
        nall = all_means.shape[1]
        all_cov = np.zeros((all_means.shape[0], nall, nall))
        all_cov[:, :nparams, :nparams] = result.cov
        all_cov[:, nparams:, nparams:] = result.noise_cov
        outputs["finalMVN"] = mvn_io.pack(all_means, all_cov).T  # [V, rows]

    want_param_stats = (options.get_bool("save-mean")
                        | options.get_bool("save-std")
                        | options.get_bool("save-zstat")
                        | options.get_bool("save-var"))
    if want_param_stats:
        for i, p in enumerate(params):
            m, var = p.transform.to_model_moments(
                result.means[:, i], result.cov[:, i, i])
            m, var = np.asarray(m), np.asarray(var)
            std = np.sqrt(var)
            if options.get_bool("save-mean"):
                outputs[f"mean_{p.name}"] = m
            if options.get_bool("save-zstat"):
                outputs[f"zstat_{p.name}"] = m / std
            if options.get_bool("save-std"):
                outputs[f"std_{p.name}"] = std
            if options.get_bool("save-var"):
                outputs[f"var_{p.name}"] = var

    if getattr(result, "noprior_means", None) is not None:
        # --spatial-prior-output-correction: the likelihood-only
        # posterior's maps (thetaWithoutPrior, noisemodel.h:132); under
        # spatial priors the unshrunk per-voxel estimates
        for i, p in enumerate(params):
            m, var = p.transform.to_model_moments(
                result.noprior_means[:, i], result.noprior_cov[:, i, i])
            outputs[f"mean_noprior_{p.name}"] = np.asarray(m)
            outputs[f"std_noprior_{p.name}"] = np.sqrt(np.asarray(var))

    if result.noise_means.shape[1] > 0:
        if options.get_bool("save-noise-mean"):
            outputs["noise_means"] = result.noise_means
        if options.get_bool("save-noise-std"):
            outputs["noise_stdevs"] = np.sqrt(
                np.diagonal(result.noise_cov, axis1=-2, axis2=-1))

    if options.get_bool("save-free-energy") and result.free_energy is not None:
        outputs["freeEnergy"] = result.free_energy

    save_fit = options.get_bool("save-model-fit")
    save_resid = options.get_bool("save-residuals")
    if save_fit or save_resid:
        means_planes = np.asarray(result.means).T  # [P,V] SoA layout
        fit = engine.evaluate_model(means_planes).t().cpu().numpy()  # [V,T]
        if save_fit:
            outputs["modelfit"] = fit
        if save_resid:
            outputs["residuals"] = data - fit

    log.log(f"Saved outputs: {', '.join(sorted(outputs))}")
    return outputs
