"""Run orchestration: options + voxel data -> inference -> outputs.

Port of fabber_core_tpu/runner.py for method=vb (FabberRunData::Run +
InferenceTechnique::SaveResults, rundata.cc:248-311,
inference.cc:112-281): creates the model, resolves parameters, runs the
VB engine on the requested device and assembles the output data
products (means/std/var/zstat with model-space back-transform, model
fit, residuals, noise stats, free energy, finalMVN checkpoint).
Outputs are a dict of voxel-major numpy arrays; the CLI and API map
them back to volumes or files.
"""

import time

import numpy as np

from .easylog import EasyLog
from .exceptions import FabberError, BadVoxelError
from .inference.vb import VBInference
from .io import mvn as mvn_io
from .models import (get_model_class, load_models_from_file,
                     resolve_parameters)
from .models.base import SPATIAL_PRIOR_TYPES
from .version import __version__

# methods and run modes of the JAX runner the port does not have yet
_UNPORTED = {
    "spatialvb": "ROADMAP Queue 1 item 16",
    "nlls": "ROADMAP Queue 1 item 14",
    "shard-voxels": "ROADMAP Queue 1 item 18",
    "distributed": "ROADMAP Queue 1 item 18",
    "continue-from-mvn": "ROADMAP Queue 1 item 17",
    "output-only": "ROADMAP Queue 1 item 17",
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
    if method in _UNPORTED or is_spatial(options, params):
        raise _not_ported(method if method in _UNPORTED else "spatialvb")
    if method != "vb":
        raise FabberError(f"Unrecognized inference method: {method}")
    for mode in ("shard-voxels", "distributed", "output-only"):
        if options.get_bool(mode):
            raise _not_ported(mode)
    if store.have("continue-from-mvn") or options.have("continue-from-mvn"):
        raise _not_ported("continue-from-mvn")
    if progress_cb:
        progress_cb(0, nvoxels)

    engine = VBInference(model, options, data, voxel_data_getter=store.get,
                         device=device, coords=store.geom.coords)
    engine.progress_cb = progress_cb
    log.log(f"Vb::Engine route: {engine.route_description()}")
    result = engine.run()

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
