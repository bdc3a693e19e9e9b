"""Python-native API: numpy in, numpy out.

Port of fabber_core_tpu/api.py (the reference binding's
`Fabber.run_with_data` role, py/fabber.py:489-771): options are a dict,
voxel data are numpy volumes, outputs come back as numpy volumes keyed
as the reference names them (mean_<param>, zstat_<param>,
noise_means, freeEnergy, modelfit, finalMVN, ...). The device is
chosen once, when the FabberTpu object is made.
"""

import numpy as np
import torch

from . import resolve_device, runner
from .core.volume import VolumeGeometry, VoxelDataStore
from .easylog import EasyLog
from .exceptions import FabberError
from .inference.nlls import NLLSInference
from .inference.spatial import SpatialVBInference
from .inference.vb import VBInference
from .models import get_model_class, known_models, resolve_parameters
from .models.base import EvalContext
from .options import GLOBAL_OPTIONS, RunOptions


class FabberRun:
    """A completed run: .data maps output name -> numpy volume."""

    def __init__(self, data, log):
        self.data = data
        self.log = log


class FabberTpu:
    """Library-mode interface (the reference's `Fabber` class role).

    device: "cuda" (default; the CUDA kernels, raises without a card)
    or "cpu" (the kernels' plain-torch versions)."""

    def __init__(self, model_files=None, device="cuda"):
        self.device = device
        if model_files:
            from .models import load_models_from_file
            for f in model_files:
                load_models_from_file(f)

    # -- introspection ----------------------------------------------------
    def get_models(self):
        return known_models()

    def get_methods(self):
        return ["vb", "spatialvb", "nlls"]

    def get_options(self, method=None, model=None):
        """Returns (list of option dicts, description string)."""
        if model:
            cls = get_model_class(model)
            specs, desc = cls.get_options(), cls.describe()
        elif method == "vb":
            specs, desc = VBInference.get_options(), \
                "Variational Bayes inference technique"
        elif method == "spatialvb":
            specs, desc = SpatialVBInference.get_options(), \
                "Spatial Variational Bayes inference technique"
        elif method == "nlls":
            specs, desc = NLLSInference.get_options(), \
                "Non-linear least squares inference technique"
        elif method:
            raise FabberError(f"Unknown method: {method}")
        else:
            specs, desc = GLOBAL_OPTIONS, "Fabber run options"
        opts = [{
            "name": s.name, "description": s.description, "type": s.type,
            "optional": not s.required, "default": s.default,
        } for s in specs]
        return opts, desc

    def get_model_params(self, options):
        opts = _to_options(options)
        model = get_model_class(opts.get_string("model"))(opts)
        return [p.name for p in resolve_parameters(model, opts)]

    def get_model_outputs(self, options):
        opts = _to_options(options)
        model = get_model_class(opts.get_string("model"))(opts)
        return [k for k in model.outputs() if k]

    # -- model forward evaluation ----------------------------------------
    def model_evaluate(self, options, param_values, nt, indata=None,
                       output_name="", suppdata=None):
        """Evaluate the model's forward prediction for named parameter
        values, in model space (fabber_capi.h:260), on this object's
        device (float64 there); suppdata: the voxel's [S] supplemental
        values, or None. Returns a numpy array."""
        dev = resolve_device(self.device)
        opts = _to_options(options)
        model = get_model_class(opts.get_string("model"))(opts)
        params = resolve_parameters(model, opts)
        names = [p.name for p in params]
        missing = [n for n in names if n not in param_values]
        if missing:
            raise FabberError(f"Model parameters not specified: {missing}")
        f64 = {"dtype": torch.float64, "device": dev}
        pvec = torch.tensor([float(param_values[n]) for n in names], **f64)
        data = torch.zeros(nt, **f64) if indata is None \
            else torch.as_tensor(np.asarray(indata, np.float64), **f64)
        supp = None if suppdata is None \
            else torch.as_tensor(np.asarray(suppdata, np.float64), **f64)
        ctx = EvalContext(data=data, coords=torch.zeros(3, **f64),
                          suppdata=supp, nt=nt)
        return model.evaluate(pvec, ctx, key=output_name).cpu().numpy()

    # -- main entry -------------------------------------------------------
    def run_with_data(self, options, data, mask=None, progress_cb=None):
        """Run inference on in-memory volumes.

        options: dict (bools use presence semantics); data: dict of
        numpy arrays, must include "data" [nx,ny,nz,nt]; mask
        [nx,ny,nz] optional. Returns FabberRun.
        """
        if "data" not in data and "data1" not in data:
            raise FabberError("Main voxel data not provided")
        main = np.asarray(data.get("data", data.get("data1")))
        if main.ndim != 4:
            raise FabberError("Main data must be 4-dimensional")

        geom = VolumeGeometry(main.shape[:3], mask)
        store = VoxelDataStore(geom)
        for key, arr in data.items():
            store.set(key, np.asarray(arr))

        result = runner.run(_to_options(options), store, log=EasyLog(),
                            progress_cb=progress_cb, device=self.device)

        out = {}
        for key, arr in result.outputs.items():
            arr = np.asarray(arr, np.float32)
            if arr.ndim == 2 and arr.shape[1] == 1:
                arr = arr[:, 0]  # single-volume outputs map to 3-D
            out[key] = geom.from_voxels(arr)
        return FabberRun(out, result.log)


def _to_options(options):
    if isinstance(options, RunOptions):
        return options
    return RunOptions(options)
