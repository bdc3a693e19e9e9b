"""Python side of the port's native C API (capi/fabber_capi_torch.cc).

Port of fabber_core_tpu/capi_backend.py with its interface and byte
layouts: one CApiContext per fabber_new handle, holding options,
extent/mask and flat-array voxel data, mirroring the reference's
FabberRunDataArray role (rundata_array.cc:23-133). Arrays cross the
boundary as raw little-endian bytes in column-major (x-fastest) order
with an int32 mask.

The device is the option `device` (the CLI's --device; default cuda),
set through fabber_set_opt and read when dorun or model_evaluate runs.
A caller that asks for nothing runs on the card; without one the call
fails with resolve_device's error, never on the CPU. Introspection
needs no device.
"""

import numpy as np

from . import runner
from .api import FabberTpu
from .cli import DEVICE_OPTION
from .core.volume import VolumeGeometry, VoxelDataStore
from .easylog import EasyLog
from .exceptions import DataNotFound, FabberError
from .options import RunOptions


class CApiContext:
    def __init__(self):
        self.options = RunOptions()
        self.shape = None
        self.mask = None
        self.data = {}      # name -> [V, size] float arrays
        self.outputs = {}   # name -> [V, size]
        self.geom = None
        self._fab = FabberTpu(device="cpu")   # introspection only

    def _device(self):
        return self.options.get_string(DEVICE_OPTION.name,
                                       DEVICE_OPTION.default)

    # -- configuration ----------------------------------------------------
    def load_models(self, path):
        from .models import load_models_from_file
        load_models_from_file(path)

    def set_extent(self, nx, ny, nz, mask_bytes):
        self.shape = (int(nx), int(ny), int(nz))
        if mask_bytes is not None:
            mask = np.frombuffer(mask_bytes, dtype=np.int32)
            self.mask = mask.reshape(self.shape, order="F") != 0
        else:
            self.mask = None
        self.geom = VolumeGeometry(self.shape, self.mask)

    def set_opt(self, key, value):
        self.options.set(key, value)

    def data_nbytes(self, data_size):
        if self.geom is None:
            raise FabberError("Extent has not been set")
        return int(np.prod(self.shape)) * int(data_size) * 4

    def set_data(self, name, data_size, buf):
        if self.geom is None:
            raise FabberError("Extent has not been set")
        arr = np.frombuffer(buf, dtype=np.float32)
        vol = arr.reshape(self.shape + (int(data_size),), order="F")
        self.data[name] = self.geom.to_voxels(vol)

    # -- introspection ----------------------------------------------------
    def get_models(self):
        return "\n".join(self._fab.get_models())

    def get_methods(self):
        return "\n".join(self._fab.get_methods())

    def get_options(self, key, value):
        kwargs = {}
        if key == "method":
            kwargs["method"] = value
        elif key == "model":
            kwargs["model"] = value
        opts, desc = self._fab.get_options(**kwargs)
        if not kwargs:   # the port's own run option, as the CLI lists it
            opts = opts + [{
                "name": DEVICE_OPTION.name, "type": DEVICE_OPTION.type,
                "description": DEVICE_OPTION.description,
                "optional": True, "default": DEVICE_OPTION.default}]
        lines = [desc]
        for o in opts:
            lines.append("\t".join([
                o["name"], o["description"], o["type"],
                "1" if o["optional"] else "0", o["default"]]))
        return "\n".join(lines)

    def get_model_params(self):
        return "\n".join(self._fab.get_model_params(self.options.copy()))

    def get_model_param_descs(self):
        from .models import get_model_class, resolve_parameters
        opts = self.options.copy()
        model = get_model_class(opts.get_string("model"))(opts)
        lines = []
        for p in resolve_parameters(model, opts):
            line = p.name
            if p.desc:
                line += " " + p.desc
            if p.units:
                line += f" (units: {p.units})"
            lines.append(line)
        return "\n".join(lines)

    def get_model_outputs(self):
        return "\n".join(self._fab.get_model_outputs(self.options.copy()))

    # -- execution --------------------------------------------------------
    def model_evaluate(self, params_bytes, n_ts, indata_bytes, output_name):
        params = np.frombuffer(params_bytes, dtype=np.float32)
        opts = self.options.copy()
        names = self._fab.get_model_params(opts)
        if len(params) != len(names):
            raise FabberError(
                f"Incorrect number of parameters: expected {len(names)} "
                f"({', '.join(names)})")
        values = {n: float(params[i]) for i, n in enumerate(names)}
        indata = None
        if indata_bytes is not None:
            indata = np.frombuffer(indata_bytes, dtype=np.float32)
        out = FabberTpu(device=self._device()).model_evaluate(
            opts, values, int(n_ts), indata, output_name=output_name)
        return np.asarray(out, np.float32).tobytes()

    def dorun(self, progress_cb):
        if self.geom is None:
            raise FabberError("Extent has not been set")
        store = VoxelDataStore(self.geom)
        for name, arr in self.data.items():
            store.set(name, arr)
        cb = None
        if progress_cb is not None:
            cb = lambda vox, total: progress_cb(int(vox), int(total))
        result = runner.run(self.options.copy(), store, log=EasyLog(),
                            progress_cb=cb, device=self._device())
        self.outputs = {}
        for key, arr in result.outputs.items():
            arr = np.asarray(arr, np.float32)
            if arr.ndim == 1:
                arr = arr[:, None]
            self.outputs[key] = arr
        return result.log

    def get_data_size(self, name):
        if name not in self.outputs:
            raise DataNotFound(name)
        return int(self.outputs[name].shape[1])

    def get_data(self, name):
        if name not in self.outputs:
            raise DataNotFound(name)
        arr = self.outputs[name]  # [V, size]
        size = arr.shape[1]
        flat = np.zeros((int(np.prod(self.shape)), size), np.float32)
        flat[self.geom.vox_idx] = arr
        return flat.reshape(-1, order="F").tobytes()
