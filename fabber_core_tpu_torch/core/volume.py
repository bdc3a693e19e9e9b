"""Volume <-> voxel-list packing and the named voxel-data store.

Equivalent capability to the reference's rundata voxel-data registry
(rundata.h:414-575) and the array I/O backend's mask packing
(rundata_array.cc:44-132): 4-D volumes are flattened x-fastest
(Fortran order), masked voxels are kept in that order, and coordinates
are recovered from the flat index. This ordering matches the
reference exactly, so neighbour graphs and saved NIFTIs line up
voxel-for-voxel.
"""

import numpy as np

from ..exceptions import DataNotFound, FabberError

MASK_THRESHOLD = 1e-16  # rundata_newimage.cc:80 binarises at 1e-16


class VolumeGeometry:
    """Shape + mask; maps between 4-D volumes and [V, T] voxel arrays."""

    def __init__(self, shape, mask=None):
        self.shape = tuple(int(s) for s in shape[:3])
        nx, ny, nz = self.shape
        if mask is None:
            mask = np.ones(self.shape, bool)
        else:
            mask = np.asarray(mask).reshape(self.shape, order="F") > MASK_THRESHOLD
        self.mask = mask
        flat = mask.flatten(order="F")
        self.vox_idx = np.flatnonzero(flat)  # x-fastest order
        self.nvoxels = len(self.vox_idx)

        idx = self.vox_idx
        x = idx % nx
        y = (idx // nx) % ny
        z = idx // (nx * ny)
        self.coords = np.stack([x, y, z], axis=1).astype(np.float64)  # [V,3]

    def to_voxels(self, vol):
        """4-D (or 3-D) volume -> [V, T] voxel-major array."""
        vol = np.asarray(vol)
        if vol.ndim == 3:
            vol = vol[..., None]
        if vol.shape[:3] != self.shape:
            raise FabberError(
                f"Data shape {vol.shape[:3]} does not match extent {self.shape}")
        nt = vol.shape[3]
        flat = vol.reshape(-1, nt, order="F")
        return flat[self.vox_idx]

    def from_voxels(self, arr, fill=0.0):
        """[V, T] or [V] voxel array -> 4-D/3-D volume (unmasked = fill).
        Single-plane products ([V] or [V,1]) come back 3-D, matching
        the reference's saved volumes (e.g. outdata_poly/noise_means
        is 3-D despite being a 1-column matrix internally)."""
        arr = np.asarray(arr)
        squeeze = arr.ndim == 1 or arr.shape[1] == 1
        if arr.ndim == 1:
            arr = arr[:, None]
        nt = arr.shape[1]
        flat = np.full((int(np.prod(self.shape)), nt), fill, dtype=arr.dtype)
        flat[self.vox_idx] = arr
        vol = flat.reshape(self.shape + (nt,), order="F")
        return vol[..., 0] if squeeze else vol


class VoxelDataStore:
    """Named voxel-data registry: key -> [V, T] array.

    Supports key indirection chains (a value may be the name of another
    key, rundata.cc:802-823) and multi-file interleave/concatenate
    (rundata.cc:837-912).
    """

    def __init__(self, geometry):
        self.geom = geometry
        self._data = {}

    def set(self, key, arr):
        """Accepts [V,T], [V], or a full 3-D/4-D volume."""
        arr = np.asarray(arr)
        if arr.ndim >= 3:
            arr = self.geom.to_voxels(arr)
        elif arr.ndim == 1:
            arr = arr[:, None]
        if arr.shape[0] != self.geom.nvoxels:
            raise FabberError(
                f"Voxel data '{key}' has {arr.shape[0]} voxels, "
                f"expected {self.geom.nvoxels}")
        self._data[key] = arr

    def set_alias(self, key, target):
        self._data[key] = target  # string = indirection

    def get(self, key, _seen=None):
        _seen = _seen or set()
        if key in _seen:
            raise DataNotFound(key, "circular data-key reference")
        _seen.add(key)
        if key not in self._data:
            raise DataNotFound(key)
        val = self._data[key]
        if isinstance(val, str):
            return self.get(val, _seen)
        return val

    def have(self, key):
        try:
            self.get(key)
            return True
        except DataNotFound:
            return False

    def keys(self):
        return self._data.keys()

    def get_main_data(self, options):
        """Main timeseries: single 'data' key or multi-file data<n>
        combined by interleave/concatenate."""
        if self.have("data"):
            return self.get("data")
        parts = []
        n = 1
        while self.have(f"data{n}"):
            parts.append(self.get(f"data{n}"))
            n += 1
        if not parts:
            raise DataNotFound("data", "No main voxel data supplied")
        order = options.get_string("data-order", "interleave")
        if order not in ("interleave", "concatenate"):
            raise FabberError(f"data-order must be interleave or concatenate, "
                              f"got '{order}'")
        if len(parts) == 1:
            combined = parts[0]
        elif order == "concatenate":
            combined = np.concatenate(parts, axis=1)
        elif order == "interleave":
            nt = parts[0].shape[1]
            if any(p.shape[1] != nt for p in parts):
                raise FabberError(
                    "Data sets must all have the same number of time points "
                    "for interleaving")
            # first record from each file, then second, etc.
            stacked = np.stack(parts, axis=2)  # [V, T, nfiles]
            combined = stacked.reshape(parts[0].shape[0], -1)
        else:
            raise FabberError(f"data-order must be interleave or concatenate, "
                              f"got '{order}'")
        self._data["data"] = combined
        return combined
