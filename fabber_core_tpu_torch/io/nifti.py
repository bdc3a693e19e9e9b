"""Minimal pure-numpy NIFTI-1 reader/writer.

The runtime image has no nibabel, and the reference relied on FSL's
newimage (rundata_newimage.cc); this is a dependency-free implementation
of the subset of NIFTI-1 the framework needs: .nii/.nii.gz single-file
volumes, common datatypes, scl_slope/inter scaling, intent codes
(NIFTI_INTENT_SYMMATRIX for MVN checkpoints) and qform/sform
passthrough.
"""

import gzip
import struct

import numpy as np

HDR_SIZE = 348
NIFTI_INTENT_NONE = 0
NIFTI_INTENT_SYMMATRIX = 1005

# NIFTI-1 datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class NiftiImage:
    """A NIFTI volume: data in x,y,z[,t] axis order (x fastest on disk)."""

    def __init__(self, data, pixdims=None, intent=NIFTI_INTENT_NONE,
                 affine_bytes=None):
        self.data = np.asarray(data)
        if self.data.ndim > 4:
            # trailing singleton dims (e.g. dim=5 usage) are squeezed
            self.data = self.data.reshape(self.data.shape[:4])
        self.pixdims = list(pixdims) if pixdims is not None else [1.0] * 4
        while len(self.pixdims) < 4:
            self.pixdims.append(1.0)
        self.intent = intent
        # Raw qform/sform header section preserved on round trip
        self.affine_bytes = affine_bytes

    @property
    def shape(self):
        return self.data.shape

    @property
    def nt(self):
        return self.data.shape[3] if self.data.ndim == 4 else 1


def _open_maybe_gz(filename, mode="rb"):
    if str(filename).endswith(".gz"):
        return gzip.open(filename, mode)
    return open(filename, mode)


def load(filename):
    """Read a .nii/.nii.gz file into a NiftiImage."""
    with _open_maybe_gz(filename) as f:
        raw = f.read()
    if len(raw) < HDR_SIZE:
        raise ValueError(f"{filename}: too short to be a NIFTI-1 file")

    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != HDR_SIZE:
        endian = ">"
        sizeof_hdr = struct.unpack(">i", raw[0:4])[0]
        if sizeof_hdr != HDR_SIZE:
            raise ValueError(f"{filename}: not a NIFTI-1 file (sizeof_hdr={sizeof_hdr})")

    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{filename}: bad NIFTI magic {magic!r}")

    dim = struct.unpack(endian + "8h", raw[40:56])
    intent = struct.unpack(endian + "h", raw[68:70])[0]
    datatype = struct.unpack(endian + "h", raw[70:72])[0]
    pixdim = struct.unpack(endian + "8f", raw[76:108])
    vox_offset = int(struct.unpack(endian + "f", raw[108:112])[0])
    scl_slope, scl_inter = struct.unpack(endian + "2f", raw[112:120])

    if datatype not in _DTYPES:
        raise ValueError(f"{filename}: unsupported NIFTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    ndim = max(1, min(dim[0], 7))
    shape = [max(1, d) for d in dim[1:1 + ndim]]
    # collapse trailing singleton dims beyond 4
    while len(shape) > 4 and shape[-1] == 1:
        shape.pop()
    if len(shape) > 4:
        # dim5+ data (e.g. vector intents): fold into 4th axis
        n4 = int(np.prod(shape[3:]))
        shape = shape[:3] + [n4]

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    data = data.reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float64) * slope + scl_inter

    return NiftiImage(
        data,
        pixdims=list(pixdim[1:5]),
        intent=intent,
        affine_bytes=raw[252:344],
    )


def save(img, filename, dtype=np.float32):
    """Write a NiftiImage to .nii/.nii.gz."""
    data = np.asarray(img.data)
    if data.ndim < 3:
        data = data.reshape(data.shape + (1,) * (3 - data.ndim))
    out = np.asarray(data, dtype=dtype, order="F")

    ndim = out.ndim
    dim = [ndim] + list(out.shape) + [1] * (7 - ndim)
    pixdim = [1.0] + list(img.pixdims[:ndim]) + [1.0] * (7 - ndim)

    hdr = bytearray(HDR_SIZE + 4)  # +4: extension flag bytes
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 68, img.intent)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(dtype)])
    struct.pack_into("<h", hdr, 72, out.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, float(HDR_SIZE + 4))  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    if img.affine_bytes is not None and len(img.affine_bytes) == 92:
        hdr[252:344] = img.affine_bytes
    else:
        # identity sform
        struct.pack_into("<h", hdr, 254, 1)  # sform_code
        struct.pack_into("<4f", hdr, 280, 1, 0, 0, 0)  # srow_x
        struct.pack_into("<4f", hdr, 296, 0, 1, 0, 0)  # srow_y
        struct.pack_into("<4f", hdr, 312, 0, 0, 1, 0)  # srow_z
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + out.tobytes(order="F")
    with _open_maybe_gz(filename, "wb") as f:
        f.write(payload)
