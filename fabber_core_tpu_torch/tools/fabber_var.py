"""fabber_var — extract per-parameter variance maps from a finalMVN.

Port of fabber_core_tpu/tools/fabber_var.py over the port's io.nifti
and io.mvn; capability parity with the reference `fabber_var` shell
script, which drives mvntool once per parameter named in
paramnames.txt.

Usage: python -m fabber_core_tpu_torch.tools.fabber_var <rundir> [outdir]
where <rundir> contains finalMVN.nii.gz and paramnames.txt.
"""

import os
import sys

import numpy as np

from ..io import mvn as mvn_io
from ..io import nifti


def extract_variances(rundir, outdir=None):
    outdir = outdir or rundir
    img = nifti.load(os.path.join(rundir, "finalMVN.nii.gz"))
    with open(os.path.join(rundir, "paramnames.txt")) as f:
        names = [line.strip() for line in f if line.strip()]

    vols = img.data.reshape(-1, img.nt, order="F")
    mask = vols[:, -1] == 1.0
    means, cov = mvn_io.unpack(vols[mask].T.astype(np.float64))

    written = []
    for i, name in enumerate(names):
        var = cov[:, i, i].astype(np.float32)
        flat = np.zeros(vols.shape[0], np.float32)
        flat[mask] = var
        vol = flat.reshape(img.shape[:3], order="F")
        path = os.path.join(outdir, f"var_{name}.nii.gz")
        nifti.save(nifti.NiftiImage(vol, pixdims=img.pixdims,
                                    affine_bytes=img.affine_bytes), path)
        written.append(path)
    return written


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    outdir = argv[1] if len(argv) > 1 else None
    for path in extract_variances(argv[0], outdir):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
