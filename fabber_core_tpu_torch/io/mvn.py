"""MVN checkpoint serialization, bit-compatible with the reference.

Two formats (reference: dist_mvn.cc):
  * Vectorized per-voxel NIFTI layout (dist_mvn.cc:377-437 save /
    324-375 load): each voxel's column is the lower-triangular
    covariance in row order (1,1),(2,1),(2,2),(3,1)... followed by the
    means and a trailing 1.0, saved with NIFTI_INTENT_SYMMATRIX.
    This is the checkpoint/restart format (--save-mvn /
    --continue-from-mvn) and is interoperable with the C++ mvntool.
  * Single-matrix text format [covariance means; means' 1]
    (dist_mvn.cc:287-310).
"""

import numpy as np

from ..exceptions import FabberError
from . import matfile


def tril_indices_rowmajor(n):
    """(row, col) pairs in the NIFTI_INTENT_SYMMATRIX row-major order."""
    rows, cols = [], []
    for r in range(n):
        for c in range(r + 1):
            rows.append(r)
            cols.append(c)
    return np.array(rows), np.array(cols)


def nparams_from_rows(nrows):
    """Invert nrows = P(P+1)/2 + P + 1 (dist_mvn.cc:341)."""
    p = (int(np.sqrt(8 * nrows + 1)) - 3) // 2
    if p * (p + 1) // 2 + p + 1 != nrows:
        raise FabberError(f"Incorrect number of rows ({nrows}) for an MVN input")
    return p


def pack(means, cov):
    """means [V,P], cov [V,P,P] -> vectorized data [P(P+1)/2+P+1, V]."""
    means = np.asarray(means)
    cov = np.asarray(cov)
    nv, p = means.shape
    r, c = tril_indices_rowmajor(p)
    tri = cov[:, r, c]  # [V, P(P+1)/2]
    ones = np.ones((nv, 1), dtype=means.dtype)
    return np.concatenate([tri, means, ones], axis=1).T


def unpack(voxel_data):
    """Vectorized data [nrows, V] -> (means [V,P], cov [V,P,P])."""
    voxel_data = np.asarray(voxel_data)
    nrows, nv = voxel_data.shape
    p = nparams_from_rows(nrows)
    ntri = p * (p + 1) // 2
    if not np.allclose(voxel_data[-1, :], 1.0):
        raise FabberError("Voxel data does not contain a valid MVN - last value != 1")
    tri = voxel_data[:ntri, :].T  # [V, ntri]
    means = voxel_data[ntri:ntri + p, :].T.copy()
    r, c = tril_indices_rowmajor(p)
    cov = np.zeros((nv, p, p), dtype=voxel_data.dtype)
    cov[:, r, c] = tri
    cov[:, c, r] = tri
    return means, cov


def load_matrix(filename):
    """Text format [cov means; means' 1] -> (means [P], cov [P,P])."""
    mat = matfile.read_matrix_file(filename)
    n = mat.shape[0] - 1
    if n < 1 or mat.shape[0] != mat.shape[1] or not np.allclose(mat, mat.T) \
            or mat[n, n] != 1.0:
        raise FabberError(
            f"{filename}: MVNs must be symmetric matrices "
            "(format = [covariance means(:); means(:) 1.0])")
    means = mat[:n, n].copy()
    cov = mat[:n, :n].copy()
    return means, cov


def save_matrix(means, cov, filename):
    means = np.asarray(means).ravel()
    cov = np.atleast_2d(np.asarray(cov))
    n = means.shape[0]
    mat = np.zeros((n + 1, n + 1))
    mat[:n, :n] = cov
    mat[:n, n] = means
    mat[n, :n] = means
    mat[n, n] = 1.0
    matfile.write_vest(mat, filename)
