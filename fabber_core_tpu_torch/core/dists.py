"""Distribution helpers over voxel batches: MVN and Gamma.

Port of fabber_core_tpu/core/dists.py. The reference holds one MVNDist
object per voxel with lazy precision<->covariance inversion
(dist_mvn.cc:197-260); here posterior state is arrays (means [V,P],
prec/cov [V,P,P]) and inversion points are explicit. The Gamma moments
(b, c parameterization: mean = b*c, var = b^2*c, dist_gamma.h:15-28) are
pure arithmetic and take tensors and numpy arrays alike.
"""

import numpy as np
import torch

# Jitter used when a matrix fails to invert, matching the reference's
# singular-matrix fallback (dist_mvn.cc:223 adds 1e-10 to the diagonal).
SINGULAR_JITTER = 1e-10


def _cholesky_nan(mat):
    """Batched Cholesky factor with NaN where a matrix is not positive
    definite (as jnp.linalg.cholesky reports it)."""
    chol, info = torch.linalg.cholesky_ex(mat)
    bad = (info != 0) | torch.any(~torch.isfinite(chol), dim=(-2, -1))
    return torch.where(bad[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def chol_inv_logdet(mat):
    """Batched symmetric-PD inverse + log-determinant via Cholesky.

    Returns (inv, logdet, ok) where ok is False for lanes where even the
    jittered factorization failed (non-PD matrix -> bad voxel; inv and
    logdet NaN there).
    """
    mat = torch.as_tensor(mat)
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    chol = _cholesky_nan(mat)
    bad = torch.any(~torch.isfinite(chol), dim=(-2, -1))
    # retry with diagonal jitter on the failed lanes only
    jitter = bad.to(mat.dtype) * SINGULAR_JITTER
    chol = _cholesky_nan(mat + jitter[..., None, None] * eye)
    ok = torch.all(torch.isfinite(chol), dim=(-2, -1))
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    # the inverse from two triangular solves: L^-T L^-1
    linv = torch.linalg.solve_triangular(chol, eye.expand_as(mat),
                                         upper=False)
    inv = torch.einsum("...ki,...kj->...ij", linv, linv)
    inv = 0.5 * (inv + inv.transpose(-1, -2))   # exactly symmetric
    return inv, logdet, ok


def sym_inv(mat):
    """Batched symmetric inverse with jitter fallback (no logdet)."""
    inv, _, _ = chol_inv_logdet(mat)
    return inv


def sym_logdet(mat):
    _, logdet, _ = chol_inv_logdet(mat)
    return logdet


# -- Gamma distribution (b, c) parameterization --------------------------

def gamma_mean(b, c):
    return b * c


def gamma_var(b, c):
    return b * b * c


def gamma_from_mean_var(mean, var):
    """Inverse of (mean, var) -> (b, c): b = var/mean, c = mean^2/var."""
    b = var / mean
    c = mean * mean / var
    return b, c


# -- concatenated MVN (model params (+) noise params) ---------------------

def concat_mvn(means1, cov1, means2, cov2):
    """Block-diagonal MVN concat (dist_mvn.cc:57-100 semantics):
    ([V,P1], [V,P1,P1]) and ([V,P2], [V,P2,P2]) -> ([V,P1+P2],
    [V,P1+P2,P1+P2]) tensors."""
    means1, cov1 = torch.as_tensor(means1), torch.as_tensor(cov1)
    means2, cov2 = torch.as_tensor(means2), torch.as_tensor(cov2)
    v = means1.shape[0]
    p1, p2 = means1.shape[1], means2.shape[1]
    means = torch.cat([means1, means2], dim=1)
    cov = torch.zeros((v, p1 + p2, p1 + p2), dtype=cov1.dtype,
                      device=cov1.device)
    cov[:, :p1, :p1] = cov1
    cov[:, p1:, p1:] = cov2
    return means, cov


def split_mvn(means, cov, p1):
    """Split a concatenated MVN back into (model, noise) blocks."""
    return (means[:, :p1], cov[:, :p1, :p1]), (means[:, p1:], cov[:, p1:, p1:])


def diag_mvn(means, variances):
    """Build [V,P,P] covariance (numpy) from diagonal variances [V,P]."""
    means = np.asarray(means)
    variances = np.asarray(variances)
    v, p = means.shape
    cov = np.zeros((v, p, p), dtype=variances.dtype)
    idx = np.arange(p)
    cov[:, idx, idx] = variances
    return cov
