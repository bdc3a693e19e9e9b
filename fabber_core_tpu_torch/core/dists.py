"""Gamma distribution helpers over voxel planes.

Port of the Gamma part of fabber_core_tpu/core/dists.py, in the
(b, c) parameterization: mean = b*c, var = b^2*c (dist_gamma.h:15-28).
Works on tensors and numpy arrays alike (pure arithmetic).
"""

def gamma_mean(b, c):
    return b * c


def gamma_var(b, c):
    return b * b * c


def gamma_from_mean_var(mean, var):
    """Inverse of (mean, var) -> (b, c): b = var/mean, c = mean^2/var."""
    b = var / mean
    c = mean * mean / var
    return b, c
