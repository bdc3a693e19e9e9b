"""Unrolled small-matrix algebra over voxel planes (SoA layout).

Port of fabber_core_tpu/ops/smallmat.py. Every entry of the per-voxel
P x P matrix is a separate [V] plane (array shape [P,P,V], voxels on
the last axis); Cholesky, solve and inverse are unrolled in Python
into elementwise torch ops with the same operation order as the JAX
package, so results match it to roundoff at any dtype.
"""

import torch

JITTER = 1e-10  # singular-matrix retry, as dist_mvn.cc:223


def cholesky_planes(a):
    """Lower Cholesky of symmetric [P,P,V] planes. Returns [P,P,V]
    with zeros above the diagonal."""
    p = a.shape[0]
    l = [[None] * p for _ in range(p)]
    for i in range(p):
        s = a[i, i]
        for k in range(i):
            s = s - l[i][k] * l[i][k]
        l[i][i] = torch.sqrt(s)
        inv_lii = 1.0 / l[i][i]
        for j in range(i + 1, p):
            s = a[j, i]
            for k in range(i):
                s = s - l[j][k] * l[i][k]
            l[j][i] = s * inv_lii
    zero = torch.zeros_like(a[0, 0])
    return torch.stack([torch.stack([l[i][j] if j <= i else zero
                                     for j in range(p)])
                        for i in range(p)])


def cholesky_jittered(a):
    """Cholesky with the singular-matrix jitter retry.

    Returns (L, ok): lanes where the plain factorization produced
    non-finite values are refactorized with +1e-10 on the diagonal;
    ok is False where even that failed.
    """
    p = a.shape[0]
    l0 = cholesky_planes(a)
    diag0 = torch.stack([l0[i, i] for i in range(p)])
    bad = torch.any(~torch.isfinite(diag0), dim=0)
    jitter = bad.to(a.dtype) * JITTER
    a2 = a.clone()
    for i in range(p):
        a2[i, i] = a2[i, i] + jitter
    l = cholesky_planes(a2)
    diag = torch.stack([l[i, i] for i in range(p)])
    ok = torch.all(torch.isfinite(diag), dim=0)
    return l, ok


def logdet_from_chol(l):
    """log det A = 2 * sum log diag(L). Returns [V]."""
    s = torch.log(l[0, 0])
    for i in range(1, l.shape[0]):
        s = s + torch.log(l[i, i])
    return 2.0 * s


def solve_chol_vec(l, b):
    """Solve A x = b with A = L L^T; b and x are [P,V] planes."""
    p = l.shape[0]
    y = [None] * p
    for i in range(p):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i, i]
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i, i]
    return torch.stack(x)


def inverse_from_chol(l):
    """A^-1 from the Cholesky factor, as [P,P,V] planes.

    Computes L^-1 by forward substitution then A^-1 = L^-T L^-1,
    unrolled; only the lower triangle is formed and mirrored.
    """
    p = l.shape[0]
    invl = [[None] * p for _ in range(p)]
    for i in range(p):
        invl[i][i] = 1.0 / l[i, i]
    for i in range(p):
        for j in range(i - 1, -1, -1):
            s = 0.0
            for k in range(j + 1, i + 1):
                s = s + l[k][j] * invl[i][k]
            invl[i][j] = -s / l[j, j]
    rows = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            s = 0.0
            for k in range(i, p):
                s = s + invl[k][i] * invl[k][j]
            rows[i][j] = s
            rows[j][i] = s
    return torch.stack([torch.stack(r) for r in rows])


def matvec_planes(a, b):
    """[P,P,V] x [P,V] -> [P,V]."""
    p = a.shape[0]
    return torch.stack([sum(a[i, j] * b[j] for j in range(p))
                        for i in range(p)])


def diag_planes(d):
    """[P,V] -> [P,P,V] diagonal planes."""
    p = d.shape[0]
    zero = torch.zeros_like(d[0])
    return torch.stack([torch.stack([d[i] if i == j else zero
                                     for j in range(p)])
                        for i in range(p)])


def add_diag(a, d):
    """[P,P,V] + diag([P,V]) (returns a new tensor)."""
    a = a.clone()
    for i in range(d.shape[0]):
        a[i, i] = a[i, i] + d[i]
    return a


def diag_of(a):
    """[P,P,V] -> [P,V]."""
    return torch.stack([a[i, i] for i in range(a.shape[0])])
