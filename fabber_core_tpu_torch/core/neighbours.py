"""Voxel neighbour graphs for spatial (MRF) priors.

The port's own copy of fabber_core_tpu/core/neighbours.py (numpy only):
the semantics of Vb::CalcNeighbours (inference_vb.cc:769-964) as
precomputed padded index arrays, the form a gather wants:

  neigh_idx  [V, 6]        first-neighbour voxel indices (pad -1)
  neigh2_idx [V, 30]       second neighbours including duplicates for
                           diagonally-connected voxels (pad -1)

Voxels must be sorted by increasing z, then y, then x (the order
VolumeGeometry produces); this is validated like the reference's
coordinate-ordering check. Construction is fully vectorized
(searchsorted over the sorted linear offsets) so million-voxel graphs
build in milliseconds.
"""

import numpy as np

from ..exceptions import FabberError

MAX_NEIGHBOURS = 6
MAX_NEIGHBOURS2 = 30  # 6 first neighbours x up to 5 non-self each


def check_coords_ordered(coords):
    """coords [V,3] must be ordered z-major, then y, then x."""
    if len(coords) < 2:
        return
    diff = np.diff(coords.astype(np.int64), axis=0)
    d = (np.sign(diff[:, 0]) + 10 * np.sign(diff[:, 1])
         + 100 * np.sign(diff[:, 2]))
    if np.any(d <= 0):
        v = int(np.argmax(d <= 0))
        raise FabberError(
            f"Coordinate matrix must be in correct order to use "
            f"adjacency-based priors (voxels {v} and {v + 1} mis-ordered)")


def calc_neighbours(coords, spatial_dims=3):
    """Build first/second neighbour index arrays.

    coords: [V,3] integer x,y,z. Returns (neigh_idx [V,6],
    neigh2_idx [V,30]) with -1 padding.
    """
    coords = np.asarray(coords).astype(np.int64)
    nv = len(coords)
    if nv == 0:
        return (np.zeros((0, MAX_NEIGHBOURS), np.int32),
                np.zeros((0, MAX_NEIGHBOURS2), np.int32))
    check_coords_ordered(coords)

    xsize = int(coords[:, 0].max()) + 1
    ysize = int(coords[:, 1].max()) + 1
    offsets = (coords[:, 2] * xsize * ysize + coords[:, 1] * xsize
               + coords[:, 0])  # sorted ascending by construction

    deltas = np.array([(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                       (0, 0, 1), (0, 0, -1)][:spatial_dims * 2])

    neigh = np.full((nv, MAX_NEIGHBOURS), -1, np.int32)
    slot = np.zeros(nv, np.int64)
    for dx, dy, dz in deltas:
        target = coords + np.array([dx, dy, dz])
        in_grid = ((target[:, 0] >= 0) & (target[:, 0] < xsize)
                   & (target[:, 1] >= 0) & (target[:, 1] < ysize)
                   & (target[:, 2] >= 0))
        toff = (target[:, 2] * xsize * ysize + target[:, 1] * xsize
                + target[:, 0])
        pos = np.searchsorted(offsets, toff)
        pos_c = np.clip(pos, 0, nv - 1)
        found = in_grid & (offsets[pos_c] == toff)
        rows = np.flatnonzero(found)
        neigh[rows, slot[rows]] = pos_c[rows]
        slot[rows] += 1

    # second neighbours: each first-neighbour's neighbours except self,
    # keeping duplicates (Penny 2004 Fig 3 weights arise from them)
    neigh2 = np.full((nv, MAX_NEIGHBOURS2), -1, np.int32)
    safe = np.maximum(neigh, 0)           # [V,6]
    nofn = safe[safe.reshape(-1)].reshape(nv, MAX_NEIGHBOURS,
                                          MAX_NEIGHBOURS)  # [V,6,6]
    valid1 = (neigh >= 0)[:, :, None]
    valid2 = (neigh[safe.reshape(-1)] >= 0).reshape(
        nv, MAX_NEIGHBOURS, MAX_NEIGHBOURS)
    self_idx = np.arange(nv)[:, None, None]
    keep = valid1 & valid2 & (nofn != self_idx)

    # consistency check: every neighbour must list us exactly once
    back = (nofn == self_idx) & valid1 & valid2
    if not np.array_equal(back.sum(axis=2)[neigh >= 0],
                          np.ones(int((neigh >= 0).sum()))):
        raise FabberError("Each of this voxel's neighbours must have this "
                          "voxel as a neighbour")

    flat = nofn.reshape(nv, -1)
    keep_f = keep.reshape(nv, -1)
    # left-pack kept entries per row
    order = np.argsort(~keep_f, axis=1, kind="stable")
    packed = np.take_along_axis(flat, order, axis=1)
    kept_sorted = np.take_along_axis(keep_f, order, axis=1)
    packed[~kept_sorted] = -1
    neigh2[:, :] = packed[:, :MAX_NEIGHBOURS2]
    return neigh, neigh2
