"""Motion correction: rigid/affine timepoint registration, in plain torch.

Port of fabber_core_tpu/core/motion.py (the reference's MCobj,
motioncorr.cc:25-94). The original 4-D data is re-registered, one
timepoint at a time, to the current model prediction, and VB continues
on the realigned data (inference/vb.py _run_mc_steps). The registration
is a Gauss-Newton loop over a 6-dof rigid (or 12-dof affine) transform
with trilinear resampling, on the engine's device. The JAX module has no
Pallas kernel, so this one has no CUDA kernel either.

Semantics, as the JAX module's:
- each timepoint gets its own transform (motioncorr.cc:88-92);
- the source image is always the original data, so transforms do not
  compound across MC steps;
- the target is the model prediction at the current posterior means;
- 10 Gauss-Newton iterations per level (num_iter, motioncorr.cc:47),
  damping 1e-4, the Jacobian by forward mode (torch.func.jacfwd), the
  cost demeaned on both sides (offset-invariant);
- a pyramid of pool factors (4, 1): a coarse level average-pools both
  volumes and registers over the dense coarse grid, seeding the finer
  one (translations rescaled); a level whose pooled axis would fall
  below 4 cells is skipped (a static rule), and the top level sets the
  capture range (+-2 of its voxels);
- gauge fixing: each transform is composed with the exact inverse of the
  componentwise-median-parameter transform, in float64 on the host
  (np.median, which averages the two middle values where torch.median
  takes the lower), the affine forms made in float32 as the JAX module
  makes them; volumes whose adjusted transform is within IDENTITY_TOL of
  the identity pass through unresampled.

Trilinear sampling is jax.scipy.ndimage.map_coordinates(order=1,
mode="nearest") written out: per axis the lower index floor(x) and its
weight 1 - (x - floor(x)), the upper index floor(x) + 1 with x -
floor(x), each index clipped to the grid, the eight corner products
summed in the same order (not grid_sample, whose normalised coordinates
round differently). Timepoints run one after another, as the JAX
module's lax.map does. The registerer's default dtype is float32, as
the JAX module's.
"""

import itertools

import numpy as np
import torch

# adjusted transforms closer to identity than this (linear-part entries
# and centre displacement, voxels) pass through unresampled
IDENTITY_TOL = 1e-2

# capture range of a single level of the Gauss-Newton registration, in
# that level's voxels; the pyramid's top pool factor multiplies it
# (reg.capture_range). Callers warn at 75% of it.
CAPTURE_RANGE_VOXELS = 2.0


def _rotation(rx, ry, rz):
    """Full (not small-angle) rotation matrix Rz @ Ry @ Rx."""
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rx_m = torch.stack([torch.stack([one, zero, zero]),
                        torch.stack([zero, cx, -sx]),
                        torch.stack([zero, sx, cx])])
    ry_m = torch.stack([torch.stack([cy, zero, sy]),
                        torch.stack([zero, one, zero]),
                        torch.stack([-sy, zero, cy])])
    rz_m = torch.stack([torch.stack([cz, -sz, zero]),
                        torch.stack([sz, cz, zero]),
                        torch.stack([zero, zero, one])])
    return rz_m @ ry_m @ rx_m


def _linear_part(params, dof):
    if dof == 6:
        return _rotation(params[3], params[4], params[5])
    if dof == 12:
        return torch.eye(3, dtype=params.dtype, device=params.device) \
            + params[3:12].reshape(3, 3)
    raise ValueError(f"dof must be 6 or 12, got {dof}")


def _warp_coords(params, coords, centre, dof):
    """Transformed sample coordinates [3,V]: A (x - c) + c + t, params
    [tx,ty,tz,rx,ry,rz] (dof 6) or translations + row-major (A - I)
    entries (dof 12); rotation about the volume centre."""
    t = params[:3][:, None]
    a = _linear_part(params, dof)
    return a @ (coords - centre[:, None]) + centre[:, None] + t


def params_to_affine(params, centre, dof):
    """(A [3,3], b [3]) with S(x) = A x + b equal to the centred
    parameterization A (x - c) + c + t, in params' dtype."""
    a = _linear_part(params, dof)
    c = torch.as_tensor(centre, dtype=params.dtype, device=params.device)
    b = c - a @ c + params[:3]
    return a, b


def _dot32(x, y):
    """x [M,K] @ y [K,N] in float32 as XLA's CPU dot computes it (and so
    the JAX module's float32 affine forms): the K products accumulated
    in order, each by one fused multiply-add (emulated in float64, which
    holds a float32 product exactly)."""
    x64, y64 = x.double(), y.double()
    acc = (x64[:, :1] * y64[:1]).float()
    for k in range(1, x.shape[1]):
        acc = (x64[:, k:k + 1] * y64[k:k + 1] + acc.double()).float()
    return acc


def _affine32(params, centre, dof):
    """params_to_affine at float32 on the host, with the JAX module's
    roundings (its matrix products as _dot32): (A [3,3], b [3]) float64
    numpy."""
    p = torch.as_tensor(params, dtype=torch.float32)
    c = torch.as_tensor(centre, dtype=torch.float32)
    if dof == 6:
        # the angles' cosines and sines correctly rounded to float32
        # (XLA's float32 cos and sin round so but for 7 in 100,000 small
        # arguments, torch's CPU ones for 5 in 1,000)
        p64 = p.double()
        cx, sx = torch.cos(p64[3]).float(), torch.sin(p64[3]).float()
        cy, sy = torch.cos(p64[4]).float(), torch.sin(p64[4]).float()
        cz, sz = torch.cos(p64[5]).float(), torch.sin(p64[5]).float()
        one, zero = torch.ones_like(cx), torch.zeros_like(cx)
        rx_m = torch.stack([torch.stack([one, zero, zero]),
                            torch.stack([zero, cx, -sx]),
                            torch.stack([zero, sx, cx])])
        ry_m = torch.stack([torch.stack([cy, zero, sy]),
                            torch.stack([zero, one, zero]),
                            torch.stack([-sy, zero, cy])])
        rz_m = torch.stack([torch.stack([cz, -sz, zero]),
                            torch.stack([sz, cz, zero]),
                            torch.stack([zero, zero, one])])
        a = _dot32(_dot32(rz_m, ry_m), rx_m)
    else:
        a = _linear_part(p, dof)
    b = (c - _dot32(a, c[:, None])[:, 0]) + p[:3]
    return a.double().numpy(), b.double().numpy()


def map_coordinates_linear(grid, pts):
    """Trilinear samples of grid [nx,ny,nz] at pts [3,V] with edge
    clamping (map_coordinates(order=1, mode="nearest"))."""
    per_axis = []
    for coord, size in zip(pts, grid.shape):
        lower = torch.floor(coord)
        upper_w = coord - lower
        lower_w = 1 - upper_w
        index = lower.to(torch.int64)
        per_axis.append([(torch.clamp(index, 0, size - 1), lower_w),
                         (torch.clamp(index + 1, 0, size - 1), upper_w)])
    out = None
    for items in itertools.product(*per_axis):
        (i0, w0), (i1, w1), (i2, w2) = items
        term = (w0 * w1 * w2) * grid[i0, i1, i2]
        out = term if out is None else out + term
    return out


class _Registerer:
    """A registerer bound to one set of voxel coordinates: the grid
    indices, the volume centre and the pyramid levels are made once and
    kept on the device for every MC step."""

    def __init__(self, coords, shape, dof, n_iters, damping, dtype, device,
                 levels=(4, 1)):
        self.device = torch.device(device)
        self.dtype = dtype
        coords = torch.as_tensor(np.asarray(coords), dtype=dtype)
        if coords.shape[0] != 3:
            coords = coords.t()   # -> [3,V]
        self.coords = coords.contiguous().to(self.device)
        self.idx = tuple(torch.as_tensor(
            np.asarray(coords.cpu(), np.float64).round(),
            dtype=torch.int64, device=self.device))
        self.shape = tuple(int(s) for s in shape)
        self.centre = torch.as_tensor(
            (np.asarray(self.shape, np.float64) - 1) / 2.0, dtype=dtype,
            device=self.device)
        self.dof = int(dof)
        self.n_iters = int(n_iters)
        self.damping = float(damping)
        # pyramid levels usable at this volume size (a pooled axis below
        # 4 cells makes the demeaned cost degenerate); the top level sets
        # the capture range
        used = tuple(f for f in levels if f == 1 or min(self.shape) // f >= 4)
        if used[-1] != 1:
            raise ValueError("pyramid levels must end at full resolution")
        self.levels = used
        self.capture_range = CAPTURE_RANGE_VOXELS * used[0]

    # -- pieces ----------------------------------------------------------
    def _to_grid(self, vals):
        grid = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        grid[self.idx] = vals.to(self.dtype)
        return grid

    def _sample(self, grid, params, coords, centre):
        return map_coordinates_linear(
            grid, _warp_coords(params, coords, centre, self.dof))

    def _pool_grid(self, grid, f):
        """Average-pool the grid by factor f (zero-padded to a multiple;
        the padding dilutes only boundary cells)."""
        ns = [(s + (-s) % f) // f for s in self.shape]
        pad = []
        for s in reversed(self.shape):
            pad += [0, (-s) % f]
        g = torch.nn.functional.pad(grid, pad)
        return g.reshape(ns[0], f, ns[1], f, ns[2], f).mean(dim=(1, 3, 5))

    def _coarse_coords(self, f):
        """Dense sample coordinates [3,N] of the level-f grid."""
        ns = [(s + (-s) % f) // f for s in self.shape]
        gx, gy, gz = np.meshgrid(*[np.arange(n) for n in ns],
                                 indexing="ij")
        return torch.as_tensor(np.stack([gx.ravel(), gy.ravel(),
                                         gz.ravel()]), dtype=self.dtype,
                               device=self.device)

    def _gn_loop(self, params, sample_c, target_c):
        eye = torch.eye(self.dof, dtype=self.dtype, device=self.device)

        def with_value(p):
            s = sample_c(p)
            return s, s
        for _ in range(self.n_iters):
            jac, s = torch.func.jacfwd(with_value, has_aux=True)(params)
            resid = s - target_c                       # [V]
            g = jac.t() @ resid
            h = jac.t() @ jac + self.damping * eye
            params = params - torch.linalg.solve(h, g)
        return params

    def estimate(self, data_t, pred_t):
        """The transform [dof] registering the volume data_t [V] to the
        prediction pred_t [V] (the pyramid, coarse to fine)."""
        grid = self._to_grid(data_t)
        # offset-invariant cost: both volumes demeaned
        pred_c = pred_t.to(self.dtype)
        pred_c = pred_c - torch.mean(pred_c)
        pred_grid = None
        params = torch.zeros(self.dof, dtype=self.dtype, device=self.device)
        prev_f = self.levels[0]
        for f in self.levels:
            # level transition: translations are in the current level's
            # voxels; the linear part is scale-free
            scale = torch.ones_like(params)
            scale[:3] = prev_f / f
            params = params * scale
            prev_f = f
            if f == 1:
                def sample_fine(p):
                    s = self._sample(grid, p, self.coords, self.centre)
                    return s - torch.mean(s)
                params = self._gn_loop(params, sample_fine, pred_c)
                continue
            if pred_grid is None:
                pred_grid = self._to_grid(pred_c)
            gd = self._pool_grid(grid, f)
            gp = self._pool_grid(pred_grid, f)
            target = (gp - torch.mean(gp)).reshape(-1)
            ccoords = self._coarse_coords(f)
            ccentre = self.centre / f

            def sample_coarse(p, gd=gd, cc=ccoords, cn=ccentre):
                s = self._sample(gd, p, cc, cn)
                return s - torch.mean(s)
            params = self._gn_loop(params, sample_coarse, target)
        return params

    def apply_affine(self, data_t, a, b):
        """data_t [V] resampled through x -> a x + b."""
        grid = self._to_grid(data_t)
        pts = a.to(self.dtype) @ self.coords + b.to(self.dtype)[:, None]
        return map_coordinates_linear(grid, pts)

    # -- the registerer's calls ------------------------------------------
    def __call__(self, data_t, pred_t):
        """(data_t [V] resampled through its estimated transform, the
        transform [dof])."""
        data_t = torch.as_tensor(data_t, device=self.device)
        pred_t = torch.as_tensor(pred_t, device=self.device)
        params = self.estimate(data_t, pred_t)
        return (self._sample(self._to_grid(data_t), params, self.coords,
                             self.centre), params)

    def estimate_all(self, data, pred):
        """[T,dof]: one transform per timepoint of data, pred [T,V]."""
        return torch.stack([self.estimate(data[t], pred[t])
                            for t in range(data.shape[0])])

    def apply_all(self, data, a, b):
        """[T,V]: timepoint t resampled through a[t] x + b[t]."""
        return torch.stack([self.apply_affine(data[t], a[t], b[t])
                            for t in range(data.shape[0])])


def make_registerer(coords, shape, dof=6, n_iters=10, damping=1e-4,
                    dtype=torch.float32, device="cpu"):
    """A per-timepoint registerer on `device`.

    coords: [V,3] (or [3,V]) integer voxel coordinates of the masked
    voxels; shape: (nx,ny,nz) grid extent.

    Returns reg with reg(data_t [V], pred_t [V]) -> (realigned_t [V],
    params [dof]): the transform minimising the demeaned SSD between the
    resampled data volume and the prediction, and the data resampled
    through it; reg.estimate_all / reg.apply_all run every timepoint of
    [T,V] planes.
    """
    return _Registerer(coords, shape, dof, n_iters, damping, dtype, device)


def register_timeseries(data, pred, coords, shape, dof=6, n_iters=10,
                        reg=None, device="cpu"):
    """Realign every timepoint of `data` to the model prediction.

    data, pred: [T,V] planes (tensors or arrays). Returns (realigned
    [T,V] tensor on the registerer's device in data's dtype, translations
    [T,3] numpy: the gauge-adjusted displacement of the volume centre per
    timepoint). MCobj::run_mc (motioncorr.cc:70-94): per-timepoint
    transforms estimated from the original data at each call, then
    composed with the exact inverse of the median-parameter transform.
    Pass `reg` (a make_registerer result) to reuse one registerer across
    MC steps.
    """
    if reg is None:
        reg = make_registerer(coords, shape, dof=dof, n_iters=n_iters,
                              device=device)
    data = torch.as_tensor(data).to(reg.device)
    pred = torch.as_tensor(pred).to(reg.device)

    params = reg.estimate_all(data, pred).double().cpu().numpy()  # [T,dof]

    # exact gauge composition: S_adj = S_t o S_med^-1 in affine form, the
    # affine forms in float32 as the JAX module makes them
    centre32 = reg.centre.cpu()
    a_med, b_med = _affine32(np.median(params, axis=0), centre32, dof)
    a_med_inv = np.linalg.inv(a_med)
    a_all, b_all = [], []
    for t in range(params.shape[0]):
        a_t, b_t = _affine32(params[t], centre32, dof)
        a_adj = a_t @ a_med_inv
        a_all.append(a_adj)
        b_all.append(b_t - a_adj @ b_med)
    a_all = np.stack(a_all)                                 # [T,3,3]
    b_all = np.stack(b_all)                                 # [T,3]

    centre = reg.centre.double().cpu().numpy()
    disp = (np.einsum("tij,j->ti", a_all, centre) + b_all
            - centre)                                       # [T,3]
    ident = (np.abs(a_all - np.eye(3)).max(axis=(1, 2)) < IDENTITY_TOL) \
        & (np.abs(disp).max(axis=1) < IDENTITY_TOL)

    resampled = reg.apply_all(
        data, torch.as_tensor(a_all, dtype=torch.float32).to(reg.device),
        torch.as_tensor(b_all, dtype=torch.float32).to(reg.device))
    keep = torch.as_tensor(ident, device=reg.device)[:, None]
    realigned = torch.where(keep, data, resampled.to(data.dtype))
    return realigned, disp
