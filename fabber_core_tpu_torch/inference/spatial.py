"""Spatial VB: MRF / Penny priors coupling voxels over the 6-neighbour
graph (method=spatialvb, or any spatial prior type M/m/P/p).

Port of fabber_core_tpu/inference/spatial.py (inference_vb.cc:578-767,
priors.cc:183-488): each sweep updates one global spatial precision aK
per spatial parameter from a whole-volume reduction (Penny 2005 Fig 4),
builds each voxel's prior for those parameters from its neighbours'
posterior means, then runs the theta and noise updates of every voxel,
its free energy, and the excision of voxels that went non-finite (they
revert to their pre-sweep state and leave the neighbour graph, through
`active`, for every later sweep).

The JAX package runs the spatial path in XLA with no Pallas kernel, so
this port is plain torch on whichever device the engine has; the theta
and noise updates are the noise model's, from the sufficient statistics
on a fixed design ('xla' arithmetic) or from a linearization (the
generic route, or the design as the Jacobian under
fixed-design-route=direct). Sweep modes:

  jacobi        (default) every voxel's spatial prior reads the previous
                sweep's means: one parallel sweep; the neighbour sums
                run as a dense stencil on the voxel grid (shifted adds)
                or as a gather over padded neighbour index arrays
                (spatial-stencil), each in the JAX package's summation
                order;
  gauss-seidel  the reference's in-place voxel order: voxel v reads the
                already-updated means of voxels < v. A Python loop of
                torch ops over the voxels: a parity mode for small
                volumes, not a production path;
  blocked       (spatial-block-voxels=N, Jacobi) the data plane stays on
                the host; each sweep ships N-voxel blocks to the device,
                with the neighbour sums and aK computed on the host
                between sweeps (the same Jacobi results).

Not ported: the JAX package's grid-carried P=1 fast sweep
(_compiled_sweeps_dense_p1), a fix for the TPU's tile layout of [1,V]
planes; bench.py's `spatial` configuration (P=1) runs the general sweep
here. spatial-prior-output-correction adds the likelihood-only
posterior after the sweeps (compute_noprior, a blocked run's data
shipped block by block). Still raising: sharded or distributed runs
(ROADMAP Queue 1 item 18).
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.neighbours import calc_neighbours, check_coords_ordered
from ..exceptions import FabberError, InvalidOptionValue
from ..models.base import (PRIOR_SPATIAL_M, PRIOR_SPATIAL_m,
                           PRIOR_SPATIAL_P, PRIOR_SPATIAL_p)
from ..ops import smallmat as sm
from ..options import OptionSpec, OPT_INT, OPT_STR, OPT_BOOL, OPT_FLOAT
from .vb import (ENGINE_KERNELS, PosteriorState, VBInference, VBLoopState,
                 _lane_where)

AK_INIT = 1e-8
AK_FLOOR = 1e-50
MRF_JITTER = 1e-8  # invertibility term for type M (priors.cc:259,408)
# types whose priors read second neighbours (Penny)
_PENNY = (PRIOR_SPATIAL_P, PRIOR_SPATIAL_p)


class SpatialState(NamedTuple):
    post: PosteriorState
    centre: Any   # [P,V]
    f: Any        # [V]
    ak: Any       # [n_spatial_params]
    bad: Any      # [V] bool, excised voxels


class Planes(NamedTuple):
    """The voxel planes a sweep reads, for the whole volume or one
    block, on the engine's device."""
    data: Any        # [T,V] compute dtype (None: a block on the stats route)
    coords: Any      # [3,V]
    supp: Any        # [S,V] or None
    base_means: Any  # [P,V] or [P,1]
    locked: Any      # [P,V] locked linearization centres, or None


def _tree(fn, *trees):
    """fn over the tensors of NamedTuples of tensors, leaf by leaf."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_tree(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _gather_sum(values, idx, active):
    """Sums of values over a padded neighbour index array, counting
    only valid, active entries: (sums [V], counts [V])."""
    valid = idx >= 0
    safe = idx.clamp(min=0)
    w = (valid & active[safe]).to(values.dtype)
    return torch.sum(values[safe] * w, dim=1), torch.sum(w, dim=1)


class SpatialVBInference(VBInference):
    """method=spatialvb (also reached through spatial prior types)."""

    @classmethod
    def get_options(cls):
        return VBInference.get_options() + [
            OptionSpec("spatial-dims", OPT_INT, "Number of spatial dimensions",
                       default="3"),
            OptionSpec("spatial-speed", OPT_STR,
                       "Restrict speed of spatial smoothing", default="-1"),
            OptionSpec("param-spatial-priors", OPT_STR,
                       "Type of spatial priors per parameter: N=nonspatial, "
                       "M=Markov random field, P=Penny, A=ARD", default="N+"),
            OptionSpec("update-spatial-prior-on-first-iteration", OPT_BOOL,
                       "Update the spatial prior (aK) on iteration 0"),
            OptionSpec("spatial-q1", OPT_FLOAT,
                       "Prior Gamma scale for aK", default="10.0"),
            OptionSpec("spatial-q2", OPT_FLOAT,
                       "Prior Gamma shape for aK", default="1.0"),
            OptionSpec("spatial-sweep-mode", OPT_STR,
                       "jacobi (parallel) or gauss-seidel (the reference's "
                       "sequential in-place voxel order; a parity mode for "
                       "small volumes)", default="jacobi"),
            OptionSpec("spatial-stencil", OPT_STR,
                       "Neighbour-sum implementation: auto, dense "
                       "(voxels on the 3-D grid + shifted adds) or gather "
                       "(padded index arrays)", default="auto"),
            OptionSpec("spatial-block-voxels", OPT_INT,
                       "Beyond-device-memory escape: keep the data on the "
                       "host and stream the volume through the device in "
                       "voxel blocks of this size each sweep (the neighbour "
                       "sums and the aK reduction run on the host between "
                       "sweeps; the Jacobi results are unchanged). 0 = "
                       "whole volume on the device", default="0"),
            OptionSpec("spatial-mem-gb", OPT_FLOAT,
                       "Device memory budget for the capacity pre-check, "
                       "GB (0 = the card's memory on cuda, unchecked on "
                       "cpu)", default="0"),
            OptionSpec("spatial-fchange", OPT_FLOAT,
                       "Stop sweeping early once the absolute change of the "
                       "global free energy (sum of F over non-excised "
                       "voxels) between sweeps drops below this. 0 = the "
                       "reference's blind max-iterations count",
                       default="0"),
        ]

    def __init__(self, model, options, data, voxel_data_getter=None,
                 data_plane=None, device="cuda", coords=None,
                 continued=False, suppdata=None):
        """As VBInference; coords [V,3] (the voxels' integer grid
        positions, z-major then y then x) are required: they define the
        neighbour graph. Blocked sweeps (spatial-block-voxels > 0) keep
        the data plane on the host and take `data`, not a device
        data_plane."""
        if coords is None:
            raise ValueError("spatial VB needs the voxels' coords [V,3]")
        blocked = options.get_int("spatial-block-voxels", 0, minval=0)
        if blocked > 0 and data_plane is not None:
            raise InvalidOptionValue(
                "spatial-block-voxels", str(blocked),
                "Blocked sweeps keep the data plane on the host; pass the "
                "data, not a device data_plane")
        super().__init__(model, options, data, voxel_data_getter,
                         data_plane=data_plane, device=device, coords=coords,
                         continued=continued, suppdata=suppdata,
                         data_device="cpu" if blocked > 0 else None)
        self.block_voxels = blocked
        if blocked > 0 and self.device.type == "cuda":
            self.data = self.data.pin_memory()
        self.mem_gb = options.get_float("spatial-mem-gb", 0.0)
        # per-iteration F history is a voxelwise-mode output
        self.save_fhist = False
        self.use_stats = self.design is not None and options.get_string(
            "fixed-design-route", "stats") == "stats"
        self.spatial_dims = options.get_int("spatial-dims", 3, 0, 3)
        self.spatial_speed = options.get_float("spatial-speed", -1.0)
        self.update_first_iter = options.get_bool(
            "update-spatial-prior-on-first-iteration")
        self.q1 = options.get_float("spatial-q1", 10.0)
        self.q2 = options.get_float("spatial-q2", 1.0)
        self.max_its = options.get_int("max-iterations", 10, minval=1)
        # the reference hardcodes a counting detector on Fglobal for the
        # spatial loop (inference_vb.cc:599-602)
        conv_name = options.get_string("convergence", "maxits")
        if conv_name != "maxits":
            raise InvalidOptionValue(
                "convergence", conv_name,
                "Spatial VB supports only the maxits detector (the "
                "reference hardcodes a counting detector for the spatial "
                "loop); for an Fglobal-based early stop use "
                "--spatial-fchange")
        self.f_stop_tol = options.get_float("spatial-fchange", 0.0)
        if self.f_stop_tol > 0:
            self.need_f = True   # the early stop tests the sum of F
        # the voxel count in the aK shape term hK (priors.cc:302)
        self.ak_nvoxels = self.nvoxels
        self.sweep_mode = options.get_string("spatial-sweep-mode", "jacobi")
        if self.sweep_mode not in ("jacobi", "gauss-seidel"):
            raise InvalidOptionValue("spatial-sweep-mode", self.sweep_mode,
                                     "Must be jacobi or gauss-seidel")
        if blocked > 0 and self.sweep_mode != "jacobi":
            raise InvalidOptionValue(
                "spatial-block-voxels", str(blocked),
                "Blocked sweeps are only exact for the jacobi sweep mode "
                "(gauss-seidel needs the sequential full volume)")

        # all-N priors are legal (the reference's golden
        # outdata_linear_spatialvb run): sweeps with no coupling
        self.spatial_params = [
            (i, p.prior_type) for i, p in enumerate(self.params)
            if p.prior_type in (PRIOR_SPATIAL_M, PRIOR_SPATIAL_m,
                                PRIOR_SPATIAL_P, PRIOR_SPATIAL_p)]
        ci = np.asarray(coords).astype(np.int64)
        check_coords_ordered(ci)
        self._coords_int = ci
        # the padded neighbour index arrays, built when a gather first
        # needs them (the dense stencil never does)
        self._neigh_host = self._neigh_dev = None

        # dense-stencil neighbour sums: voxels onto the 3-D grid, sum the
        # 2*spatial_dims shifted copies, back to voxels
        stencil_mode = options.get_string("spatial-stencil", "auto")
        self._dense = None
        if stencil_mode != "gather":
            xs, ys, zs = (int(ci[:, 0].max()) + 1, int(ci[:, 1].max()) + 1,
                          int(ci[:, 2].max()) + 1)
            dsize = xs * ys * zs
            if stencil_mode == "dense" or dsize <= 4 * self.nvoxels:
                off = ci[:, 2] * xs * ys + ci[:, 1] * xs + ci[:, 0]
                if dsize == self.nvoxels and np.array_equal(
                        off, np.arange(self.nvoxels)):
                    inv = None   # a full grid in voxel order: reshapes
                else:
                    inv_np = np.zeros(dsize, np.int64)
                    occ = np.zeros(dsize, bool)
                    inv_np[off] = np.arange(self.nvoxels)
                    occ[off] = True
                    inv = (torch.as_tensor(inv_np, device=self.device),
                           torch.as_tensor(occ, device=self.device))
                self._dense = (xs, ys, zs,
                               torch.as_tensor(off, device=self.device), inv)

    def _select_route(self):
        """Spatial runs take the spatial sweep (motion correction is
        refused as the JAX package refuses it, spatial.py:140-145; the
        likelihood-only output is computed after it, _finish)."""
        mode = self.options.get_string("engine-kernel", "auto")
        if mode not in ENGINE_KERNELS:
            raise InvalidOptionValue("engine-kernel", mode,
                                     "Unknown engine route")
        if self.options.get_int("mcsteps", 0) > 0:
            raise InvalidOptionValue(
                "mcsteps", self.options.get_string("mcsteps"),
                "Motion correction is implemented for method=vb only")
        return "spatial"

    def route_description(self):
        """The sweep and stencil selection, logged by the runner."""
        stencil = ("dense-stencil neighbour sums" if self._dense is not None
                   else "gather neighbour sums")
        blocked = (f", blocked streaming sweeps ({self.block_voxels} "
                   "voxels/block)" if self.block_voxels > 0 else "")
        stats = " + fixed-design stats" if self.use_stats else ""
        return f"spatial {self.sweep_mode} sweeps, {stencil}{stats}{blocked}"

    # -- neighbour sums and aK ---------------------------------------------
    def _neigh_planes(self, device=None):
        """The [V,6] / [V,30] neighbour index arrays (int32, -1 padded)
        on the engine's device, or on the host (device="cpu")."""
        if self._neigh_host is None:
            self._neigh_host = tuple(
                torch.from_numpy(x) for x in calc_neighbours(
                    self._coords_int, self.spatial_dims))
        if device is not None:
            return self._neigh_host
        if self._neigh_dev is None:
            self._neigh_dev = tuple(x.to(self.device)
                                    for x in self._neigh_host)
        return self._neigh_dev

    def _stencil_sum(self, dense):
        """Sum of the 2*spatial_dims unit-shifted copies of a dense
        [Z,Y,X] field, zero-filled at the grid boundary (x, then y,
        then z, each as forward + backward)."""
        out = None
        for ax in (2, 1, 0)[:self.spatial_dims]:
            n = dense.shape[ax]
            zeros = torch.zeros_like(dense.narrow(ax, 0, 1))
            fwd = torch.cat([dense.narrow(ax, 1, n - 1), zeros], dim=ax)
            bwd = torch.cat([zeros, dense.narrow(ax, 0, n - 1)], dim=ax)
            s = fwd + bwd
            out = s if out is None else out + s
        return torch.zeros_like(dense) if out is None else out

    def _gather_sums(self, means, active, neigh, neigh2):
        """Per spatial parameter (nsum, nn, nsum2, nn2) by gathers;
        the second-neighbour pair only for the Penny types, else None."""
        out = []
        for k, tcode in self.spatial_params:
            nsum, nn = _gather_sum(means[k], neigh, active)
            if tcode in _PENNY:
                out.append((nsum, nn) + _gather_sum(means[k], neigh2, active))
            else:
                out.append((nsum, nn, None, None))
        return out

    def _neighbour_sums(self, means, active):
        """Per spatial parameter: (nsum [V], nn [V], nsum2, nn2), the
        neighbour sums of the posterior means [P,V] and the neighbour
        counts over active voxels, with the second-neighbour versions
        (duplicates kept, self excluded) for the Penny types (else
        None). Shared by the aK update and the priors, which read the
        same pre-sweep means."""
        if self._dense is None:
            return self._gather_sums(means, active, *self._neigh_planes())
        xs, ys, zs, off, inv = self._dense
        actf = active.to(means.dtype)
        if inv is None:
            def to_dense(vals):
                return vals.reshape(zs, ys, xs)

            def extract(d):
                return d.reshape(-1)
        else:
            inv_idx, occ = inv

            def to_dense(vals):
                return torch.where(occ, vals[inv_idx],
                                   0.0).reshape(zs, ys, xs)

            def extract(d):
                return d.reshape(-1)[off]
        md = to_dense(actf)
        s_m = self._stencil_sum(md)
        nn = extract(s_m)
        nn2 = None
        out = []
        for k, tcode in self.spatial_params:
            w = means[k]
            s_w = self._stencil_sum(to_dense(w * actf))
            nsum = extract(s_w)
            if tcode in _PENNY:
                # neighbours-of-neighbours with duplicates = S[m S[.]],
                # minus the self terms (each of the nn neighbours lists
                # the voxel once)
                nsum2 = extract(self._stencil_sum(md * s_w)) - w * nn
                if nn2 is None:
                    nn2 = extract(self._stencil_sum(md * s_m)) - nn
                out.append((nsum, nn, nsum2, nn2))
            else:
                out.append((nsum, nn, None, None))
        return out

    def _calculate_ak(self, means, var, active, nsums):
        """Penny 2005 Fig 4 update of each spatial parameter's global
        precision (priors.cc:221-344) from the means [P,V], the
        posterior variances [P,V] and the neighbour sums, accumulated in
        the dtype of `means` (float64 for the blocked host twin)."""
        sd = self.spatial_dims
        actf = active.to(means.dtype)
        aks = []
        for slot, (k, tcode) in enumerate(self.spatial_params):
            sigma_k, w_k = var[k], means[k]
            nsum, nn = (x.to(means.dtype) for x in nsums[slot][:2])
            if tcode == PRIOR_SPATIAL_m:
                trace_w = torch.full_like(sigma_k, sd * 2)
            elif tcode == PRIOR_SPATIAL_M:
                trace_w = nn + MRF_JITTER
            elif tcode == PRIOR_SPATIAL_p:
                trace_w = torch.full_like(sigma_k, 4 * sd * sd + 2 * sd)
            else:  # P
                trace_w = nn * nn + nn
            trace_term = torch.sum(sigma_k * trace_w * actf)
            swk = nn * w_k - nsum
            if tcode in (PRIOR_SPATIAL_p, PRIOR_SPATIAL_m):
                # no boundary correction: missing neighbours act as 0
                swk = swk + w_k * (sd * 2 - nn)
            if tcode in (PRIOR_SPATIAL_m, PRIOR_SPATIAL_M):
                term2 = torch.sum(swk * w_k * actf)
            else:
                term2 = torch.sum(swk * swk * actf)
            gk = 1.0 / (0.5 * trace_term + 0.5 * term2 + 1.0 / self.q1)
            hk = self.ak_nvoxels * 0.5 + self.q2
            ak = torch.clamp(gk * hk, min=AK_FLOOR)
            if self.spatial_speed > 0:
                ak = torch.minimum(
                    ak, torch.clamp(ak * self.spatial_speed, min=0.5))
            aks.append(ak)
        return torch.stack(aks)

    def _prior_from_sums(self, k, tcode, akk, contrib_nn, nn, nsum2, nn2):
        """Spatial prior (mean, precision) of parameter k from its
        neighbour sums (priors.cc:346-488), elementwise: [V] planes in
        the Jacobi sweep, one voxel's sums in the Gauss-Seidel one."""
        sd = self.spatial_dims
        if tcode in (PRIOR_SPATIAL_M, PRIOR_SPATIAL_m):
            # M/m never read second neighbours
            nsum2 = nn2 = torch.zeros_like(nn)
        contrib_nn2 = -nsum2
        if tcode in (PRIOR_SPATIAL_p, PRIOR_SPATIAL_m):
            nn = torch.full_like(nn, 2 * sd)
            nn2 = torch.full_like(nn2, 4 * sd * sd - 2 * sd)
        base_mean = self.params[k].prior.mean
        base_prec = self.params[k].prior.prec
        if tcode == PRIOR_SPATIAL_M:
            spatial_prec = akk * (nn + MRF_JITTER)
        elif tcode == PRIOR_SPATIAL_m:
            spatial_prec = akk * nn
        else:  # P/p
            spatial_prec = akk * (nn * nn + nn)
        if tcode in (PRIOR_SPATIAL_p, PRIOR_SPATIAL_m):
            new_prec = spatial_prec
        else:
            new_prec = base_prec + spatial_prec
        if tcode in (PRIOR_SPATIAL_m, PRIOR_SPATIAL_M):
            spatial_mean = contrib_nn * (1.0 / torch.clamp(nn, min=1e-30))
            new_mean = (1.0 / new_prec) * spatial_prec * spatial_mean
        else:
            denom = 8.0 * nn - nn2
            spatial_mean = torch.where(
                nn != 0,
                (8.0 * contrib_nn + contrib_nn2)
                / torch.where(denom != 0, denom, 1.0),
                0.0)
            new_mean = (1.0 / new_prec) * (
                spatial_prec * spatial_mean + base_prec * base_mean)
        return new_mean, new_prec

    def _apply_spatial_priors(self, prior_means, prior_prec, ak, nsums):
        """The spatial parameters' rows of the prior planes, from the
        neighbour sums."""
        rows_m, rows_p = list(prior_means), list(prior_prec)
        for slot, (k, tcode) in enumerate(self.spatial_params):
            rows_m[k], rows_p[k] = self._prior_from_sums(
                k, tcode, ak[slot], *nsums[slot])
        return torch.stack(rows_m), torch.stack(rows_p)

    # -- the sweep -----------------------------------------------------------
    def _phase_a_gs(self, s, planes, stats, prior_means, prior_prec, active,
                    ak, lin):
        """The prior and theta updates in the reference's voxel order
        (inference_vb.cc:614-672): voxel v's spatial prior reads the
        already-updated means of voxels < v. A Python loop of torch ops
        over the voxels, O(V) sequential steps: a parity mode for small
        volumes, not a production path. Excised voxels keep their
        state."""
        post = s.post
        means, prec, cov = (x.clone() for x in (post.means, post.prec,
                                                 post.cov))
        shape = post.means.shape
        pm = prior_means.expand(shape).clone()
        pp = prior_prec.expand(shape).clone()
        neigh, neigh2 = self._neigh_planes()
        dkw = self._design_kw()

        def gather(idx, means_k):
            valid = idx >= 0
            safe = idx.clamp(min=0)
            w = (valid & active[safe]).to(self.dtype)
            return torch.sum(means_k[safe] * w), torch.sum(w)

        for v in range(self.nvoxels):
            col = slice(v, v + 1)
            pm_v, pp_v = pm[:, col].clone(), pp[:, col].clone()
            for slot, (k, tcode) in enumerate(self.spatial_params):
                sums = gather(neigh[v], means[k])
                sums2 = gather(neigh2[v], means[k]) if tcode in _PENNY \
                    else (None, None)
                nm, npv = self._prior_from_sums(k, tcode, ak[slot], *sums,
                                                *sums2)
                pm_v[k], pp_v[k] = nm, npv
            noise_v = _tree(lambda x: x[..., col], post.noise)
            if stats is not None:
                m_v, prec_v, cov_v, _ = self.noise.update_theta_stats(
                    noise_v, pm_v, pp_v,
                    self.noise.design_stats_voxel(stats, v))
            else:
                offset_c, jac_c = lin
                m_v, prec_v, cov_v, _ = self.noise.update_theta(
                    noise_v, means[:, col], pm_v, pp_v, s.centre[:, col],
                    offset_c[:, col],
                    None if jac_c is None else jac_c[..., col],
                    planes.data[:, col], None, **dkw)
            upd = active[col]
            for full, new in ((means, m_v), (prec, prec_v), (cov, cov_v),
                              (pm, pm_v), (pp, pp_v)):
                full[..., col] = torch.where(upd, new, full[..., col])
        return means, prec, cov, pm, pp

    def _sweep(self, it, s, planes, stats, skip_f=False):
        """One Jacobi (or Gauss-Seidel) sweep: aK from the pre-sweep
        state (from sweep 1 on, or 0 with
        update-spatial-prior-on-first-iteration), then _sweep_core."""
        active = ~s.bad
        nsums, ak = [], s.ak
        if self.spatial_params:
            nsums = self._neighbour_sums(s.post.means, active)
            if it > 0 or self.update_first_iter:
                ak = self._calculate_ak(s.post.means, sm.diag_of(s.post.cov),
                                        active, nsums)
        return self._sweep_core(it, s, planes, stats, nsums, ak, active,
                                skip_f)

    def _sweep_core(self, it, s, planes, stats, nsums, ak, active,
                    skip_f=False):
        """A sweep after its cross-voxel reductions (the neighbour sums
        and aK): the priors, the theta and noise updates, F, and the
        excision of newly failed voxels. Shared by the whole-volume
        sweep and the blocked one (host-made nsums and aK per block)."""
        post = s.post
        data = planes.data
        dkw = self._design_kw()
        if stats is None:
            offset_c, jac_c = self._linearize(s.centre, data, planes.coords,
                                              planes.supp, planes.locked)
        # the non-spatial family first (voxel-local, pre-sweep state),
        # then the spatial priors
        prior_means, prior_prec, f_contribs = self.prior_setup.apply(
            post.prior_means, post.prior_prec, post.means,
            sm.diag_of(post.cov), it, base_means=planes.base_means)
        # spatial mode sums the priors' F terms (inference_vb.cc:630)
        fprior = torch.sum(f_contribs, dim=0)

        if self.sweep_mode == "gauss-seidel":
            means, prec, cov, prior_means, prior_prec = self._phase_a_gs(
                s, planes, stats, prior_means, prior_prec, active, ak,
                None if stats is not None else (offset_c, jac_c))
        else:
            prior_means, prior_prec = self._apply_spatial_priors(
                prior_means, prior_prec, ak, nsums)
            if stats is not None:
                means, prec, cov, _ = self.noise.update_theta_stats(
                    post.noise, prior_means, prior_prec, stats)
            else:
                means, prec, cov, _ = self.noise.update_theta(
                    post.noise, post.means, prior_means, prior_prec,
                    s.centre, offset_c, jac_c, data, None, **dkw)
        if stats is not None:
            noise_post = self.noise.update_noise_stats(
                post.noise, self.noise_prior, means, cov, stats)
        else:
            noise_post = self.noise.update_noise(
                post.noise, self.noise_prior, means, cov, s.centre,
                offset_c, jac_c, data, **dkw)

        new_post = PosteriorState(means, prec, cov, prior_means, prior_prec,
                                  noise_post)
        if not self.need_f or skip_f:
            f = s.f
        elif stats is not None:
            f = self.noise.free_energy_stats(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, stats) + fprior
        else:
            offset, jac = self._linearize(means, data, planes.coords,
                                          planes.supp, planes.locked)
            f = self.noise.free_energy(
                noise_post, self.noise_prior, means, prec, cov,
                prior_means, prior_prec, means, offset, jac, data,
                **dkw) + fprior

        # newly failed voxels revert to their pre-sweep state and leave
        # the graph for every later sweep: one select keeps the new
        # state where the lane is neither frozen nor newly bad
        finite = (torch.isfinite(means).all(dim=0)
                  & torch.isfinite(cov).all(dim=0).all(dim=0))
        bad = s.bad | ~finite
        new = SpatialState(post=new_post, centre=means, f=f, ak=None,
                           bad=None)
        merged = _lane_where(~bad, new, s._replace(ak=None, bad=None))
        return merged._replace(ak=ak, bad=bad)

    # -- the capacity pre-check -----------------------------------------------
    def _device_mem_budget(self):
        """Bytes the unblocked run may use: spatial-mem-gb, else the
        card's memory on cuda; None (unchecked) on the CPU."""
        if self.mem_gb > 0:
            return self.mem_gb * 1e9
        if self.device.type == "cuda":
            return float(torch.cuda.get_device_properties(
                self.device).total_memory)
        return None

    def _estimate_device_bytes(self):
        """Rough (within ~2x) peak device bytes of the unblocked run:
        the [T,V] data plane, the sweep state twice over, the route's
        temporaries and the dense stencil grids."""
        item_s = self.data.element_size()
        item = torch.finfo(self.dtype).bits // 8
        p, t, v = self.nparams, self.nt, self.nvoxels
        state_planes = 3 * p * p + 6 * p + 8
        per_vox = t * item_s + 2 * state_planes * item
        if self.use_stats:
            per_vox += 3 * t * item   # the one-time statistics
        else:
            per_vox += t * (6 if self.design is not None
                            else 8 * (p + 1)) * item
        total = per_vox * v
        if self._dense is not None:
            xs, ys, zs = self._dense[:3]
            total += (2 + 2 * len(self.spatial_params)) * xs * ys * zs * item
        return total

    def _capacity_check(self):
        budget = self._device_mem_budget()
        if budget is None:
            return
        est = self._estimate_device_bytes()
        if est > budget:
            raise FabberError(
                f"Spatial VB needs ~{est / 1e9:.2f} GB of device memory "
                f"for {self.nvoxels} voxels x {self.nt} timepoints but "
                f"the budget is {budget / 1e9:.2f} GB (spatial VB holds "
                "the whole neighbour graph on the device). Escapes: "
                "--spatial-block-voxels=N streams the volume through the "
                "device in N-voxel blocks (the same Jacobi results); "
                "--dtype=bf16 halves the data plane; sharding the voxels "
                "over several cards (--distributed) is not ported yet "
                "(ROADMAP Queue 1 item 18). If the budget is wrong, set "
                "--spatial-mem-gb.")

    # -- runs -----------------------------------------------------------------
    def _planes(self, lo=0, hi=None):
        """The sweep's planes of voxels lo:hi (default all) on the
        device; a block on the stats route ships no data."""
        base = self.prior_setup.base_means
        if hi is None:
            return Planes(self.data.to(self.dtype), self.coords, self.supp,
                          base, self.locked_centres)

        def ship(x):
            return None if x is None else x[..., lo:hi].to(self.device)
        data = None if self.use_stats else ship(self.data).to(self.dtype)
        return Planes(data, ship(self.coords), ship(self.supp),
                      base if base.shape[-1] == 1 else base[:, lo:hi],
                      ship(self.locked_centres))

    def _report(self, done):
        if self.progress_cb is not None:
            self.progress_cb(done * self.nvoxels // self.max_its,
                             self.nvoxels)

    def _sweeps(self, s, planes, stats):
        """The sweep loop -> (final state, sweeps run): max-iterations
        sweeps, F only on the last; or, with spatial-fchange, until the
        global F changes by no more than it between sweeps."""
        if self.f_stop_tol <= 0:
            for it in range(self.max_its):
                s = self._sweep(it, s, planes, stats,
                                skip_f=it != self.max_its - 1)
                self._report(it + 1)
            return s, self.max_its

        def fglobal(st):
            return torch.sum(torch.where(st.bad | ~torch.isfinite(st.f),
                                         0.0, st.f))
        fg, it = fglobal(s), 0
        while it < self.max_its:
            s = self._sweep(it, s, planes, stats)
            it += 1
            self._report(it)
            fg2 = fglobal(s)
            if not bool(torch.abs(fg2 - fg) > self.f_stop_tol):
                break
            fg = fg2
        return s, it

    def run(self, continue_means=None, continue_cov=None,
            continue_noise=None):
        """The spatial run -> VBResult (excised voxels marked bad); sets
        final_ak and coefficient_resels."""
        if self.block_voxels > 0:
            return self._run_blocked(continue_means, continue_cov,
                                     continue_noise)
        self._capacity_check()
        base = self.initial_state(continue_means, continue_cov,
                                  continue_noise)
        s = SpatialState(
            post=base.post, centre=base.centre, f=base.f,
            ak=torch.full((len(self.spatial_params),), AK_INIT,
                          dtype=self.dtype, device=self.device),
            bad=torch.zeros(self.nvoxels, dtype=torch.bool,
                            device=self.device))
        stats = self.noise.make_design_stats(self._design_tensor(),
                                             self.data) \
            if self.use_stats else None
        s, nswept = self._sweeps(s, self._planes(), stats)
        return self._finish(s, nswept)

    def _noprior_chunk(self):
        """compute_noprior's voxels per pass: a blocked run's block, its
        data shipped from the host one block at a time."""
        return self.block_voxels or self.nvoxels

    def _finish(self, s, nswept):
        """final_ak, the coefficient resels (Penny 2005,
        inference_vb.cc:727-756: per parameter the mean over voxels of
        1 - sigma_post/sigma_prior, excised voxels counting 0) and the
        result, excised voxels marked bad, with the likelihood-only
        posterior under spatial-prior-output-correction (JAX
        spatial.py:919-920, 1186-1187)."""
        self.final_ak = s.ak.to(self.dtype).cpu().numpy()
        gamma = 1.0 - sm.diag_of(s.post.cov) * s.post.prior_prec
        gamma = torch.where(s.bad[None] | ~torch.isfinite(gamma), 0.0, gamma)
        self.coefficient_resels = \
            torch.sum(gamma, dim=1).cpu().numpy() / self.ak_nvoxels
        nv, dev = self.nvoxels, s.f.device
        conv = self.detector.init_state(nv, self.dtype, device=dev)
        final = VBLoopState(
            it=nswept, post=s.post, centre=s.centre, f=s.f,
            fprior=torch.zeros(nv, dtype=self.dtype, device=dev),
            conv=conv._replace(its=torch.full((nv,), nswept,
                                              dtype=torch.int32,
                                              device=dev)))
        result = self._to_result(final)
        if self.progress_cb is not None:
            self.progress_cb(nv, nv)
        result = result._replace(
            bad_voxels=result.bad_voxels | s.bad.cpu().numpy())
        if self.options.get_bool("spatial-prior-output-correction"):
            result = self.compute_noprior(result)
        return result

    def _run_blocked(self, continue_means, continue_cov, continue_noise):
        """The beyond-device-memory run: the state lives on the host;
        each sweep computes the neighbour sums and aK there (aK
        accumulated in float64), then ships the volume through the
        device one block at a time. The Jacobi sweep reads other voxels
        only through those sums, so block-sequential execution is the
        same sweep. On the stats route each block's statistics are made
        once, from its data shipped once, and kept on the host."""
        vbk, nv = self.block_voxels, self.nvoxels
        blocks = [(lo, min(lo + vbk, nv)) for lo in range(0, nv, vbk)]
        host = torch.device("cpu")

        def to_host(x):
            return x.to(host)
        parts = [self.initial_state(continue_means, continue_cov,
                                    continue_noise, lo=lo, hi=hi)
                 for lo, hi in blocks]
        post_h = _tree(lambda *xs: torch.cat([to_host(x) for x in xs], -1),
                       *[st.post for st in parts])
        centre_h = torch.cat([to_host(st.centre) for st in parts], -1)
        f_h = torch.cat([to_host(st.f) for st in parts], -1)
        del parts
        bad_h = torch.zeros(nv, dtype=torch.bool)
        ak_h = torch.full((len(self.spatial_params),), AK_INIT,
                          dtype=torch.float64)
        stats_h = [
            _tree(to_host, self.noise.make_design_stats(
                self._design_tensor(), self.data[:, lo:hi].to(self.device)))
            for lo, hi in blocks] if self.use_stats else None

        nswept, fg_prev = self.max_its, None
        for it in range(self.max_its):
            active = ~bad_h
            nsums = []
            if self.spatial_params:
                nsums = self._gather_sums(post_h.means, active,
                                          *self._neigh_planes("cpu"))
                if it > 0 or self.update_first_iter:
                    ak_h = self._calculate_ak(
                        post_h.means.double(),
                        sm.diag_of(post_h.cov).double(), active, nsums)
            ak = ak_h.to(device=self.device, dtype=self.dtype)
            for b, (lo, hi) in enumerate(blocks):
                def ship(x):
                    return x[..., lo:hi].to(self.device)
                s_b = SpatialState(post=_tree(ship, post_h),
                                   centre=ship(centre_h), f=ship(f_h),
                                   ak=ak, bad=ship(bad_h))
                nsums_b = [tuple(None if x is None else ship(x) for x in t)
                           for t in nsums]
                stats_b = None if stats_h is None \
                    else _tree(lambda x: x.to(self.device), stats_h[b])
                out = self._sweep_core(it, s_b, self._planes(lo, hi),
                                       stats_b, nsums_b, ak, ~s_b.bad)

                def put(dst, src):
                    dst[..., lo:hi] = src.to(host)
                _tree(put, post_h, out.post)
                put(centre_h, out.centre)
                put(f_h, out.f)
                put(bad_h, out.bad)
            self._report(it + 1)
            if self.f_stop_tol > 0:
                fm = torch.where(bad_h | ~torch.isfinite(f_h), 0.0, f_h)
                fg = float(torch.sum(fm, dtype=torch.float32))
                if fg_prev is not None \
                        and abs(fg - fg_prev) <= self.f_stop_tol:
                    nswept = it + 1
                    break
                fg_prev = fg
        s = SpatialState(post=post_h, centre=centre_h, f=f_h, ak=ak_h,
                         bad=bad_h)
        return self._finish(s, nswept)
