"""Prior application for the non-spatial prior types N (normal, the
model default), I (image) and A (ARD), over voxel planes.

Port of fabber_core_tpu/inference/priors.py (priors.cc:108-181). Prior
precision is diagonal: [P,1] planes that broadcast over voxels. Image
priors give voxelwise prior means [P,V]; otherwise the means stay a
[P,1] broadcast. ARD priors set each iteration's prior variance from
the posterior (mean^2 + var; the model default at iteration 0) and add
a free-energy term. The spatial types (M/m/P/p) couple voxels through
the neighbour graph: inference/spatial.py builds their priors, and
apply() leaves their prior planes as they are.
"""

import math

import numpy as np
import torch

from ..models.base import PRIOR_ARD, PRIOR_IMAGE, SPATIAL_PRIOR_TYPES

# digamma(0.5) = -euler_gamma - 2 ln 2 and gammaln(0.5), for the ARD
# free energy term (Chappell 2009 App. D)
_DIGAMMA_HALF = -0.5772156649015328606 - 2.0 * math.log(2.0)
_GAMMALN_HALF = math.lgamma(0.5)


class PriorSetup:
    """Precomputed per-parameter prior configuration for one run."""

    def __init__(self, params, voxel_data, nvoxels, dtype, device="cpu"):
        """params: list[ParamSpec] with latent-space priors.
        voxel_data: callable key -> [V] or [V,T] array (image priors).
        """
        nparams = len(params)

        def plane(rows):
            return torch.tensor(rows, dtype=dtype, device=device)

        base_means = [[p.prior.mean] for p in params]   # [P,1]
        image_params = [i for i, p in enumerate(params)
                        if p.prior_type == PRIOR_IMAGE]
        if image_params:
            means_vox = np.broadcast_to(
                np.asarray(base_means, np.float64),
                (nparams, nvoxels)).copy()
            for i in image_params:
                key = params[i].options["image"]
                img = np.asarray(voxel_data(key)).reshape(nvoxels, -1)
                means_vox[i] = img[:, 0]
            self.base_means = torch.as_tensor(means_vox, dtype=dtype,
                                              device=device)   # [P,V]
        else:
            self.base_means = plane(base_means)                  # [P,1]
        self.base_precs = plane([[p.prior.prec] for p in params])  # [P,1]
        self.base_vars = plane([[p.prior.var] for p in params])    # [P,1]
        self.ard_mask = torch.tensor(
            [[p.prior_type == PRIOR_ARD] for p in params], device=device)
        self.has_ard = bool(self.ard_mask.any())
        self.spatial_params = [i for i, p in enumerate(params)
                               if p.prior_type in SPATIAL_PRIOR_TYPES]
        self.spatial_mask = torch.tensor(
            [[i in self.spatial_params] for i in range(nparams)],
            device=device)
        self.nparams = nparams
        self.dtype = dtype

    def apply(self, prior_means, prior_prec, post_means, post_cov_diag, it,
              base_means=None):
        """One sweep of the non-spatial prior updates (priors.cc:
        108-181): [P,V] planes -> (prior_means, prior_prec, f_contribs),
        f_contribs[k] being prior k's free-energy term (non-zero only
        for ARD). it: the iteration (sweep) index; base_means: the
        [P,V] or [P,1] prior means to use (a block's slice of an image
        prior), default the run's."""
        shape = (self.nparams, post_means.shape[1])
        if base_means is None:
            base_means = self.base_means
        means = base_means.expand(shape)
        precs = self.base_precs.expand(shape)
        f_contribs = torch.zeros(shape, dtype=self.dtype,
                                 device=post_means.device)
        if self.has_ard:
            # ARD prior variance: posterior mean^2 + variance from
            # iteration 1 on, the model default at iteration 0
            # (priors.cc:150-181); the prior mean stays the default
            new_var = post_means ** 2 + post_cov_diag
            ard_var = self.base_vars.expand(shape) if it == 0 else new_var
            precs = torch.where(self.ard_mask, 1.0 / ard_var, precs)
            # its free-energy term, from new_var at every iteration (as
            # the reference computes it)
            b = 2.0 / new_var
            fard = (-1.5 * (torch.log(b) + _DIGAMMA_HALF) - 0.5
                    - _GAMMALN_HALF - 0.5 * torch.log(b))
            f_contribs = torch.where(self.ard_mask, fard, f_contribs)
        if self.spatial_params:
            # the spatial engine's priors: their planes pass through
            means = torch.where(self.spatial_mask, prior_means, means)
            precs = torch.where(self.spatial_mask, prior_prec, precs)
        return means, precs, f_contribs
