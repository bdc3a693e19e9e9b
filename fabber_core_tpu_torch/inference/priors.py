"""Prior setup for the non-spatial prior types N (normal, the model
default) and I (image), over voxel planes.

Port of the setup part of fabber_core_tpu/inference/priors.py
(priors.cc:108-181). Prior precision is diagonal: [P,1] planes that
broadcast over voxels. Image priors give voxelwise prior means [P,V];
otherwise the means stay a [P,1] broadcast. ARD (type A) and the
spatial types (M/m/P/p) are only detected here (has_ard,
spatial_params): the engine's route gate refuses them, and apply()
raises for them, since their iteration-dependent priors are not
ported.
"""

import numpy as np
import torch

from ..models.base import PRIOR_ARD, PRIOR_IMAGE, SPATIAL_PRIOR_TYPES


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
        self.has_ard = any(p.prior_type == PRIOR_ARD for p in params)
        self.spatial_params = [i for i, p in enumerate(params)
                               if p.prior_type in SPATIAL_PRIOR_TYPES]
        self.nparams = nparams
        self.dtype = dtype

    def apply(self, prior_means, prior_prec, post_means, post_cov_diag, it,
              base_means=None):
        """One sweep of the non-spatial prior updates (priors.cc:
        108-181): [P,V] planes -> (prior_means, prior_prec, f_contribs),
        f_contribs[k] being prior k's free-energy term (zero for N and
        I priors)."""
        if self.has_ard:
            raise NotImplementedError(
                "ARD priors are not ported to fabber_core_tpu_torch yet "
                "(ROADMAP Queue 1 item 17)")
        if self.spatial_params:
            raise NotImplementedError(
                "spatial priors are not ported to fabber_core_tpu_torch "
                "yet (ROADMAP Queue 1 item 16)")
        shape = (self.nparams, post_means.shape[1])
        if base_means is None:
            base_means = self.base_means
        means = base_means.expand(shape)
        precs = self.base_precs.expand(shape)
        f_contribs = torch.zeros(shape, dtype=self.dtype,
                                 device=post_means.device)
        return means, precs, f_contribs
