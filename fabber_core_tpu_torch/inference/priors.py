"""Prior setup for the non-spatial prior types N (normal, the model
default) and I (image), over voxel planes.

Port of the setup part of fabber_core_tpu/inference/priors.py
(priors.cc:108-181). Prior precision is diagonal: [P,1] planes that
broadcast over voxels. Image priors give voxelwise prior means [P,V];
otherwise the means stay a [P,1] broadcast. ARD (type A) and the
spatial types (M/m/P/p) are only detected here (has_ard,
spatial_params): the engine's route gate refuses them, since their
iteration-dependent priors are not on the ported route.
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
