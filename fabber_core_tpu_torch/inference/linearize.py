"""Batched linearization of forward models (SoA layout).

Port of fabber_core_tpu/inference/linearize.py (the reference's
per-voxel LinearizedFwdModel::ReCentre, fwdmodel_linear.cc:126-182):
one batched evaluation and Jacobian over all voxels, voxels on the
last axis. Two Jacobian sources:

  * "auto" (default): torch.func.jacfwd through the latent->model
    transform and the model function, vmapped over voxels;
  * "fd": central finite differences with the reference's step rule
    delta = max(|m_i| * 1e-5, 1e-10).

The Jacobian is taken in latent space (including the transform chain).
"""

import torch
from torch.func import jacfwd, vmap

from ..models.base import EvalContext

FD_REL_STEP = 1e-5
FD_MIN_STEP = 1e-10


def make_latent_evaluator(model, params, nt, key=""):
    """Single-voxel latent-space evaluation fn (latent [P], data [T],
    coords [3], supp [S] or None) -> signal [T]."""
    transforms = [p.transform for p in params]
    all_identity = all(t.is_identity for t in transforms)

    def latent_to_model(latent):
        if all_identity:
            return latent
        return torch.stack([t.to_model(latent[i])
                            for i, t in enumerate(transforms)])

    def evaluate(latent, data, coords, supp):
        ctx = EvalContext(data=data, coords=coords, suppdata=supp, nt=nt)
        return model.evaluate(latent_to_model(latent), ctx, key=key)

    return evaluate


class Linearizer:
    """recentre(means [P,V], data [T,V], coords [3,V], supp [S,V] or
    None) -> (offset [T,V], jacobian [P,T,V])."""

    def __init__(self, model, params, nt, mode="auto", key=""):
        if mode not in ("auto", "fd"):
            raise ValueError(f"Unknown linearization mode: {mode}")
        self.nt = nt
        self.mode = mode
        self._eval_one = make_latent_evaluator(model, params, nt, key)

    @staticmethod
    def _dims(supp):
        return (-1, -1, -1, None if supp is None else -1)

    def evaluate(self, means, data, coords, supp=None):
        """Just the model signal at the given latent means: [T,V]."""
        return vmap(self._eval_one, in_dims=self._dims(supp),
                    out_dims=-1)(means, data, coords, supp)

    def __call__(self, means, data, coords, supp=None):
        offset = self.evaluate(means, data, coords, supp)
        if self.mode == "auto":
            # per voxel a [T,P] Jacobian, stacked on the last axis
            jac = vmap(jacfwd(self._eval_one, argnums=0),
                       in_dims=self._dims(supp), out_dims=-1)(
                           means, data, coords, supp)
            jac = jac.permute(1, 0, 2)  # [T,P,V] -> [P,T,V]
        else:
            jac = self._fd_jacobian(means, data, coords, supp)
        return offset, jac

    def _fd_jacobian(self, means, data, coords, supp):
        """Central differences with the reference's step rule."""
        p = means.shape[0]
        delta = torch.clamp(torch.abs(means) * FD_REL_STEP,
                            min=FD_MIN_STEP)  # [P,V]
        rows = []
        for i in range(p):
            up = means.clone()
            dn = means.clone()
            up[i] = up[i] + delta[i]
            dn[i] = dn[i] - delta[i]
            f_up = self.evaluate(up, data, coords, supp)
            f_dn = self.evaluate(dn, data, coords, supp)
            rows.append((f_up - f_dn) / (up[i] - dn[i])[None, :])
        return torch.stack(rows)  # [P,T,V]
