"""Noise model protocol + registry.

Port of fabber_core_tpu/noise/base.py. A noise model owns the VB
update equations (UpdateTheta / UpdateNoise / CalcFreeEnergy in the
reference, noisemodel.h:94-160) over voxel planes; its state is a
small NamedTuple of tensors.
"""

from ..exceptions import InvalidOptionValue

_NOISE = {}


def register_noise(cls):
    _NOISE[cls.name] = cls
    return cls


def get_noise_class(name):
    try:
        return _NOISE[name]
    except KeyError:
        raise InvalidOptionValue("noise", name, "Unrecognized noise type")


def known_noise_models():
    return sorted(_NOISE)


class NoiseModel:
    """Base protocol; see white.WhiteNoiseModel for the array layout."""

    name = None

    def __init__(self, options, nt, masked_tpoints=()):
        self.nt = nt
        self.masked_tpoints = list(masked_tpoints)

    @property
    def num_params(self):
        """Number of noise parameters serialized into result MVNs."""
        raise NotImplementedError

    def initial_state(self, nvoxels, dtype, device="cpu"):
        """Return (prior_state, posterior_state)."""
        raise NotImplementedError

    def state_to_mvn(self, state):
        """Noise state -> (means [V,Q], cov [V,Q,Q]) for serialization."""
        raise NotImplementedError

    def state_from_mvn(self, means, cov):
        raise NotImplementedError

    # -- VB updates on per-voxel Jacobian planes (generic route) ---------
    def update_theta(self, noise_post, means, prior_means, prior_prec,
                     centre, offset, jac, data):
        """Eq 19/20 (UpdateTheta): -> (means [P,V], prec [P,P,V],
        cov [P,P,V], ok [V])."""
        raise NotImplementedError

    def update_noise(self, noise_post, noise_prior, means, cov,
                     centre, offset, jac, data):
        """Eq 21/22 (UpdateNoise): -> the new noise state."""
        raise NotImplementedError

    def free_energy(self, noise_post, noise_prior, means, prec, cov,
                    prior_means, prior_prec, centre, offset, jac, data):
        """The ELBO (CalcFreeEnergy): -> F [V]."""
        raise NotImplementedError
