"""Parameter transforms between latent (Gaussian) and model space.

Port of fabber_core_tpu/core/transforms.py (reference transforms.h:
59-259) as elementwise torch. Every method takes a Python float or a
tensor; float inputs are promoted to float64 tensors so host-side
prior setup keeps double precision.

Variance mapping follows the reference's ad-hoc convention
(transforms.cc:17-25):
    to_model_var(v) = (to_model(sqrt(v)) - to_model(0))^2
    to_latent_var(v) = to_latent(to_model(0) + sqrt(v))^2
with per-transform overrides (log: var passes through exp/log;
fractional/abs: identity).
"""

import torch

from ..exceptions import InvalidOptionValue


def _t(x):
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64)


class Transform:
    code = "?"

    def to_model(self, x):
        raise NotImplementedError

    def to_latent(self, x):
        raise NotImplementedError

    def to_model_var(self, v):
        d = self.to_model(torch.sqrt(_t(v))) - self.to_model(0.0)
        return d * d

    def to_latent_var(self, v):
        d = self.to_latent(self.to_model(0.0) + torch.sqrt(_t(v)))
        return d * d

    # moment-pair mapping (mean, var)
    def to_model_moments(self, mean, var):
        return self.to_model(mean), self.to_model_var(var)

    def to_latent_moments(self, mean, var):
        return self.to_latent(mean), self.to_latent_var(var)

    @property
    def is_identity(self):
        return self.code == "I"


class IdentityTransform(Transform):
    code = "I"

    def to_model(self, x):
        return x

    def to_latent(self, x):
        return x

    def to_model_var(self, v):
        return v

    def to_latent_var(self, v):
        return v


class LogTransform(Transform):
    """Latent is log of model value (log-normal parameter)."""
    code = "L"

    def to_model(self, x):
        return torch.exp(_t(x))

    def to_latent(self, x):
        return torch.log(_t(x))

    def to_model_var(self, v):
        return torch.exp(_t(v))

    def to_latent_var(self, v):
        return torch.log(_t(v))


class SoftPlusTransform(Transform):
    """Positive parameters; approaches identity for large values.

    Clamped to identity above 10 as in transforms.h:167-192.
    """
    code = "S"

    def to_model(self, x):
        x = _t(x)
        return torch.where(x < 10.0,
                           torch.log1p(torch.exp(torch.clamp(x, max=10.0))), x)

    def to_latent(self, x):
        x = _t(x)
        safe = torch.where(x < 10.0, x, torch.full_like(x, 10.0))
        return torch.where(x < 10.0, torch.log(torch.expm1(safe)), x)


class FractionalTransform(Transform):
    """Values in (0, 1); variance untouched (transforms.h:203-222)."""
    code = "F"

    def to_model(self, x):
        return 1.0 / (1.0 + torch.exp(_t(x)))

    def to_latent(self, x):
        return torch.log(1.0 / _t(x) - 1.0)

    def to_model_var(self, v):
        return v

    def to_latent_var(self, v):
        return v


class AbsTransform(Transform):
    """Non-negative via modulus; not invertible (transforms.h:231-242)."""
    code = "A"

    def to_model(self, x):
        return torch.abs(_t(x))

    def to_latent(self, x):
        return x


TRANSFORM_IDENTITY = IdentityTransform()
TRANSFORM_LOG = LogTransform()
TRANSFORM_SOFTPLUS = SoftPlusTransform()
TRANSFORM_FRACTIONAL = FractionalTransform()
TRANSFORM_ABS = AbsTransform()

_REGISTRY = {t.code: t for t in (
    TRANSFORM_IDENTITY, TRANSFORM_LOG, TRANSFORM_SOFTPLUS,
    TRANSFORM_FRACTIONAL, TRANSFORM_ABS)}


def get_transform(code):
    try:
        return _REGISTRY[code]
    except KeyError:
        raise InvalidOptionValue("transform", code,
                                 f"Supported transforms: {', '.join(_REGISTRY)}")
