from .base import NoiseModel, register_noise, get_noise_class, known_noise_models  # noqa: F401
from . import white, ar1  # noqa: F401,E402
