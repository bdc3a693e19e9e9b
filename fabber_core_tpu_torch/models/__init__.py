from .base import (  # noqa: F401
    DistParams, ParamSpec, Model, EvalContext,
    register_model, get_model_class, known_models, load_models_from_file,
    resolve_parameters,
)

# Built-in model families register themselves on import
from . import poly, exp, linear  # noqa: F401,E402
