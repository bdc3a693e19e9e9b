"""Forward-model protocol, registry and parameter resolution.

Port of fabber_core_tpu/models/base.py (reference fwdmodel.h:89-155,
fwdmodel.cc:210-313). A model is a plain function
``evaluate(params [P] tensor, ctx) -> signal [T]``; a model that is
linear in its parameters also exposes its constant [T,P] design
(``fixed_design``), which is what the port's spectral route runs on.
A time-local model adds ``time_signal``/``time_signal_jac`` and, when
the CUDA kernels carry a functor for it, ``kernel_model``. A model with
only an ``evaluate`` reaches the whole-loop kernel through the probe of
models/kernelgen.py (derive_time_local_eval), which also generates its
CUDA functor.
"""

import importlib
import importlib.util
from dataclasses import dataclass, field, replace
from typing import NamedTuple

from ..core import transforms
from ..exceptions import InvalidOptionValue

PRIOR_NORMAL = "N"
PRIOR_IMAGE = "I"
PRIOR_ARD = "A"
PRIOR_SPATIAL_M = "M"
PRIOR_SPATIAL_m = "m"
PRIOR_SPATIAL_P = "P"
PRIOR_SPATIAL_p = "p"
PRIOR_DEFAULT = "-"

SPATIAL_PRIOR_TYPES = "MmPp"

# Highest prior precision accepted before clamping (fwdmodel.cc:268-271)
MAX_PRIOR_PRECISION = 1e12


@dataclass(frozen=True)
class DistParams:
    """Scalar mean/variance pair for one parameter's prior/posterior."""
    mean: float = 0.0
    var: float = 1.0

    @property
    def prec(self):
        return 1.0 / self.var


@dataclass
class ParamSpec:
    idx: int
    name: str
    prior: DistParams = field(default_factory=DistParams)
    post: DistParams = field(default_factory=DistParams)
    prior_type: str = PRIOR_NORMAL
    transform: transforms.Transform = transforms.TRANSFORM_IDENTITY
    options: dict = field(default_factory=dict)
    desc: str = ""
    units: str = ""


KERNEL_POLY = 0   # c0 + c1 (t+1) + ... (PolyModel in csrc/vb_device.cuh)
KERNEL_EXP = 1    # sum_i a_i exp(-r_i t dt) (ExpSum in csrc/vb_device.cuh)


class KernelModel(NamedTuple):
    """A model functor of the CUDA kernels: its kind (KERNEL_POLY or
    KERNEL_EXP), its parameter count and its sample spacing dt."""
    kind: int
    nparams: int
    dt: float = 0.0


@dataclass
class EvalContext:
    """Per-voxel data available to a model evaluation
    (FwdModel::PassData state, fwdmodel.cc:198-208)."""
    data: object = None       # [T] timeseries for this voxel
    coords: object = None     # [3] voxel grid coordinates
    suppdata: object = None   # [S] supplemental data, or None
    nt: int = 0               # number of timepoints


class Model:
    """Base class for forward models."""

    name = None

    def __init__(self, options):
        """options is a RunOptions; read model config here."""

    @classmethod
    def get_options(cls):
        """Return list of OptionSpec for this model."""
        return []

    @classmethod
    def describe(cls):
        return "No description available"

    def param_defaults(self):
        """Return list[ParamSpec] — model's default parameterization."""
        raise NotImplementedError

    def evaluate(self, params, ctx, key=""):
        """Model-space forward evaluation: params [P] -> signal [T]."""
        raise NotImplementedError

    def outputs(self):
        """Alternate output keys beyond the main signal."""
        return []

    def init_posterior(self, data, means):
        """Voxelwise posterior init hook (InitVoxelPosterior
        equivalent): data [V,T] and means [V,P] are model-space
        tensors; return updated means. Default: no change."""
        return means

    def fixed_design(self, nt):
        """The [T,P] float64 numpy design matrix if the model is linear
        in its parameters with a voxel-independent Jacobian, else None."""
        return None

    def kernel_model(self):
        """The KernelModel the CUDA kernels evaluate this model's
        time_signal_jac with, or None (the whole-loop kernel then runs a
        functor generated from the model, models/kernelgen.py)."""
        return None


# -- registry -------------------------------------------------------------

_MODELS = {}


def register_model(cls):
    """Class decorator: register a model family by its ``name``."""
    if not cls.name:
        raise ValueError(f"Model class {cls.__name__} has no name")
    _MODELS[cls.name] = cls
    return cls


def get_model_class(name):
    try:
        return _MODELS[name]
    except KeyError:
        raise InvalidOptionValue("model", name, "Unrecognized forward model")


def known_models():
    return sorted(_MODELS)


def load_models_from_file(path):
    """Dynamic model loading — the dlopen equivalent (fwdmodel.cc:63-129).

    ``path`` is either an importable module name or a path to a .py
    file; importing it runs its @register_model decorators.
    """
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            f"fabber_user_models_{abs(hash(path))}", path)
        if spec is None:
            raise InvalidOptionValue("loadmodels", path, "Cannot load module")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        importlib.import_module(path)


# -- parameter resolution (GetParameters equivalent) ----------------------

def resolve_parameters(model, options):
    """Merge model parameter defaults with user prior overrides.

    Same option semantics as FwdModel::GetParameters
    (fwdmodel.cc:210-282): the ``param-spatial-priors`` type string
    (with '+' repeat expansion), ``PSP_byname<n>{_type,_mean,_prec,
    _image,_transform}`` overrides, the 1e12 precision clamp, and the
    final transform of priors into latent space.

    Returns list[ParamSpec] with priors in *latent* space.
    """
    params = [replace(p) for p in model.param_defaults()]
    nparams = len(params)

    types = expand_prior_types_string(
        options.get_string("param-spatial-priors", ""), nparams)

    for p in params:
        if types[p.idx] != PRIOR_DEFAULT:
            p.prior_type = types[p.idx]

        # Data key for an image prior when specified positionally
        p.options = dict(p.options)
        p.options["image"] = f"image-prior{p.idx + 1}"

        # PSP_byname<n> overrides, matched by parameter name
        psp_idx = 1
        while True:
            name = options.get_string(f"PSP_byname{psp_idx}", "stop!")
            if name == "stop!":
                break
            if name == p.name:
                tcode = options.get_string(f"PSP_byname{psp_idx}_transform", "")
                if tcode:
                    p.transform = transforms.get_transform(tcode)
                ptype = options.get_string(f"PSP_byname{psp_idx}_type",
                                           p.prior_type)
                if ptype != PRIOR_DEFAULT:
                    p.prior_type = ptype
                mean = options.get_float(f"PSP_byname{psp_idx}_mean",
                                         p.prior.mean)
                prec = options.get_float(f"PSP_byname{psp_idx}_prec",
                                         p.prior.prec)
                p.prior = DistParams(mean, 1.0 / prec)
                p.options["image"] = f"PSP_byname{psp_idx}_image"
            psp_idx += 1

        if p.prior.prec > MAX_PRIOR_PRECISION:
            # Very high precision triggers numerical instability; clamp
            p.prior = DistParams(p.prior.mean, 1.0 / MAX_PRIOR_PRECISION)

        # Transform prior moments into latent space. Posterior is
        # transformed later in the initial-posterior build.
        m, v = p.transform.to_latent_moments(p.prior.mean, p.prior.var)
        p.prior = DistParams(float(m), float(v))

    return params


def expand_prior_types_string(priors_str, num_params):
    """Expand a prior-type string to one char per parameter.

    Handles the single '+' repeat character and '-' (model default)
    padding (priors.cc:35-92).
    """
    chars = [c for c in priors_str if c != "+"]
    n_str = len(chars)
    plus_count = priors_str.count("+")
    if plus_count > 1:
        raise InvalidOptionValue("param-spatial-priors", priors_str,
                                 "Only one + character allowed")
    if n_str > num_params:
        raise InvalidOptionValue("param-spatial-priors", priors_str,
                                 "Too many parameters")

    if n_str < num_params:
        deficit = num_params - n_str
        if plus_count:
            pos = priors_str.find("+")
            # repeat char is the one before '+', or '-' if none
            repeat = priors_str[pos - 1] if pos > 0 else "-"
            out = priors_str[:pos] + repeat * deficit + priors_str[pos + 1:]
        else:
            out = priors_str + "-" * deficit
    else:
        out = "".join(chars)

    if len(out) != num_params:
        raise InvalidOptionValue("param-spatial-priors", priors_str,
                                 "Cannot expand to one type per parameter")
    return out
