"""Linear design-matrix forward model: signal = D @ params.

Port of fabber_core_tpu/models/linear.py (fwdmodel_linear.cc:53-96):
the design matrix read from a VEST or ASCII file (``basis``), an
optional all-ones regressor (``add-ones-regressor``), default priors
and posteriors N(0, 1e12). The reference's centre/offset form
R = J(P-C)+O reduces to D@P with zero centre and offset, which is what
its Initialize sets up. The design is fixed, so the model runs on the
fixed-design routes.
"""

import numpy as np
import torch

from ..io import matfile
from ..options import OptionSpec, OPT_MATRIX, OPT_BOOL
from .base import DistParams, Model, ParamSpec, register_model


@register_model
class LinearModel(Model):
    name = "linear"

    def __init__(self, options):
        design = matfile.read_matrix_file(options.get_string("basis"))
        if options.get_bool("add-ones-regressor"):
            design = np.concatenate(
                [design, np.ones((design.shape[0], 1))], axis=1)
        self.design = np.asarray(design, np.float64)
        self.nparams = design.shape[1]

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("basis", OPT_MATRIX, "Design matrix", True),
            OptionSpec("add-ones-regressor", OPT_BOOL,
                       "Add an extra constant regressor"),
        ]

    @classmethod
    def describe(cls):
        return ("Model in which output is a linear combination of input "
                "parameters")

    def param_defaults(self):
        return [
            ParamSpec(i, f"Parameter_{i + 1}",
                      DistParams(0, 1e12), DistParams(0, 1e12))
            for i in range(self.nparams)
        ]

    def evaluate(self, params, ctx, key=""):
        return torch.as_tensor(self.design, dtype=params.dtype,
                               device=params.device) @ params

    def fixed_design(self, nt):
        return self.design
