"""Polynomial forward model: c0 + c1*t + ... + cd*t^d over t = 1..T.

Port of fabber_core_tpu/models/poly.py (fwdmodel_poly.cc:47-80:
parameter names c0..cd, priors/posteriors N(0, 1e12), samples indexed
from 1).
"""

import numpy as np
import torch

from ..options import OptionSpec, OPT_INT
from .base import DistParams, Model, ParamSpec, register_model


@register_model
class PolynomialModel(Model):
    name = "poly"

    def __init__(self, options):
        self.degree = options.get_int("degree")

    @classmethod
    def get_options(cls):
        return [OptionSpec("degree", OPT_INT,
                           "Maximum power in the polynomial function", True)]

    @classmethod
    def describe(cls):
        return ("Model which fits data to a simple polynomial function: "
                "c0 + c1x + c2x^2 ... etc")

    def param_defaults(self):
        return [
            ParamSpec(i, f"c{i}", DistParams(0, 1e12), DistParams(0, 1e12))
            for i in range(self.degree + 1)
        ]

    def evaluate(self, params, ctx, key=""):
        # t = 1..T (the reference indexes samples from 1)
        t = torch.arange(1, ctx.nt + 1, dtype=params.dtype,
                         device=params.device)
        powers = t[:, None] ** torch.arange(self.degree + 1, dtype=params.dtype,
                                            device=params.device)[None, :]
        return powers @ params

    def fixed_design(self, nt):
        t = np.arange(1, nt + 1, dtype=np.float64)
        return t[:, None] ** np.arange(self.degree + 1, dtype=np.float64)[None, :]
