"""Polynomial forward model: c0 + c1*t + ... + cd*t^d over t = 1..T.

Port of fabber_core_tpu/models/poly.py (fwdmodel_poly.cc:47-80:
parameter names c0..cd, priors/posteriors N(0, 1e12), samples indexed
from 1).
"""

import numpy as np
import torch

from ..options import OptionSpec, OPT_INT
from .base import (DistParams, KernelModel, Model, ParamSpec,
                   register_model, KERNEL_POLY)


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

    def time_signal(self, params, t):
        """Time-local form: params a list of model-space [1,V] planes,
        t the 0-based sample index [T,1]."""
        return self.time_signal_jac(params, t)[0]

    def time_signal_jac(self, params, t):
        """Analytic Jacobian: ds/dc_k = (t+1)^k, the powers shared
        with the signal."""
        tv = t + 1.0  # reference samples run 1..T
        sig = params[0] * torch.ones_like(tv)
        jac = [torch.ones_like(tv) * torch.ones_like(params[0])]
        power = tv
        for i in range(1, self.degree + 1):
            sig = sig + params[i] * power
            jac.append(power * torch.ones_like(params[i]))
            power = power * tv
        return sig, jac

    def kernel_model(self):
        return KernelModel(KERNEL_POLY, self.degree + 1)
