"""Sum-of-exponentials decay model: sum_i amp_i * exp(-r_i * t).

Port of fabber_core_tpu/models/exp.py (the reference's plugin example,
examples/fwdmodel_exp.cc:43-91): log-transformed amp/r parameters,
priors N(1, 1e5) / posteriors N(1, 1.5) in model space, and data-driven
posterior initialization of the amplitudes from the data maximum.
Also registered as "biexp" with num-exps defaulting to 2.
"""

import torch

from ..core.transforms import TRANSFORM_LOG
from ..options import OptionSpec, OPT_FLOAT, OPT_INT
from .base import (DistParams, KernelModel, Model, ParamSpec,
                   register_model, KERNEL_EXP)


@register_model
class ExpModel(Model):
    name = "exp"
    default_num_exps = 1

    def __init__(self, options):
        self.dt = options.get_float("dt")
        self.num = options.get_int("num-exps", self.default_num_exps)

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("dt", OPT_FLOAT, "Time separation between samples", True),
            OptionSpec("num-exps", OPT_INT, "Number of independent decay rates",
                       default="1"),
        ]

    @classmethod
    def describe(cls):
        return "Example model of a sum of exponentials"

    def param_defaults(self):
        params = []
        p = 0
        for i in range(self.num):
            params.append(ParamSpec(p, f"amp{i + 1}", DistParams(1, 1e5),
                                    DistParams(1, 1.5), transform=TRANSFORM_LOG))
            p += 1
            params.append(ParamSpec(p, f"r{i + 1}", DistParams(1, 1e5),
                                    DistParams(1, 1.5), transform=TRANSFORM_LOG))
            p += 1
        return params

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        sig = params[0] * torch.exp(-params[1] * t)
        for i in range(1, self.num):
            sig = sig + params[2 * i] * torch.exp(-params[2 * i + 1] * t)
        return sig

    def time_signal(self, params, t):
        """Time-local form: params is a list of model-space [1,V]
        planes, t the 0-based sample index [T,1]."""
        tv = t * self.dt
        sig = params[0] * torch.exp(-params[1] * tv)
        for i in range(1, self.num):
            sig = sig + params[2 * i] * torch.exp(-params[2 * i + 1] * tv)
        return sig

    def time_signal_jac(self, params, t):
        """Analytic model-space Jacobian: ds/da_i = e_i,
        ds/dr_i = -a_i t e_i (the exponentials are shared with the
        signal)."""
        tv = t * self.dt
        sig = None
        jac = []
        for i in range(self.num):
            e = torch.exp(-params[2 * i + 1] * tv)
            term = params[2 * i] * e
            sig = term if sig is None else sig + term
            jac.append(e)
            jac.append(-tv * term)
        return sig, jac

    def kernel_model(self):
        return KernelModel(KERNEL_EXP, 2 * self.num, float(self.dt))

    def init_posterior(self, data, means):
        # amp_i starts at data_max / (num + i) (fwdmodel_exp.cc:84-91)
        data_max = torch.max(data, dim=1).values.to(means.dtype)  # [V]
        means = means.clone()
        for i in range(self.num):
            means[:, 2 * i] = data_max / (self.num + i)
        return means


@register_model
class BiexpModel(ExpModel):
    name = "biexp"
    default_num_exps = 2

    @classmethod
    def describe(cls):
        return "Bi-exponential decay model (sum of two exponentials)"
