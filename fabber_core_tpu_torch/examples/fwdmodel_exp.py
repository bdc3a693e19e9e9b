"""Example user model plugin: the template for writing your own.

The torch twin of the JAX package's examples/fwdmodel_exp.py (the
reference's examples/fwdmodel_exp.cc): a sum-of-exponentials model with
log-transformed parameters and data-driven posterior initialization.
Load it with

    python -m fabber_core_tpu_torch.cli \
        --loadmodels=fabber_core_tpu_torch/examples/fwdmodel_exp.py \
        --model=myexp ...

It has no hand-written CUDA functor (kernel_model). On the card the
whole-loop kernel runs it through a functor generated from its
time_signal; without the time_signal hook, through one generated from
its evaluate (the kernel's generic full-time mode, models/kernelgen.py).
The route line of the run log says which.
"""

import torch

from fabber_core_tpu_torch.core.transforms import TRANSFORM_LOG
from fabber_core_tpu_torch.models.base import (DistParams, Model, ParamSpec,
                                               register_model)
from fabber_core_tpu_torch.options import OptionSpec, OPT_FLOAT, OPT_INT


@register_model
class MyExpModel(Model):
    name = "myexp"

    def __init__(self, options):
        self.dt = options.get_float("dt")
        self.num = options.get_int("num-exps", 1)

    @classmethod
    def get_options(cls):
        return [
            OptionSpec("dt", OPT_FLOAT, "Time separation between samples",
                       True),
            OptionSpec("num-exps", OPT_INT,
                       "Number of independent decay rates", default="1"),
        ]

    @classmethod
    def describe(cls):
        return "Example model of a sum of exponentials (plugin template)"

    def param_defaults(self):
        params = []
        for i in range(self.num):
            params.append(ParamSpec(2 * i, f"amp{i + 1}",
                                    DistParams(1, 1e5), DistParams(1, 1.5),
                                    transform=TRANSFORM_LOG))
            params.append(ParamSpec(2 * i + 1, f"r{i + 1}",
                                    DistParams(1, 1e5), DistParams(1, 1.5),
                                    transform=TRANSFORM_LOG))
        return params

    def evaluate(self, params, ctx, key=""):
        # arange(ctx.nt), scalar parameters and elementwise ops: the
        # probe admits it, so even without time_signal the engine runs
        # it in the whole-loop kernel
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        sig = params[0] * torch.exp(-params[1] * t)
        for i in range(1, self.num):
            sig = sig + params[2 * i] * torch.exp(-params[2 * i + 1] * t)
        return sig

    def init_posterior(self, data, means):
        data_max = torch.max(data, dim=1).values.to(means.dtype)
        means = means.clone()
        for i in range(self.num):
            means[:, 2 * i] = data_max / (self.num + i)
        return means

    def time_signal(self, params, t):
        """Optional: the time-local form (model-space [1,V] planes, the
        sample index [T,1])."""
        tv = t * self.dt
        sig = params[0] * torch.exp(-params[1] * tv)
        for i in range(1, self.num):
            sig = sig + params[2 * i] * torch.exp(-params[2 * i + 1] * tv)
        return sig
