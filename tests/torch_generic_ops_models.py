"""Torch models whose evaluate (or time_signal) reaches the rest of the
JAX probe's allowlist (fabber_core_tpu/models/base.py
_KERNEL_SAFE_PRIMITIVES) in models/kernelgen.py: a plugin file
(`--loadmodels=tests/torch_generic_ops_models.py`) that
tests/test_torch_generic_ops.py, tests/test_torch_cuda.py and
chip_smoke.py load. No jax here: chip_smoke.py loads it on the card
machine. Each has log-transformed parameters (exp's priors: N(1, 1e5) in
model space, the posterior starting at N(1, 1.5)), sampled every DT:

  pairs-test    s = a exp(-r t) normalised by its own length,
                n = s / sqrt(dot(s, s)) (a contraction of two parameter
                planes over time), scaled by the extremum over time and
                a stacking axis, top = max(stack([s, s / 2])), plus the
                sum over one time axis of exp(-(s_i - s_j)^2), a value
                with two time axes, the extremum over both time axes of
                s_i s_(T-1-j), and the sum over the time axis of s_i w_j,
                whose other axis is that of a constant weight w_j =
                0.5 + j / (T - 1):
                s + 0.2 top n + 0.002 dens + 0.1 max_ij s_i s_(T-1-j)
                + 0.01 sum_i s_i w_j (P = 2, the full-time walk; 35 time
                planes, which the JAX picker fits up to T = 64: the tests
                run it at T=30, chip_smoke.py at T=64);
  mixed-test    a exp(-r t) of q = MIX @ p, a constant matrix times the
                parameters (P = 2, the per-sample walk);
  stacked-test  time_signal only: the same signal, its stacked parameter
                planes contracted with MIX (kernels 7 and 8 through a
                functor generated from time_signal, and kernel 6).

The signals' numpy forms (signal) make the tests' and chip_smoke.py's
data."""

import numpy as np
import torch

from fabber_core_tpu_torch.core.transforms import TRANSFORM_LOG
from fabber_core_tpu_torch.models.base import (DistParams, Model, ParamSpec,
                                               register_model)

DT = 0.05
# q = MIX p: an amplitude and a rate mixed from the two parameters
MIX = np.array([[1.0, 0.5], [-0.2, 1.0]])
_MIX = torch.as_tensor(MIX, dtype=torch.float32)

def _params(names):
    return [ParamSpec(i, n, DistParams(1, 1e5), DistParams(1, 1.5),
                      transform=TRANSFORM_LOG) for i, n in enumerate(names)]


class _Base(Model):
    def __init__(self, options=None):
        pass

    def param_defaults(self):
        return _params(["amp", "r"])


@register_model
class Pairs(_Base):
    name = "pairs-test"

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * DT
        s = params[0] * torch.exp(-params[1] * t)
        norm = s / torch.sqrt(torch.dot(s, s))
        top = torch.stack([s, 0.5 * s]).amax()
        dens = torch.exp(-(s[:, None] - s[None, :]) ** 2).sum(1)
        top2 = (s[:, None] * torch.flip(s, [0])[None, :]).amax()
        w = 0.5 + torch.arange(ctx.nt, dtype=params.dtype,
                               device=params.device) / (ctx.nt - 1)
        mix = (s[:, None] * w[None, :]).sum(0)
        return (s + 0.2 * top * norm + 0.002 * dens + 0.1 * top2
                + 0.01 * mix)


@register_model
class Mixed(_Base):
    name = "mixed-test"

    def evaluate(self, params, ctx, key=""):
        q = _MIX.to(params.device, params.dtype) @ params
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * DT
        return q[0] * torch.exp(-q[1] * t)


@register_model
class Stacked(_Base):
    name = "stacked-test"

    def time_signal(self, params, t):
        """Model-space planes and the sample index, broadcast: the
        parameter planes stacked and contracted with MIX."""
        q = torch.tensordot(_MIX.to(params[0].device, params[0].dtype),
                            torch.stack(params), dims=1)
        return q[0] * torch.exp(-q[1] * (t * DT))

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype, device=params.device)
        return self.time_signal(list(params), t)


def signal(name, m, nt):
    """The model's signal [T,V] at model-space parameters m [P,V] (numpy,
    float64)."""
    t = np.arange(nt)[:, None] * DT
    if name == "pairs-test":
        s = m[0] * np.exp(-m[1] * t)
        norm = s / np.sqrt((s * s).sum(0))
        top = np.maximum(s.max(0), 0.5 * s.max(0))
        dens = np.exp(-(s[:, None] - s[None, :]) ** 2).sum(1)
        w = 0.5 + np.arange(nt)[:, None] / (nt - 1)
        # s > 0 falls with t: the largest s_i s_(T-1-j) is s_0 s_0
        return (s + 0.2 * top * norm + 0.002 * dens + 0.1 * s[0] ** 2
                + 0.01 * w * s.sum(0))
    q = MIX @ m
    return q[0] * np.exp(-q[1] * t)


def signal_torch(name, m, nt):
    """signal on the card: m [P,V] a float32 tensor -> [T,V]; the pairs'
    sum over one time axis taken a sample at a time ([T,V] planes
    only)."""
    t = torch.arange(nt, dtype=m.dtype, device=m.device)[:, None] * DT
    if name == "pairs-test":
        s = m[0] * torch.exp(-m[1] * t)
        norm = s / torch.sqrt((s * s).sum(0))
        top = torch.maximum(s.amax(0), 0.5 * s.amax(0))
        dens = torch.stack([torch.exp(-(s[i] - s) ** 2).sum(0)
                            for i in range(nt)])
        top2 = (s * torch.flip(s, [0]).amax(0)).amax(0)
        w = 0.5 + torch.arange(nt, dtype=m.dtype,
                               device=m.device)[:, None] / (nt - 1)
        return (s + 0.2 * top * norm + 0.002 * dens + 0.1 * top2
                + 0.01 * w * s.sum(0))
    q = _MIX.to(m.device, m.dtype) @ m
    return q[0] * torch.exp(-q[1] * t)
