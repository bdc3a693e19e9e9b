"""Torch models for the tests of the whole-loop kernel's generic mode:
the twins of tests/test_fused_loop_generic.py's models (GaussianAct,
SuppScaled, DataUsing, UnsafeOp), the port's exp without its time_signal,
and models the probe must refuse (coords, a presence check, cumsum),
that only its full-time walk admits (a flip, a sum over time) or that
use most of its allowlist; and restored(), which puts
model registries back as they were. No jax here: the card tests
(tests/test_torch_cuda.py) import it too."""

import contextlib

import torch

from fabber_core_tpu_torch.models import get_model_class
from fabber_core_tpu_torch.models.base import DistParams, Model, ParamSpec
from fabber_core_tpu_torch.options import RunOptions


@contextlib.contextmanager
def restored(*registries):
    """Each registry (a model registry's name -> class dict, such as
    models.base._MODELS) holds on exit what it held on entry: a test
    that registers a model or loads a plugin leaves no name behind for
    the next test of its process (the CLI's --listmodels prints them
    all)."""
    saved = [dict(r) for r in registries]
    try:
        yield
    finally:
        for reg, snap in zip(registries, saved):
            reg.clear()
            reg.update(snap)


class GaussianAct(Model):
    """The torch twin of GaussianActModel: evaluate only."""
    name = "gaussact-test"
    dt = 0.1

    def __init__(self, options=None):
        pass

    def param_defaults(self):
        return [ParamSpec(i, n, DistParams(m, 10), DistParams(m, 5))
                for i, (n, m) in enumerate(
                    [("off", 0.0), ("amp", 1.0), ("mu", 1.2),
                     ("width", 0.6)])]

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        z = (t - params[2]) / params[3]
        return params[0] + params[1] * torch.exp(-0.5 * z * z)


class DataUsing(GaussianAct):
    name = "datause-test"

    def evaluate(self, params, ctx, key=""):
        return super().evaluate(params, ctx) + 0.0 * ctx.data


class CoordsUsing(GaussianAct):
    name = "coordsuse-test"

    def evaluate(self, params, ctx, key=""):
        return super().evaluate(params, ctx) + ctx.coords[0]


class PresenceCheck(GaussianAct):
    """Takes the data branch when data is bound: the probe's sentinel is
    not None, so this branch runs in the probe, and raises."""
    name = "presence-test"

    def evaluate(self, params, ctx, key=""):
        sig = super().evaluate(params, ctx)
        return sig if ctx.data is None else sig + 0.0 * ctx.data.mean()


class UnsafeOp(GaussianAct):
    name = "unsafe-test"

    def evaluate(self, params, ctx, key=""):
        sig = super().evaluate(params, ctx)
        return torch.sort(sig).values * 0.0 + sig


class CumSum(GaussianAct):
    def evaluate(self, params, ctx, key=""):
        return torch.cumsum(super().evaluate(params, ctx), 0)


class Flip(GaussianAct):
    def evaluate(self, params, ctx, key=""):
        return torch.flip(super().evaluate(params, ctx), [0])


class SumOverTime(GaussianAct):
    def evaluate(self, params, ctx, key=""):
        sig = super().evaluate(params, ctx)
        return sig - sig.mean()


class SuppScaled(GaussianAct):
    """The torch twin of SuppScaledModel."""
    name = "suppscale-test"

    def evaluate(self, params, ctx, key=""):
        return (ctx.suppdata[0] * super().evaluate(params, ctx)
                + ctx.suppdata[1])


def stripped_exp(num=2, dt=0.05):
    """The port's exp model without its time_signal (the JAX test's
    StrippedExp)."""
    base = get_model_class("exp")

    class StrippedExp(base):
        name = "exp-stripped-test"

        @property
        def time_signal(self):
            raise AttributeError("stripped: generic evaluate only")

    return StrippedExp(RunOptions({"model": "exp", "dt": str(dt),
                                   "num-exps": str(num)}))


class StridedExp(GaussianAct):
    """exp-sum written with strided parameter slices and a sum over the
    component axis (slice, unsqueeze, sum.dim_IntList)."""

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * 0.05
        return (params[0::2, None]
                * torch.exp(-params[1::2, None] * t[None, :])).sum(0)


class KitchenSink(GaussianAct):
    """Most of the allowlist, away from its kinks."""

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device)
        tv = t * 0.1 + 0.05
        a, b, c, d = params[0], params[1], params[2], params[3]
        s = torch.sin(a * tv) + torch.cos(b * tv) * torch.tanh(c)
        s = s + torch.log1p(tv * d * d) + torch.sqrt(tv + a * a)
        s = s + torch.sigmoid(b - tv) + torch.erf(c * tv) - torch.expm1(-tv)
        s = s + torch.where(tv > 1.0, a * tv, b) + torch.maximum(a * tv, c)
        s = s + torch.clamp(d * tv, -0.5, 0.9) + torch.abs(c - 3.0)
        s = s + (a ** 2) * tv ** 3 + 2.0 ** (b * tv) + (tv + 1.0) ** c
        s = s + torch.atan2(a, tv + 1.0) + torch.rsqrt(tv + d * d)
        s = s + torch.log(tv + 2.0) / (1.0 + b * b) - 1.0 / (tv + c * c)
        s = s + torch.atan(d * tv) + torch.asinh(a) + torch.cosh(0.1 * b)
        w = torch.stack([a, b, c]).reshape(3, 1) * tv.unsqueeze(0)
        s = s + w.sum(0) + w.amax(0) + torch.cat([w, w]).mean(0)
        s = s + params.view(2, 2)[1, 0] * torch.ones(
            ctx.nt, dtype=params.dtype, device=params.device)
        return s + torch.minimum(s, torch.tensor(50.0))


class AbsAmp(GaussianAct):
    """a * |p1| * exp(-t dt): p1's prior and initial posterior mean, 0,
    is abs's kink, where jax's tangent is +1 and torch's 0 (the kink
    twins of tests/test_torch_kinks.py)."""
    name = "absamp-test"

    def param_defaults(self):
        return [ParamSpec(0, "a", DistParams(1.0, 10), DistParams(1.0, 5)),
                ParamSpec(1, "p1", DistParams(0.0, 10), DistParams(0.0, 5))]

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        return params[0] * torch.abs(params[1]) * torch.exp(-t)


class ClampOffset(GaussianAct):
    """a exp(-t dt) + clamp(c, 0, 2): c's prior and initial posterior
    mean, 0, is the clamp's lower bound, where jax's tangent is 1/2 and
    torch's 1."""
    name = "clampoff-test"

    def param_defaults(self):
        return [ParamSpec(0, "a", DistParams(1.0, 10), DistParams(1.0, 5)),
                ParamSpec(1, "c", DistParams(0.0, 10), DistParams(0.0, 5))]

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        return params[0] * torch.exp(-t) + torch.clamp(params[1], 0.0, 2.0)


class MaxTie(GaussianAct):
    """max over (a, b, b) times exp(-t dt) plus b: at a == b the three
    elements tie, and jax shares the tangent evenly (a pairwise max
    would give a 1/4 and b 3/4)."""
    name = "maxtie-test"

    def param_defaults(self):
        return [ParamSpec(0, "a", DistParams(1.0, 10), DistParams(1.0, 5)),
                ParamSpec(1, "b", DistParams(1.0, 10), DistParams(1.0, 5))]

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        top = torch.stack([params[0], params[1], params[1]]).amax(0)
        return top * torch.exp(-t) + params[1]


class AbsInPlace(AbsAmp):
    """AbsAmp with the kink taken in place (abs_ on a copy of p1): jax's
    tangent +1 at 0 once the trace is functionalized (models/kinks.py)."""
    name = "absinplace-test"

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        return params[0] * params[1].clone().abs_() * torch.exp(-t)


class ClampInPlace(ClampOffset):
    """ClampOffset with clamp_ on a copy of c: jax's tangent 1/2 at the
    lower bound."""
    name = "clampinplace-test"

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        return params[0] * torch.exp(-t) + params[1].clone().clamp_(0.0, 2.0)


class HardTanhOffset(GaussianAct):
    """a exp(-t dt) + hardtanh(c): c's prior and initial posterior mean,
    1, is hardtanh's upper bound, where jax.nn.hard_tanh's tangent is 1
    and torch's 0."""
    name = "hardtanh-test"

    def param_defaults(self):
        return [ParamSpec(0, "a", DistParams(1.0, 10), DistParams(1.0, 5)),
                ParamSpec(1, "c", DistParams(1.0, 10), DistParams(1.0, 5))]

    def evaluate(self, params, ctx, key=""):
        t = torch.arange(ctx.nt, dtype=params.dtype,
                         device=params.device) * self.dt
        return params[0] * torch.exp(-t) + torch.nn.functional.hardtanh(
            params[1])
