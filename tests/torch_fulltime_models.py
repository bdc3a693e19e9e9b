"""Torch models that mix the time axis, for the whole-loop kernel's
full-time form (csrc/fused_nl_loop.cuh fused_nl_loop_full_kernel, a
functor of models/kernelgen.py's full-time walk): a plugin file
(`--loadmodels=tests/torch_fulltime_models.py`) that tests/
test_torch_fulltime.py and chip_smoke.py load. No jax here: chip_smoke.py
loads it on the card machine. Each is evaluate-only, with log-transformed
parameters (exp's priors: N(1, 1e5) in model space, the posterior
starting at N(1, 1.5)), sampled every DT:

  biexp-centred-test   a baseline-centred biexponential, s - mean(s),
                       s = a1 exp(-r1 t) + a2 exp(-r2 t) (P = 4): a sum
                       over time;
  conv-test            a Tofts-like convolution, L @ (Ktrans exp(-kep t))
                       (P = 2), L the constant lower-triangular [T,T]
                       matrix dt aif((t - s) dt), aif a gamma-variate
                       arterial input: a contraction of time with a
                       constant matrix the model closes over;
  suppconv-test        conv-test scaled and offset per voxel by two
                       suppdata values;
  shift-test           a exp(-r t) delayed by SHIFT samples (P = 2),
                       written as a slice and a concatenation;

conviota-test (conv-test with its matrix built from the sample index, the
form the JAX kernel can run), and the signals' numpy and torch forms
(signal, signal_torch), which make the tests' and chip_smoke.py's
data."""

import numpy as np
import torch

from fabber_core_tpu_torch.core.transforms import TRANSFORM_LOG
from fabber_core_tpu_torch.models.base import (DistParams, Model, ParamSpec,
                                               register_model)

DT = 0.05
SHIFT = 3


def aif(tv):
    """A gamma-variate arterial input at times tv (peak 1 at 0.5)."""
    x = np.maximum(tv, 0.0) / 0.5
    return x * np.exp(1.0 - x)


def conv_matrix(nt, dtype=np.float32):
    """The [T,T] lower-triangular matrix dt aif((t - s) dt), s <= t."""
    k = np.arange(nt)
    lag = (k[:, None] - k[None, :]) * DT
    return np.where(lag >= 0, DT * aif(lag), 0.0).astype(dtype)


# conv-test's matrices, made here, outside any trace (a tensor made while
# make_fx traces evaluate would be a fake one), at the T of the tests and
# of chip_smoke.py
CONV_NTS = (30, 100, 400, 1000)
_L = {nt: torch.as_tensor(conv_matrix(nt)) for nt in CONV_NTS}


def conv_constant(nt):
    """conv_matrix(nt) as the float32 tensor conv-test closes over."""
    if nt not in _L:
        raise ValueError(f"conv-test is made for T in {CONV_NTS}, not {nt}")
    return _L[nt]


def _params(names):
    return [ParamSpec(i, n, DistParams(1, 1e5), DistParams(1, 1.5),
                      transform=TRANSFORM_LOG) for i, n in enumerate(names)]


def _time(params, ctx):
    return torch.arange(ctx.nt, dtype=params.dtype,
                        device=params.device) * DT


@register_model
class CentredBiexp(Model):
    name = "biexp-centred-test"

    def __init__(self, options=None):
        pass

    def param_defaults(self):
        return _params(["amp1", "r1", "amp2", "r2"])

    def evaluate(self, params, ctx, key=""):
        t = _time(params, ctx)
        s = (params[0] * torch.exp(-params[1] * t)
             + params[2] * torch.exp(-params[3] * t))
        return s - s.mean()


@register_model
class ToftsConv(Model):
    name = "conv-test"

    def __init__(self, options=None):
        pass

    def param_defaults(self):
        return _params(["ktrans", "kep"])

    def evaluate(self, params, ctx, key=""):
        t = _time(params, ctx)
        lmat = conv_constant(ctx.nt).to(params.device, params.dtype)
        return lmat @ (params[0] * torch.exp(-params[1] * t))


@register_model
class SuppConv(ToftsConv):
    name = "suppconv-test"

    def evaluate(self, params, ctx, key=""):
        return ctx.suppdata[0] * super().evaluate(params, ctx) \
            + ctx.suppdata[1]


@register_model
class Shifted(Model):
    name = "shift-test"

    def __init__(self, options=None):
        pass

    def param_defaults(self):
        return _params(["amp", "r"])

    def evaluate(self, params, ctx, key=""):
        s = params[0] * torch.exp(-params[1] * _time(params, ctx))
        return torch.cat([torch.zeros(SHIFT, dtype=s.dtype,
                                      device=s.device), s[:ctx.nt - SHIFT]])


def signal(name, m, nt, supp=None):
    """The model's signal [T,V] at model-space parameters m [P,V] (numpy,
    float64), scaled and offset by suppdata supp [2,V] where given."""
    t = np.arange(nt)[:, None] * DT
    if name == "biexp-centred-test":
        s = m[0] * np.exp(-m[1] * t) + m[2] * np.exp(-m[3] * t)
        s = s - s.mean(0)
    elif name in ("conv-test", "conviota-test", "suppconv-test"):
        s = conv_matrix(nt, np.float64) @ (m[0] * np.exp(-m[1] * t))
    else:
        s = m[0] * np.exp(-m[1] * t)
        s = np.concatenate([np.zeros((SHIFT, s.shape[1])), s[:nt - SHIFT]])
    return s if supp is None else supp[0] * s + supp[1]


@register_model
class ToftsConvIota(ToftsConv):
    """conv-test with its matrix built inside evaluate from the sample
    index (the form whose JAX twin its TPU kernel can run: a Pallas kernel
    takes no constant it closes over)."""
    name = "conviota-test"

    def evaluate(self, params, ctx, key=""):
        k = torch.arange(ctx.nt, dtype=params.dtype, device=params.device)
        lag = (k[:, None] - k[None, :]) * DT
        x = torch.clamp(lag, min=0.0) / 0.5
        lmat = torch.where(lag >= 0, DT * x * torch.exp(1.0 - x),
                           torch.zeros_like(lag))
        return lmat @ (params[0] * torch.exp(-params[1] * k * DT))


def signal_torch(name, m, nt):
    """signal's torch form on m's device (m [P,V], float32): the data of
    chip_smoke.py's phases 3l, 4ab and 5l, made on the card."""
    t = torch.arange(nt, dtype=m.dtype, device=m.device)[:, None] * DT
    if name == "biexp-centred-test":
        s = m[0] * torch.exp(-m[1] * t) + m[2] * torch.exp(-m[3] * t)
        return s - s.mean(0)
    if name in ("conv-test", "conviota-test"):
        return conv_constant(nt).to(m.device) @ (m[0] * torch.exp(-m[1] * t))
    s = m[0] * torch.exp(-m[1] * t)
    return torch.cat([torch.zeros(SHIFT, s.shape[1], dtype=s.dtype,
                                  device=s.device), s[:nt - SHIFT]])
