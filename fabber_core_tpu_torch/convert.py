"""Carry per-run state between the JAX package and this port.

The system has no trained weights; what crosses over is per-run state:
the fixed-design sufficient statistics, the posterior (and the best
state the detectors keep, a posterior too), the noise state, the
convergence detectors' lane state, the whole-loop kernel's constant
vector, and NLLS's optimizer state and fixed-design statistics. Inputs are
anything numpy can read (JAX arrays included, through np.asarray, so
this module never imports jax); outputs are the port's tensors, and
to_numpy goes back the other way.
"""

import numpy as np
import torch

from .inference.convergence import ConvState
from .inference.nlls import NLLSState, NLLSStats
from .inference.vb import PosteriorState, VBResult
from .noise.white import DesignStats, WhiteNoiseState


def _tensor(x, device, dtype):
    # np.array copies: arrays exported by JAX are read-only
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def design_stats_from_numpy(stats, device="cpu", dtype=None):
    """The port's DesignStats from the JAX package's (any number of
    noise groups: m0 [P,V], rtqr [Q,V], dtqr [Q,P,V], dtqd [Q,P,P]), or
    the single-group statistics kernels' outputs (m0 [P,V], rtqr [1,V],
    dtqr [P,V]) -> that tuple of tensors."""
    if hasattr(stats, "dtqd"):
        return DesignStats(*(_tensor(getattr(stats, f), device, dtype)
                             for f in DesignStats._fields))
    m0, rtqr, dtqr = (np.asarray(x) for x in stats)
    p, nv = m0.shape
    return tuple(_tensor(x, device, dtype)
                 for x in (m0, rtqr.reshape(1, nv), dtqr.reshape(p, nv)))


def noise_state_from_numpy(state, device="cpu", dtype=None):
    """The port's WhiteNoiseState from the JAX package's (.b, .c
    [Q,V] or [Q,1])."""
    return WhiteNoiseState(_tensor(state.b, device, dtype),
                           _tensor(state.c, device, dtype))


def conv_state_from_numpy(state, device="cpu"):
    """The port's ConvState from the JAX package's (its [V] lanes: int32
    counts, bool flags, prev_f and alpha in their float dtype)."""
    return ConvState(*(torch.as_tensor(np.array(getattr(state, f)),
                                       device=device)
                       for f in ConvState._fields))


def nl_consts_from_numpy(consts):
    """The port's [4Q] float64 host vector (ops/fused_loop_nl.py
    pack_nl_consts) from the JAX kernel's [4Q,1] constant column."""
    return torch.as_tensor(np.asarray(consts, np.float64).reshape(-1))


def nlls_state_from_numpy(state, device="cpu", dtype=None):
    """The port's NLLSState from the JAX package's (params [P,V], cost,
    lam [V] in dtype, done [V] bool, its [V] int32; its scalar `it` is
    the loop's counter, which the port keeps outside the state)."""
    def t(name, dt):
        return torch.as_tensor(np.array(getattr(state, name)), dtype=dt,
                               device=device)
    return NLLSState(t("params", dtype), t("cost", dtype), t("lam", dtype),
                     t("done", torch.bool), t("its", torch.int32))


def nlls_stats_from_numpy(stats, device="cpu", dtype=None):
    """The port's NLLSStats from the JAX package's (m0 [P,V], rtr [V],
    dtr [P,V], dtd [P,P])."""
    return NLLSStats(*(_tensor(getattr(stats, f), device, dtype)
                       for f in NLLSStats._fields))


def posterior_from_numpy(state, device="cpu", dtype=None):
    """The port's posterior from the JAX package's.

    state: a JAX PosteriorState (SoA planes: means [P,V], prec/cov
    [P,P,V], prior_means/prior_prec [P,V] or [P,1], noise with .b/.c
    [Q,V]) -> the port's PosteriorState of tensors; or a JAX VBResult
    (voxel-major numpy arrays) -> the port's VBResult."""
    if hasattr(state, "noise_means"):
        return VBResult(**{f: (None if getattr(state, f, None) is None
                               else np.asarray(getattr(state, f)))
                           for f in VBResult._fields})

    def t(x):
        return _tensor(x, device, dtype)

    noise = noise_state_from_numpy(state.noise, device, dtype)
    return PosteriorState(t(state.means), t(state.prec), t(state.cov),
                          t(state.prior_means), t(state.prior_prec), noise)


def to_numpy(obj):
    """Tensors -> numpy arrays, through tuples and NamedTuples
    (PosteriorState, WhiteNoiseState, VBResult, NLLSState, statistics
    tuples)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple):
        vals = [to_numpy(x) for x in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj
