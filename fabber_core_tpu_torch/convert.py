"""Carry per-run state between the JAX package and this port.

The system has no trained weights; what crosses over is per-run state:
the fixed-design sufficient statistics, the posterior (and the best
state the detectors keep, a posterior too), the noise state, the
convergence detectors' lane state, the whole-loop kernels' constant
vectors, NLLS's optimizer state and fixed-design statistics, and the
AR(1) noise model's state and statistics. Inputs are
anything numpy can read (JAX arrays included, through np.asarray, so
this module never imports jax); outputs are the port's tensors, and
to_numpy goes back the other way.
"""

import numpy as np
import torch

from .inference.convergence import ConvState
from .inference.nlls import NLLSState, NLLSStats
from .inference.vb import PosteriorState, VBResult
from .noise.ar1 import Ar1DesignStats, Ar1NoiseState
from .noise.white import DesignStats, WhiteNoiseState


def _tensor(x, device, dtype):
    # np.array copies: arrays exported by JAX are read-only
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def design_stats_from_numpy(stats, device="cpu", dtype=None):
    """The port's DesignStats from the JAX package's (any number of
    noise groups: m0 [P,V], rtqr [Q,V], dtqr [Q,P,V], dtqd [Q,P,P]), its
    Ar1DesignStats from the JAX AR(1) noise model's (m0 [P,V], rmr
    [S,V], dmr [S,P,V], dmd [S,P,P]), or the single-group statistics
    kernels' outputs (m0 [P,V], rtqr [1,V], dtqr [P,V]) -> that tuple of
    tensors."""
    for cls in (DesignStats, Ar1DesignStats):
        if hasattr(stats, cls._fields[-1]):
            return cls(*(_tensor(getattr(stats, f), device, dtype)
                         for f in cls._fields))
    m0, rtqr, dtqr = (np.asarray(x) for x in stats)
    p, nv = m0.shape
    return tuple(_tensor(x, device, dtype)
                 for x in (m0, rtqr.reshape(1, nv), dtqr.reshape(p, nv)))


def noise_state_from_numpy(state, device="cpu", dtype=None):
    """The port's noise state from the JAX package's: WhiteNoiseState
    (.b, .c [Q,V] or [Q,1]) or Ar1NoiseState (alpha_means [A,V],
    alpha_cov/alpha_prec [A,A,V], b/c [Q,V]; the prior's voxel axis a
    singleton)."""
    cls = Ar1NoiseState if hasattr(state, "alpha_means") \
        else WhiteNoiseState
    return cls(*(_tensor(getattr(state, f), device, dtype)
                 for f in cls._fields))


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


def ar_consts_from_numpy(consts):
    """The port's float64 host vector (ops/fused_loop_ar.py
    pack_ar_consts) from the JAX AR(1) kernel's [K*ROWS,1] constant
    column, each value replicated on ROWS = 8 sublanes."""
    return torch.as_tensor(np.asarray(consts, np.float64)[::8, 0].copy())


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
    [P,P,V], prior_means/prior_prec [P,V] or [P,1], a white or AR(1)
    noise state) -> the port's PosteriorState of tensors; or a JAX VBResult
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
    (PosteriorState, WhiteNoiseState, Ar1NoiseState, VBResult,
    NLLSState, statistics tuples)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple):
        vals = [to_numpy(x) for x in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj
