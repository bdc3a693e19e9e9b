"""Convergence detectors as batched per-voxel lane state machines.

Port of fabber_core_tpu/inference/convergence.py. Every voxel carries
its detector state in [V] tensors. The ported route runs the maxits
detector (convergence.cc:43-55), whose fixed trip count the core
kernel runs in-register. The four F-based detectors are registered
under their names so that option parsing finds them, but constructing
one raises NotImplementedError until ROADMAP Queue 1 item 11 ports
their state machines (and the core kernel's detector mode).
"""

from typing import NamedTuple

import torch

from ..exceptions import InvalidOptionValue
from ..options import OptionSpec, OPT_INT


class ConvState(NamedTuple):
    its: torch.Tensor        # [V] int32
    prev_f: torch.Tensor     # [V]
    save: torch.Tensor       # [V] bool — current params are best so far
    revert: torch.Tensor     # [V] bool — revert to saved params at end
    done: torch.Tensor       # [V] bool — lane converged/frozen
    trials: torch.Tensor     # [V] int32 (trialmode)
    trialmode: torch.Tensor  # [V] bool (trialmode)
    lm_on: torch.Tensor      # [V] bool (lm)
    alpha: torch.Tensor      # [V] LM damping factor


class ConvergenceDetector:
    name = None
    uses_f = False
    # Whether the VB loop must keep a best-so-far state copy for this
    # detector's save/revert protocol.
    tracks_best = False

    def __init__(self, options):
        pass

    @classmethod
    def get_options(cls):
        return [OptionSpec("max-iterations", OPT_INT,
                           "Maximum iterations", default="10")]

    def init_state(self, nvoxels, dtype, init_save=False, device="cpu"):
        def full(val, dt):
            return torch.full((nvoxels,), val, dtype=dt, device=device)

        return ConvState(
            its=full(0, torch.int32),
            # reference sentinel is -99e99 (convergence.h); clamp to the
            # dtype's finite range so float32 doesn't overflow to -inf
            prev_f=full(max(-99e99, float(torch.finfo(dtype).min)), dtype),
            save=full(init_save, torch.bool),
            revert=full(False, torch.bool),
            done=full(False, torch.bool),
            trials=full(0, torch.int32),
            trialmode=full(False, torch.bool),
            lm_on=full(False, torch.bool),
            alpha=full(0.0, dtype),
        )

    def test(self, state, f):
        raise NotImplementedError

    @property
    def max_iterations(self):
        """Static upper bound on iterations, for the engine's loop cap."""
        raise NotImplementedError


_DETECTORS = {}


def register_detector(cls):
    _DETECTORS[cls.name] = cls
    return cls


def get_detector_class(name):
    try:
        return _DETECTORS[name]
    except KeyError:
        raise InvalidOptionValue("convergence", name,
                                 "Unrecognized convergence detector")


def known_detectors():
    return sorted(_DETECTORS)


@register_detector
class CountingDetector(ConvergenceDetector):
    """Fixed number of iterations."""
    name = "maxits"

    def __init__(self, options):
        self.max_its = options.get_int("max-iterations", 10, minval=1)

    @property
    def max_iterations(self):
        return self.max_its

    def test(self, state, f):
        its = state.its + 1
        return state._replace(its=its, done=its >= self.max_its)


class _UnportedDetector(ConvergenceDetector):
    """An F-based detector of the JAX package not yet ported."""
    uses_f = True

    def __init__(self, options):
        raise NotImplementedError(
            f"convergence detector '{self.name}' is not ported to "
            "fabber_core_tpu_torch yet (ROADMAP Queue 1 item 11)")


@register_detector
class FchangeDetector(_UnportedDetector):
    """Stop when |dF| < min-fchange (a.k.a. 'pointzeroone')."""
    name = "pointzeroone"


@register_detector
class FreduceDetector(_UnportedDetector):
    """Like fchange, but also stop (and revert) if F decreased."""
    name = "freduce"


@register_detector
class TrialModeDetector(_UnportedDetector):
    """Allow up to max-trials iterations for F to recover after a drop."""
    name = "trialmode"


@register_detector
class LMDetector(_UnportedDetector):
    """Levenberg-Marquardt-style damping control on F decreases."""
    name = "lm"
