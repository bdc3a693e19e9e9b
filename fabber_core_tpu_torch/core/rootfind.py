"""1-D root-finding toolkit.

Port of fabber_core_tpu/core/rootfind.py (pure Python, kept as its own
copy: the port imports nothing of the JAX package). Capability parity
with the reference's legacy zero-finding utilities
(tools.h:38-338: GenericFunction1D, the Guesstimator family and
DescendingZeroFinder), used historically for spatial-VB delta
optimization and kept available for model plugins. Host-side plain
Python (these run on scalars during setup, not in the hot loop).

Usage:
    finder = DescendingZeroFinder(f, guess=1.0, scale=10.0,
                                  guesstimator="riddlers", tol_y=1e-6)
    root = finder.find_zero()

Why this stays despite having no engine caller: the reference ships the
same toolkit unused (tools.h:38-338 — its last caller was the removed
full-covariance spatial delta optimization), and downstream model
plugins use it for scalar setup math. Parity of the plugin-facing
surface, deliberately kept; tests/test_torch_motion_noprior.py holds it
to the JAX package's copy.
"""

import math

REALMAX = 1.7976931348623158e+308


def bisection_guess(lower, upper, at_lower, at_upper):
    return 0.5 * (lower + upper)


def log_bisection_guess(lower, upper, at_lower, at_upper):
    assert lower > 0 and upper > lower
    return math.sqrt(lower * upper)


def interp_guess(lower, upper, at_lower, at_upper):
    """Linear interpolation (false position)."""
    return upper - at_upper * (upper - lower) / (at_upper - at_lower)


class RiddlersGuess:
    """Ridders' method (NRiC 9.2): alternates a midpoint probe with the
    exponential-correction step. Stateful across calls, like the
    reference's two-phase implementation."""

    def __init__(self, log_space=False):
        self.half_done = False
        self.x1 = self.x2 = self.fx1 = self.fx2 = 0.0
        self.log_space = log_space

    def __call__(self, lower, upper, at_lower, at_upper):
        if self.log_space:
            lower, upper = math.log(lower), math.log(upper)
        if not self.half_done:
            # phase 1: request the midpoint
            self.x1, self.x2 = lower, upper
            self.fx1, self.fx2 = at_lower, at_upper
            self.half_done = True
            guess = 0.5 * (lower + upper)
        else:
            # phase 2: one of (lower,upper) is the midpoint x3
            self.half_done = False
            if lower not in (self.x1, self.x2):
                x3, fx3 = lower, at_lower
            else:
                x3, fx3 = upper, at_upper
            s = math.sqrt(fx3 * fx3 - self.fx1 * self.fx2)
            if s == 0:
                guess = x3
            else:
                sign = 1.0 if self.fx1 >= self.fx2 else -1.0
                x4 = x3 + (x3 - self.x1) * sign * fx3 / s
                guess = min(max(x4, min(lower, upper)), max(lower, upper))
        if self.log_space:
            guess = math.exp(guess)
        return guess


_GUESSTIMATORS = {
    "bisection": lambda: bisection_guess,
    "logbisection": lambda: log_bisection_guess,
    "interp": lambda: interp_guess,
    "riddlers": lambda: RiddlersGuess(),
    "logriddlers": lambda: RiddlersGuess(log_space=True),
}


class DescendingZeroFinder:
    """Finds x where f(x) = 0 for a function that descends through
    zero (f > 0 below the root, f < 0 above it).

    Mirrors the searchMin/Max/Guess/Scale/ScaleGrowth bracketing and
    the tolX/tolY/ratio stopping rules of the reference
    (tools.h:241-338).
    """

    def __init__(self, fcn, search_min=-REALMAX, search_max=REALMAX,
                 guess=0.0, scale=REALMAX, scale_growth=2.0,
                 max_evaluations=1_000_000, tol_x=REALMAX, tol_y=REALMAX,
                 ratio_tol_x=REALMAX, ratio_tol_y=REALMAX,
                 guesstimator="bisection"):
        self.fcn = fcn
        self.search_min = search_min
        self.search_max = search_max
        self.guess = guess
        self.scale = scale
        self.scale_growth = scale_growth
        self.max_evaluations = max_evaluations
        self.tol_x = tol_x
        self.tol_y = tol_y
        self.ratio_tol_x = ratio_tol_x
        self.ratio_tol_y = ratio_tol_y
        if isinstance(guesstimator, str):
            guesstimator = _GUESSTIMATORS[guesstimator]()
        self.guesstimator = guesstimator

    def find_zero(self):
        f = self.fcn
        evals = [0]

        def call(x):
            evals[0] += 1
            if evals[0] > self.max_evaluations:
                raise RuntimeError("DescendingZeroFinder: too many evaluations")
            return f(x)

        # Bracket the root, expanding outwards from the guess by scale
        lower = max(self.search_min, self.guess - min(self.scale, REALMAX / 4))
        upper = min(self.search_max, self.guess + min(self.scale, REALMAX / 4))
        at_lower, at_upper = call(lower), call(upper)
        scale = self.scale
        while at_lower < 0 and lower > self.search_min:
            scale *= self.scale_growth
            lower = max(self.search_min, lower - scale)
            at_lower = call(lower)
        while at_upper > 0 and upper < self.search_max:
            scale *= self.scale_growth
            upper = min(self.search_max, upper + scale)
            at_upper = call(upper)

        if at_lower < 0:
            return lower  # no root in range: clamp at boundary
        if at_upper > 0:
            return upper

        # Narrow the bracket (a tolerance of REALMAX means 'unset')
        while True:
            if self.tol_x < REALMAX and upper - lower <= self.tol_x:
                break
            if self.ratio_tol_x < REALMAX and lower != 0 \
                    and upper / lower <= self.ratio_tol_x:
                break
            guess = self.guesstimator(lower, upper, at_lower, at_upper)
            if not (lower < guess < upper):
                guess = 0.5 * (lower + upper)
            at_guess = call(guess)
            if self.tol_y < REALMAX and abs(at_guess) <= self.tol_y:
                return guess
            if self.ratio_tol_y < REALMAX and at_upper != 0 \
                    and abs(at_lower / at_upper) <= self.ratio_tol_y:
                break
            if at_guess >= 0:
                lower, at_lower = guess, at_guess
            else:
                upper, at_upper = guess, at_guess

        # Return the endpoint closer to zero in f
        return lower if abs(at_lower) <= abs(at_upper) else upper
