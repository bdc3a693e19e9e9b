"""The port's convergence detectors (inference/convergence.py) against the
JAX package's on the same per-lane free-energy sequences.

The sequences are made with numpy from a seed and hold, lane by lane,
every case the state machines branch on: steady increases, drops
(single, repeated, and runs long enough to take the lm damping to its
maximum), plateaus, and steps straddling the tolerance by a few ulp.
Each detector's `test` runs on both sides at every step, with no lane
frozen, so every transition of every state is reached; the states must
agree exactly: integer and boolean fields equal, prev_f and alpha equal
to 0 ulp. Also init_state and max_iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabber_core_tpu.inference import convergence as jconv
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch.inference import convergence as tconv
from fabber_core_tpu_torch.options import RunOptions

torch.set_num_threads(1)

NV, STEPS = 512, 48

CASES = [
    ("maxits", {}),
    ("pointzeroone", {}),
    ("pointzeroone", {"min-fchange": "0.5", "max-iterations": "20"}),
    ("freduce", {}),
    ("freduce", {"max-iterations": "30"}),
    ("trialmode", {}),
    ("trialmode", {"max-trials": "2", "max-iterations": "4"}),
    ("lm", {}),
    ("lm", {"max-fchange": "0.1", "max-iterations": "30"}),
]
IDS = [name + "".join(f"-{k}={v}" for k, v in extra.items())
       for name, extra in CASES]


def f_sequences(dtype, tol=0.01, seed=0):
    """[STEPS, NV] free-energy sequences: a rising, saturating F per
    lane with drops, plateaus and tolerance-straddling steps mixed in."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(-500.0, 500.0, NV)
    rate = rng.uniform(0.2, 0.9, NV)
    scale = rng.uniform(1.0, 50.0, NV)
    steps = scale * rate ** np.arange(STEPS)[:, None]        # [S,V]
    kind = rng.integers(0, 6, (STEPS, NV))
    steps = np.where(kind == 1, -rng.uniform(0.001, 5.0, (STEPS, NV)),
                     steps)                                   # drops
    steps = np.where(kind == 2, 0.0, steps)                   # plateaus
    near = tol * (1.0 + rng.choice([-1, 1], (STEPS, NV))
                  * rng.uniform(0, 1e-6, (STEPS, NV)))
    steps = np.where(kind == 3, near * rng.choice([-1, 1], (STEPS, NV)),
                     steps)                                   # at the tol
    # lanes with long runs of drops (lm's alpha climbs to its maximum)
    runs = rng.random(NV) < 0.15
    steps[5:25, runs] = -rng.uniform(0.01, 1.0, (20, int(runs.sum())))
    return (f0 + np.cumsum(steps, axis=0)).astype(dtype)


def both(name, extra):
    opts = {"max-iterations": "10", **extra}
    return (tconv.get_detector_class(name)(RunOptions(dict(opts))),
            jconv.get_detector_class(name)(JOptions(dict(opts))))


def assert_same(ts, js, step):
    for field in ts._fields:
        t = getattr(ts, field).numpy()
        j = np.asarray(getattr(js, field))
        assert t.dtype == j.dtype, (field, t.dtype, j.dtype)
        np.testing.assert_array_equal(t, j, err_msg=f"{field} at {step}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,extra", CASES, ids=IDS)
def test_detector_lanes_match_jax(name, extra, dtype):
    td, jd = both(name, extra)
    tol = float(extra.get("min-fchange", extra.get("max-fchange", 0.01)))
    fs = f_sequences(dtype, tol)
    ts = td.init_state(NV, torch.float64 if dtype == np.float64
                       else torch.float32)
    js = jd.init_state(NV, jnp.float64 if dtype == np.float64
                       else jnp.float32)
    assert_same(ts, js, "init")
    seen_done = seen_revert = 0
    for k in range(STEPS):
        ts = td.test(ts, torch.from_numpy(fs[k]))
        js = jd.test(js, jnp.asarray(fs[k]))
        assert_same(ts, js, k)
        seen_done += int(ts.done.sum())
        seen_revert += int(ts.revert.sum())
    # the sequences do reach the branches that stop and revert
    assert seen_done > 0
    if name in ("freduce", "trialmode", "lm"):
        assert seen_revert > 0
    if name == "lm":
        assert float(ts.alpha.max()) >= td.ALPHA_MAX


@pytest.mark.parametrize("name,extra", CASES, ids=IDS)
def test_detector_options_and_bounds_match_jax(name, extra):
    td, jd = both(name, extra)
    assert td.max_iterations == jd.max_iterations
    assert td.uses_f == jd.uses_f and td.tracks_best == jd.tracks_best
    assert ({o.name: o.default for o in td.get_options()}
            == {o.name: o.default for o in jd.get_options()})
    for attr in ("max_its", "min_fchange", "max_fchange", "max_trials"):
        assert getattr(td, attr, None) == getattr(jd, attr, None)


@pytest.mark.parametrize("name,opt", [("pointzeroone", "min-fchange"),
                                      ("lm", "max-fchange")])
def test_nonpositive_tolerance_is_refused(name, opt):
    from fabber_core_tpu_torch.exceptions import InvalidOptionValue
    with pytest.raises(InvalidOptionValue):
        tconv.get_detector_class(name)(RunOptions({opt: "0"}))


@pytest.mark.parametrize("name,extra", CASES, ids=IDS)
def test_jax_state_carried_mid_sequence_continues_alike(name, extra):
    """A JAX ConvState carried into the port mid-sequence
    (convert.conv_state_from_numpy) continues exactly as the JAX one."""
    from fabber_core_tpu_torch.convert import conv_state_from_numpy
    td, jd = both(name, extra)
    fs = f_sequences(np.float32, seed=1)
    js = jd.init_state(NV, jnp.float32)
    for k in range(STEPS // 2):
        js = jd.test(js, jnp.asarray(fs[k]))
    ts = conv_state_from_numpy(js)
    assert_same(ts, js, "carried")
    for k in range(STEPS // 2, STEPS):
        ts = td.test(ts, torch.from_numpy(fs[k]))
        js = jd.test(js, jnp.asarray(fs[k]))
        assert_same(ts, js, k)
