"""Model self-test harness: phantom generation + inversion round trip.

Port of fabber_core_tpu/selftest.py, with the same numpy RNG use (one
seed gives the same phantom in both packages) and a device for every
FabberTpu it builds (default "cuda": the phantom's curves and the
inversion run on the card; nothing falls back to the CPU). Capability
parity with the reference Python harness (py/fabber.py:41-176):
``generate_test_data`` evaluates the model over a grid of parameter
values in patch blocks and adds Gaussian noise;
``self_test`` inverts the phantom with VB and compares ROI-mean
recovered values (and the noise std) against the ground truth. Used by
per-model regression tests and available to plugin authors.
"""

import math

import numpy as np

from .api import FabberTpu


def _to_value_seq(values):
    try:
        return [float(values)]
    except (TypeError, ValueError):
        return list(values)


def generate_test_data(options, param_testvalues, nt=10, patchsize=10,
                       noise=None, param_rois=False, seed=None,
                       device="cuda"):
    """Build a phantom volume over a grid of parameter values.

    Each varying parameter spans one spatial dimension (up to 3);
    every grid cell is a patchsize^3 block with that parameter
    combination. Returns (noisy_data, clean_data[, roi dict]).
    """
    rng = np.random.default_rng(seed)
    fab = FabberTpu(device=device)

    dim_params, dim_values, dim_sizes = [], [], []
    fixed = {}
    for param, values in param_testvalues.items():
        values = _to_value_seq(values)
        if len(values) == 1:
            fixed[param] = values[0]
        else:
            dim_params.append(param)
            dim_values.append(values)
            dim_sizes.append(len(values))
    if len(dim_sizes) > 3:
        raise RuntimeError(
            f"Test image can only have up to 3 dimensions, you supplied "
            f"{len(dim_sizes)} varying parameters")
    while len(dim_sizes) < 3:
        dim_params.append(None)
        dim_values.append([])
        dim_sizes.append(1)

    shape = [d * patchsize for d in dim_sizes]
    data = np.zeros(shape + [nt])
    rois = {p: np.zeros(shape) for p in dim_params if p is not None}

    for x in range(dim_sizes[0]):
        for y in range(dim_sizes[1]):
            for z in range(dim_sizes[2]):
                pos = [x, y, z]
                for idx, param in enumerate(dim_params):
                    if param is not None:
                        fixed[param] = dim_values[idx][pos[idx]]
                        rois[param][
                            x * patchsize:(x + 1) * patchsize,
                            y * patchsize:(y + 1) * patchsize,
                            z * patchsize:(z + 1) * patchsize] = pos[idx] + 1
                curve = fab.model_evaluate(options, fixed, nt)
                data[x * patchsize:(x + 1) * patchsize,
                     y * patchsize:(y + 1) * patchsize,
                     z * patchsize:(z + 1) * patchsize, :] = curve

    noisy = data
    if noise is not None:
        noisy = data + rng.normal(0, noise, data.shape)

    if param_rois:
        return noisy, data, rois
    return noisy, data


def self_test(model, options, param_testvalues, nt=10, patchsize=10,
              noise=None, invert=True, disp=False, seed=None, device="cuda",
              **kwargs):
    """Generate a phantom for ``model``, invert it, and report
    input-vs-recovered values per ROI. Returns (results dict, log)."""
    options = dict(options)
    options["model"] = model
    data, clean, rois = generate_test_data(
        options, param_testvalues, nt=nt, patchsize=patchsize, noise=noise,
        param_rois=True, seed=seed, device=device)

    ret = {}
    log = None
    if invert:
        rundata = dict(options)
        rundata.setdefault("method", "vb")
        rundata.setdefault("noise", "white")
        rundata["save-mean"] = True
        rundata["save-noise-mean"] = True
        rundata["save-noise-std"] = True
        rundata["save-model-fit"] = True
        rundata["allow-bad-voxels"] = True
        fab = FabberTpu(device=device)
        run = fab.run_with_data(rundata, {"data": data})
        log = run.log

        for param, values in param_testvalues.items():
            values = _to_value_seq(values)
            if len(values) <= 1:
                continue
            mean = run.data[f"mean_{param}"]
            roi = rois.get(param, np.ones(mean.shape))
            ret[param] = {}
            for idx, val in enumerate(values):
                out = float(np.mean(mean[roi == idx + 1]))
                if disp:
                    print(f"{param}: Input {val:f} -> {out:f} Output")
                ret[param][val] = out

        noise_in = noise or 0.0
        noise_out = 1.0 / math.sqrt(float(np.mean(run.data["noise_means"])))
        if disp:
            print(f"Noise: Input {noise_in:f} -> {noise_out:f} Output")
        ret["noise"] = {noise_in: noise_out}
    return ret, log
