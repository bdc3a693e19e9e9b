"""The port's native C API (fabber_core_tpu_torch/capi/: the shim
fabber_capi_torch.cc over capi_backend.py) on the CPU, against the JAX
package's C API and Python API.

The port's shim is built here with the system's C++ compiler
(capi.build), the JAX package's with its own Makefile in a scratch
copy of capi/ (so this file and tests/test_capi.py never write one
library at once); both are loaded by ctypes into this one process, each
with its own handle. Runs set device=cpu; with no device option the
port's C API runs on the card, and here, without one, fails.

Tolerances: the C ABI hands out float32. The runs themselves are held
at float64 to 1e-9 of each output's largest magnitude (the oracle level
of the statistics route, tests/test_torch_stats_engine.py), before any
cast, through each package's runner.run, which is what each backend's
dorun calls; across the C boundary the same bound is taken through the
float32 cast (1e-9 of the output's max plus one float32 spacing of the
value). The port's C API equals the port's run_with_data bit for bit.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fabber_core_tpu import runner as jrunner
from fabber_core_tpu.api import FabberTpu as JFabber
from fabber_core_tpu.models import base as jbase
from fabber_core_tpu.core.volume import (VolumeGeometry as JGeometry,
                                         VoxelDataStore as JStore)
from fabber_core_tpu.options import RunOptions as JOptions
from fabber_core_tpu_torch import capi, runner as trunner
from fabber_core_tpu_torch.api import FabberTpu
from fabber_core_tpu_torch.core.volume import VolumeGeometry, VoxelDataStore
from fabber_core_tpu_torch.models import base as tbase
from fabber_core_tpu_torch.options import RunOptions

from torch_generic_models import restored

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPE, NT = (4, 3, 2), 20
PLUGIN = ROOT / "fabber_core_tpu_torch" / "examples" / "fwdmodel_exp.py"
SAVE = {"save-mean": True, "save-std": True, "save-noise-mean": True,
        "save-free-energy": True, "save-mvn": True, "save-model-fit": True}


@pytest.fixture(scope="module")
def port_lib():
    return capi.load()


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's shim, built by capi/Makefile in a scratch copy."""
    d = tmp_path_factory.mktemp("jax_capi")
    for name in ("Makefile", "fabber_capi_tpu.cc"):
        shutil.copy(ROOT / "capi" / name, d / name)
    subprocess.run(["make", "-C", str(d), "libfabber_core_tpu.so"],
                   check=True, capture_output=True)
    return capi.bind(d / "libfabber_core_tpu.so")


def phantom(design, seed=0):
    rng = np.random.default_rng(seed)
    nv = int(np.prod(SHAPE))
    truth = rng.uniform(-1, 1, (design.shape[1], nv))
    data = (design @ truth).T + 0.1 * rng.standard_normal((nv, NT))
    return data.reshape(SHAPE + (NT,), order="F").astype(np.float32)


def poly_case(tmp_path):
    t = np.arange(1, NT + 1, dtype=np.float64)
    design = np.stack([np.ones(NT), t / NT, (t / NT) ** 2], 1)
    return {"model": "poly", "degree": "2"}, phantom(design)


def linear_case(tmp_path):
    rng = np.random.default_rng(5)
    design = np.concatenate([np.ones((NT, 1)), rng.normal(size=(NT, 3))], 1)
    basis = tmp_path / "basis.mat"
    np.savetxt(basis, design)
    return {"model": "linear", "basis": str(basis)}, phantom(design, seed=1)


def mask_volume():
    mask = np.ones(SHAPE, np.int32)
    mask[0, 0, 0] = 0
    return mask


def call(fn, *args):
    """(return code, error text) of a C API call taking err_buf last."""
    err = ctypes.create_string_buffer(256)
    return fn(*args, err), err.value.decode()


def new(lib):
    err = ctypes.create_string_buffer(256)
    fab = lib.fabber_new(err)
    assert fab, err.value
    return fab


def configure(lib, fab, vol, options, mask=None):
    """set_extent, set_opt and set_data of a [nx,ny,nz,T] volume."""
    nx, ny, nz, nt = vol.shape
    mptr = None
    if mask is not None:
        mask = np.ascontiguousarray(mask.astype(np.int32).flatten(order="F"))
        mptr = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    assert call(lib.fabber_set_extent, fab, nx, ny, nz, mptr) == (0, "")
    for key, value in options.items():
        value = "" if value is True else str(value)
        rc, err = call(lib.fabber_set_opt, fab, key.encode(), value.encode())
        assert rc == 0, err
    flat = np.ascontiguousarray(vol.flatten(order="F"), np.float32)
    assert call(lib.fabber_set_data, fab, b"data", nt,
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) == \
        (0, "")


def get(lib, fab, name, shape=SHAPE):
    """fabber_get_data as a volume shaped as run_with_data's output."""
    size, err = call(lib.fabber_get_data_size, fab, name.encode())
    assert size > 0, err
    buf = np.zeros(int(np.prod(shape)) * size, np.float32)
    assert call(lib.fabber_get_data, fab, name.encode(),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) == (0, "")
    vol = buf.reshape(tuple(shape) + (size,), order="F")
    return vol[..., 0] if size == 1 else vol


def capi_run(lib, vol, options, names, mask=None):
    """One run through the C API: ({name: volume}, log)."""
    fab = new(lib)
    try:
        configure(lib, fab, vol, options, mask)
        log = ctypes.create_string_buffer(1 << 20)
        rc, err = call(lambda *a: lib.fabber_dorun(fab, 1 << 20, log,
                                                   a[-1], None))
        assert rc == 0, err
        return {n: get(lib, fab, n) for n in names}, log.value.decode()
    finally:
        lib.fabber_destroy(fab)


def assert_f32_image(got, ref, rtol=1e-9, what=""):
    """got and ref, float32 casts of float64 values within rtol of ref's
    largest magnitude: at most that plus one float32 spacing apart."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    room = rtol * np.abs(ref).max() + np.spacing(
        np.maximum(np.abs(got), np.abs(ref)).astype(np.float32))
    worst = np.abs(got - ref) - room
    assert worst.max() <= 0, f"{what}: {worst.max()} beyond the bound"


def runner_outputs(case_opts, vol, mask):
    """Both packages' runner.run on the same voxels at float64, the
    calls each backend's dorun makes (before the float32 cast)."""
    opts = {"method": "vb", "noise": "white", "max-iterations": "10",
            "dtype": "double", **case_opts, **SAVE}
    out = []
    for geom_cls, store_cls, opts_cls, run in (
            (JGeometry, JStore, JOptions, jrunner.run),
            (VolumeGeometry, VoxelDataStore, RunOptions,
             lambda *a, **k: trunner.run(*a, device="cpu", **k))):
        geom = geom_cls(SHAPE, mask)
        store = store_cls(geom)
        store.set("data", vol)
        out.append(run(opts_cls(opts), store).outputs)
    return out


def test_port_shim_builds_and_exports_the_jax_abi(port_lib, jax_lib):
    """The shim builds here (g++ through capi.build) into
    build/capi/<key>/, and exports the fabber_* functions of the JAX
    package's shim, no more and no fewer."""
    path = capi.build()
    assert path.name == "libfabber_core_tpu_torch.so"
    assert path.parent.parent == ROOT / "build" / "capi"
    assert capi.build() == path   # built once per key

    def exports(lib_path):
        out = subprocess.run(["nm", "-D", "--defined-only", str(lib_path)],
                             check=True, capture_output=True, text=True)
        return sorted(line.split()[-1] for line in out.stdout.splitlines()
                      if line.split()[-1].startswith("fabber_"))
    jpath = Path(jax_lib._name)
    assert exports(path) == exports(jpath)
    assert len(exports(path)) == 17


@pytest.mark.parametrize("case", [poly_case, linear_case],
                         ids=["poly", "linear"])
def test_capi_matches_jax_and_run_with_data(port_lib, jax_lib, tmp_path,
                                             case):
    case_opts, vol = case(tmp_path)
    mask = mask_volume()
    opts = {"method": "vb", "noise": "white", "max-iterations": "10",
            "dtype": "double", **case_opts, **SAVE}
    jrun = JFabber().run_with_data(opts, {"data": vol}, mask=mask)
    names = sorted(jrun.data)
    p = sum(name.startswith("mean_") for name in names)
    assert p in (3, 4) and {"noise_means", "freeEnergy", "finalMVN",
                            "modelfit"} <= set(names)
    port, log = capi_run(port_lib, vol, {**opts, "device": "cpu"}, names,
                         mask)
    jcapi, _ = capi_run(jax_lib, vol, opts, names, mask)
    trun = FabberTpu(device="cpu").run_with_data(opts, {"data": vol},
                                                 mask=mask)
    assert "Option device=cpu" in log and "Vb::Engine route:" in log

    n = p + 1   # the parameters and the noise
    for name in names:
        # the port's C API is its run_with_data, bit for bit
        assert port[name].dtype == trun.data[name].dtype == np.float32
        np.testing.assert_array_equal(port[name], trun.data[name],
                                      err_msg=name)
        assert np.all(port[name][0, 0, 0] == 0), name   # masked voxel
    assert port["finalMVN"].shape == SHAPE + (n + n * (n + 1) // 2 + 1,)
    for name in names:
        if name.startswith(("mean_", "std_")):
            assert_f32_image(port[name], jcapi[name], what=f"{name} capi")
            assert_f32_image(port[name], jrun.data[name], what=f"{name} api")

    # before the cast: both runners at float64, 1e-9 of each output
    jout, tout = runner_outputs(case_opts, vol, mask)
    assert sorted(tout) == sorted(jout)
    for name in jout:
        ref = np.asarray(jout[name], np.float64)
        err = np.abs(np.asarray(tout[name], np.float64) - ref).max()
        assert err <= 1e-9 * np.abs(ref).max(), (name, err)


def tsv_rows(text):
    rows = [line.split("\t") for line in text.split("\n")[1:]]
    return {r[0]: r[1:] for r in rows}


def own_models_only(*registries):
    """Drop from each model registry (a name -> class dict) the names
    whose class was defined outside fabber_core_tpu and
    fabber_core_tpu_torch: models a test of this process registered and
    left behind (tests/test_cli.py's and tests/test_plugin_models.py's
    plugins stay in the JAX registry; pytest-xdist's loadfile runs any
    file before this one in its worker)."""
    for reg in registries:
        for name in [n for n, cls in reg.items() if cls.__module__.split(
                ".")[0] not in ("fabber_core_tpu", "fabber_core_tpu_torch")]:
            del reg[name]


def test_capi_introspection_matches_jax(port_lib, jax_lib):
    """Models, methods, parameters, their descriptions, the model
    outputs and every model's options are the JAX backend's TSVs; the
    run options are too, but for the port's own `device` (named, with
    its default cuda) and profile-dir's text (a torch.profiler trace).
    The method options keep each shared row's type, optional flag and
    default; their names differ as the port's engines do (no
    voxel-chunk-size/chunk-streaming: no chunked passes; spatialvb lists
    the spatial engine's own options). Both packages' own models only:
    own_models_only drops what other tests left registered, and the
    registries are put back afterwards."""
    with restored(jbase._MODELS, tbase._MODELS):
        own_models_only(jbase._MODELS, tbase._MODELS)
        check_introspection(port_lib, jax_lib)


def test_capi_introspection_ignores_a_leaked_model(port_lib, jax_lib):
    """A model another test registered in the JAX registry and left
    there (as tests/test_cli.py's plugin does) changes nothing: the
    comparison passes whichever test file ran before it in its worker,
    and the leaked name is still registered afterwards."""
    with restored(jbase._MODELS):
        @jbase.register_model
        class Leaked(jbase.Model):
            name = "leakedtestmodel"

        test_capi_introspection_matches_jax(port_lib, jax_lib)
        assert jbase._MODELS["leakedtestmodel"] is Leaked
    assert "leakedtestmodel" not in jbase._MODELS


def check_introspection(port_lib, jax_lib):
    """test_capi_introspection_matches_jax's comparison."""
    tfab, jfab = new(port_lib), new(jax_lib)

    def text(lib, fab, fn, *args):
        out = ctypes.create_string_buffer(1 << 16)
        rc, err = call(getattr(lib, fn), fab, *args, 1 << 16, out)
        assert rc == 0, err
        return out.value.decode()

    for lib, fab in ((port_lib, tfab), (jax_lib, jfab)):
        for key, value in (("model", "poly"), ("degree", "2")):
            assert call(lib.fabber_set_opt, fab, key.encode(),
                        value.encode())[0] == 0
    for fn in ("fabber_get_models", "fabber_get_methods",
               "fabber_get_model_params", "fabber_get_model_param_descs",
               "fabber_get_model_outputs"):
        assert text(port_lib, tfab, fn) == text(jax_lib, jfab, fn), fn
    assert text(port_lib, tfab, "fabber_get_model_params").split() == \
        ["c0", "c1", "c2"]
    for model in (b"poly", b"exp", b"linear"):
        assert text(port_lib, tfab, "fabber_get_options", b"model", model) \
            == text(jax_lib, jfab, "fabber_get_options", b"model", model)

    trows = tsv_rows(text(port_lib, tfab, "fabber_get_options", b"", b""))
    jrows = tsv_rows(text(jax_lib, jfab, "fabber_get_options", b"", b""))
    assert trows.pop("device") == ["Torch device to run on: cuda or cpu",
                                   "STR", "1", "cuda"]
    assert "torch.profiler" in trows["profile-dir"][0]
    assert "jax.profiler" in jrows["profile-dir"][0]
    trows["profile-dir"][0] = jrows["profile-dir"][0]
    assert trows == jrows

    port_only = {"vb": set(), "nlls": set(), "spatialvb": {
        "param-spatial-priors", "spatial-block-voxels", "spatial-dims",
        "spatial-fchange", "spatial-mem-gb", "spatial-q1", "spatial-q2",
        "spatial-speed", "spatial-stencil", "spatial-sweep-mode",
        "update-spatial-prior-on-first-iteration"}}
    jax_only = {"vb": {"chunk-streaming", "voxel-chunk-size"},
                "nlls": set(),
                "spatialvb": {"chunk-streaming", "voxel-chunk-size"}}
    for method in ("vb", "spatialvb", "nlls"):
        trows = tsv_rows(text(port_lib, tfab, "fabber_get_options",
                              b"method", method.encode()))
        jrows = tsv_rows(text(jax_lib, jfab, "fabber_get_options",
                              b"method", method.encode()))
        assert set(trows) - set(jrows) == port_only[method], method
        assert set(jrows) - set(trows) == jax_only[method], method
        for name in set(trows) & set(jrows):
            assert trows[name][1:] == jrows[name][1:], (method, name)
    port_lib.fabber_destroy(tfab)
    jax_lib.fabber_destroy(jfab)


def evaluate(lib, fab, params, nt, indata=None, output=None):
    params = np.asarray(params, np.float32)
    out = np.zeros(nt, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ind = None if indata is None else \
        np.asarray(indata, np.float32).ctypes.data_as(fp)
    args = [fab, len(params), params.ctypes.data_as(fp), nt, ind]
    if output is None:
        rc, err = call(lib.fabber_model_evaluate, *args,
                       out.ctypes.data_as(fp))
    else:
        rc, err = call(lib.fabber_model_evaluate_output, *args,
                       output.encode(), out.ctypes.data_as(fp))
    return rc, err, out


@pytest.mark.parametrize("opts,params", [
    ({"model": "poly", "degree": "2"}, [1.0, 2.0, 0.5]),
    ({"model": "exp", "dt": "0.1", "num-exps": "2"}, [1.0, 0.8, 0.5, 3.0])],
    ids=["poly", "biexp"])
def test_capi_model_evaluate_matches_jax(port_lib, jax_lib, opts, params):
    """fabber_model_evaluate(_output) on device=cpu against the JAX C
    API and the port's API (float64 inside, float32 out), and a wrong
    parameter count reported."""
    nt = 12
    outs = []
    for lib, extra in ((port_lib, {"device": "cpu"}), (jax_lib, {})):
        fab = new(lib)
        for key, value in {**opts, **extra}.items():
            assert call(lib.fabber_set_opt, fab, key.encode(),
                        value.encode())[0] == 0
        rc, err, out = evaluate(lib, fab, params, nt)
        assert rc == 0, err
        rc, err, named = evaluate(lib, fab, params, nt, output="")
        assert rc == 0, err
        np.testing.assert_array_equal(named, out)
        rc, err, _ = evaluate(lib, fab, params[:-1], nt)
        assert rc < 0 and "Incorrect number of parameters" in err
        lib.fabber_destroy(fab)
        outs.append(out)
    assert_f32_image(outs[0], outs[1], rtol=1e-12)
    names = FabberTpu(device="cpu").get_model_params(opts)
    ref = FabberTpu(device="cpu").model_evaluate(
        opts, dict(zip(names, np.float32(params).astype(float))), nt)
    np.testing.assert_array_equal(outs[0], ref.astype(np.float32))


def test_capi_load_models_runs_the_plugin(port_lib):
    """fabber_load_models with the port's example plugin registers
    myexp, which evaluates through the C API; an empty path and a
    missing file are reported."""
    with restored(tbase._MODELS):
        fab = new(port_lib)
        rc, err = call(port_lib.fabber_load_models, fab, str(PLUGIN).encode())
        assert rc == 0, err
        out = ctypes.create_string_buffer(4096)
        assert call(port_lib.fabber_get_models, fab, 4096, out)[0] == 0
        assert "myexp" in out.value.decode().split()
        for key, value in (("model", "myexp"), ("dt", "0.1"),
                           ("device", "cpu")):
            assert call(port_lib.fabber_set_opt, fab, key.encode(),
                        value.encode())[0] == 0
        rc, err, got = evaluate(port_lib, fab, [2.0, 0.5], 10)
        assert rc == 0, err
        t = np.arange(10) * 0.1
        np.testing.assert_allclose(got, 2.0 * np.exp(-0.5 * t), rtol=1e-6)
        assert call(port_lib.fabber_load_models, fab, b"")[0] < 0
        rc, err = call(port_lib.fabber_load_models, fab, b"/no/such/model.py")
        assert rc < 0 and err
        port_lib.fabber_destroy(fab)


def test_capi_error_reporting(port_lib):
    """Errors come back as a negative code with the message in err_buf:
    data before the extent, an unknown output, an unknown model."""
    fab = new(port_lib)
    data = np.zeros(4, np.float32)
    fptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc, err = call(port_lib.fabber_set_data, fab, b"data", 1, fptr)
    assert rc < 0 and "Extent" in err
    rc, err = call(port_lib.fabber_set_extent, fab, 0, 1, 1, None)
    assert rc < 0 and "non-zero" in err
    rc, err = call(port_lib.fabber_get_data_size, fab, b"mean_c0")
    assert rc < 0 and "mean_c0" in err
    configure(port_lib, fab, np.zeros((2, 1, 1, 5), np.float32),
              {"model": "nosuchmodel", "device": "cpu"})
    log = ctypes.create_string_buffer(1024)
    rc, err = call(lambda *a: port_lib.fabber_dorun(fab, 1024, log, a[-1],
                                                    None))
    assert rc < 0 and "nosuchmodel" in err
    port_lib.fabber_destroy(fab)


def test_capi_default_device_is_the_card(port_lib):
    """No device option: dorun and model_evaluate take the card; here,
    without one, both fail with resolve_device's error. Nothing runs on
    the CPU unless asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there "
                    "(tests/test_torch_cuda.py -k capi)")
    fab = new(port_lib)
    case_opts, vol = poly_case(None)
    configure(port_lib, fab, vol, {"method": "vb", "noise": "white",
                                   "save-mean": True, **case_opts})
    log = ctypes.create_string_buffer(1024)
    rc, err = call(lambda *a: port_lib.fabber_dorun(fab, 1024, log, a[-1],
                                                    None))
    assert rc < 0
    assert "device 'cuda' requested" in err and "is_available" in err
    rc, err = call(port_lib.fabber_get_data_size, fab, b"mean_c0")
    assert rc < 0   # no outputs: the run did not happen
    rc, err, _ = evaluate(port_lib, fab, [1.0, 2.0, 0.5], 8)
    assert rc < 0 and "device 'cuda' requested" in err
    port_lib.fabber_destroy(fab)


def test_standalone_c_host_on_cpu():
    """The port's C host (an embedded interpreter, no Python on the
    host side) recovers its phantom on device=cpu, takes the spectral
    route at dtype=single, and its interpreter holds no module of jax or
    of the JAX package after the run."""
    from fabber_core_tpu_torch.inference.vb import ROUTES
    host = capi.build_host()
    res = subprocess.run([str(host), "cpu"], capture_output=True, text=True,
                         env=capi.host_env(), cwd=str(host.parent),
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert f"Vb::Engine route: {ROUTES['spectral-whole']}" in lines
    assert "modules of jax or the JAX package: none" in lines
    assert lines[-1] == "C API host test PASSED"
