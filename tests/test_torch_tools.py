"""The port's tools (mvntool, fabber_var, niftidiff), `.fab` run files,
self-test harness, single-voxel evaluation and --profile-dir on the
CPU, against the JAX package's.

The tools only read and write files: on the same inputs the two
packages' output files are identical, header and data (compared
decompressed: gzip stamps a time). The `.fab` text dumps are
identical. generate_test_data draws the same numpy noise from one seed,
so the phantoms agree to 1e-12 (the curves are float64 evaluations of
one formula in two frameworks); self_test at dtype=double agrees to
1e-9 relative per ROI value, the oracle level of the float64 routes.
"""

import gzip
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fabber_core_tpu import cli as jcli
from fabber_core_tpu import fabfile as jfabfile
from fabber_core_tpu import selftest as jselftest
from fabber_core_tpu.api import FabberTpu as JFabber
from fabber_core_tpu.tools import fabber_var as jvar
from fabber_core_tpu.tools import mvntool as jmvntool
from fabber_core_tpu.tools import niftidiff as jdiff
from fabber_core_tpu_torch import cli as tcli
from fabber_core_tpu_torch import fabfile, selftest
from fabber_core_tpu_torch.api import FabberTpu
from fabber_core_tpu_torch.io import mvn as mvn_io
from fabber_core_tpu_torch.io import nifti
from fabber_core_tpu_torch.tools import fabber_var, mvntool, niftidiff

torch.set_num_threads(1)


def file_bytes(path):
    raw = Path(path).read_bytes()
    return gzip.decompress(raw) if str(path).endswith(".gz") else raw


@pytest.fixture
def mvn_file(tmp_path):
    """A small MVN NIFTI: 3 parameters on a 3x2x1 grid, one voxel
    outside the mask (no trailing 1), and a parameter-name list."""
    rng = np.random.default_rng(0)
    means = rng.normal(size=(6, 3))
    a = rng.normal(size=(6, 3, 3))
    cov = a @ a.transpose(0, 2, 1) + 3 * np.eye(3)
    packed = mvn_io.pack(means, cov).T
    packed[5] = 0.0
    vol = packed.reshape((3, 2, 1, packed.shape[1]), order="F")
    path = tmp_path / "finalMVN.nii.gz"
    nifti.save(nifti.NiftiImage(vol.astype(np.float32),
                                intent=nifti.NIFTI_INTENT_SYMMATRIX),
               str(path), dtype=np.float64)
    (tmp_path / "paramnames.txt").write_text("alpha\nbeta\ngamma\n")
    (tmp_path / "newnames.txt").write_text("alpha\ndelta\nbeta\ngamma\n")
    return tmp_path


MVNTOOL_CASES = {
    "value": ["--param=2", "--val"],
    "variance": ["--param=1", "--var"],
    "covariance": ["--param=1", "--cvar=3"],
    "write": ["--param=2", "--write", "--val=42.0", "--var=2.5"],
    "insert": ["--param=2", "--new", "--val=7.0", "--var=1.0"],
    "by-name": ["--param=gamma", "--param-list={d}/paramnames.txt", "--val"],
    "insert-by-name": ["--param=delta", "--param-list={d}/paramnames.txt",
                       "--new-param-list={d}/newnames.txt", "--val=3",
                       "--var=0.5", "--out-param-file={out}.names"],
}


@pytest.mark.parametrize("case", sorted(MVNTOOL_CASES))
def test_mvntool_matches_jax(mvn_file, case):
    outs = []
    for name, tool in (("jax", jmvntool), ("port", mvntool)):
        out = mvn_file / f"{name}_{case}.nii.gz"
        args = [a.format(d=mvn_file, out=out) for a in MVNTOOL_CASES[case]]
        assert tool.main([f"--input={mvn_file}/finalMVN.nii.gz",
                          f"--output={out}"] + args) == 0
        outs.append(out)
    assert file_bytes(outs[0]) == file_bytes(outs[1])
    if case == "insert-by-name":
        assert Path(f"{outs[0]}.names").read_text() == \
            Path(f"{outs[1]}.names").read_text() == \
            "alpha\ndelta\nbeta\ngamma\n"


def test_mvntool_refusals_match_jax(mvn_file, capsys):
    """Conflicting modes and an extract without --output (which would
    overwrite the input) exit 1 with the same message."""
    inp = f"--input={mvn_file}/finalMVN.nii.gz"
    for args in (["--param=1", "--new", "--write", "--val=1"],
                 ["--param=1", "--val"], ["--param=zeta",
                  f"--param-list={mvn_file}/paramnames.txt", "--val",
                  f"--output={mvn_file}/x.nii.gz"]):
        assert jmvntool.main([inp] + args) == 1
        jerr = capsys.readouterr().err
        assert mvntool.main([inp] + args) == 1
        assert capsys.readouterr().err == jerr and jerr


def test_fabber_var_matches_jax(mvn_file):
    written = []
    for name, tool in (("jax", jvar), ("port", fabber_var)):
        out = mvn_file / name
        out.mkdir()
        written.append(tool.extract_variances(str(mvn_file), str(out)))
    assert [Path(p).name for p in written[0]] == \
        [Path(p).name for p in written[1]] == \
        ["var_alpha.nii.gz", "var_beta.nii.gz", "var_gamma.nii.gz"]
    for a, b in zip(*written):
        assert file_bytes(a) == file_bytes(b)
    assert fabber_var.main([str(mvn_file), str(mvn_file / "port")]) == 0


def test_niftidiff_matches_jax(tmp_path, capsys):
    """File mode (eps, mask, ignore-zero) and directory mode: the same
    exit codes and messages."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 3, 2, 2)).astype(np.float32)
    b = a.copy()
    b[0, 0, 0, 0] += 0.005
    b[1, 1, 1, 1] = 0.0
    mask = np.ones((4, 3, 2), np.float32)
    mask[0, 0, 0] = 0
    for name, arr in (("a", a), ("b", b), ("m", mask)):
        nifti.save(nifti.NiftiImage(arr), str(tmp_path / f"{name}.nii.gz"))
    d1, d2 = tmp_path / "d1", tmp_path / "d2"
    for d, arr in ((d1, a), (d2, b)):
        d.mkdir()
        nifti.save(nifti.NiftiImage(arr), str(d / "x.nii.gz"))
    nifti.save(nifti.NiftiImage(a), str(d1 / "only.nii.gz"))
    fa, fb, fm = (str(tmp_path / f"{n}.nii.gz") for n in "abm")
    for args in ([fa, fb], [fa, fb, "--eps=0.001"], [fa, fb, "--eps=10"],
                 [fa, fb, f"--mask={fm}", "--eps=0.001"],
                 [fa, fb, "--ignore-zero", "--eps=0.01"],
                 [str(d1), str(d2)], [str(d1), str(d1)]):
        rc = jdiff.main(args)
        jout = capsys.readouterr().out
        assert niftidiff.main(args) == rc, args
        assert capsys.readouterr().out == jout, args
    # one path: the usage (each package's own module name), exit 2
    assert jdiff.main([fa]) == niftidiff.main([fa]) == 2
    assert "python -m fabber_core_tpu_torch.tools.niftidiff" in \
        capsys.readouterr().out


def test_fab_file_round_trip_matches_jax(tmp_path):
    """Load, edit (set, add, delete, comment) and save a .fab file in
    both packages: the dumped text is the same, comments, blank lines,
    order and bare flags kept."""
    src = tmp_path / "run.fab"
    src.write_text("# a run file\n\nmodel=poly\ndegree = 2\nsave-mean\n"
                   "# data\ndata=vol.nii.gz\nmask=m.nii.gz\n")
    texts = []
    for mod in (jfabfile, fabfile):
        run = mod.FabRunFile(str(src))
        assert run["degree"] == "2" and "save-mean" in run
        assert run.keys() == ["model", "degree", "save-mean", "data", "mask"]
        run["degree"] = 3
        run["noise"] = "white"
        del run["save-mean"]
        run.add_comment("edited", option="data")
        run.add_comment("top")
        stream = io.StringIO()
        run.dump(stream, mask="other.nii.gz")
        out = tmp_path / f"{mod.__name__.split('.')[0]}.fab"
        run.save(str(out))
        again = mod.FabRunFile(str(out))
        assert again == run and len(again) == 5
        texts.append((stream.getvalue(), out.read_text()))
    assert texts[0] == texts[1]
    assert "mask=other.nii.gz" in texts[1][0]


def test_generate_test_data_matches_jax():
    opts = {"model": "exp", "dt": "0.1", "num-exps": "1"}
    params = {"amp1": [1.0, 0.5], "r1": [1.0, 0.8]}
    kw = dict(nt=20, patchsize=2, noise=0.1, param_rois=True, seed=7)
    jdata, jclean, jrois = jselftest.generate_test_data(opts, params, **kw)
    data, clean, rois = selftest.generate_test_data(opts, params,
                                                    device="cpu", **kw)
    assert data.shape == jdata.shape == (4, 4, 2, 20)
    np.testing.assert_allclose(clean, jclean, rtol=1e-12, atol=0)
    np.testing.assert_allclose(data, jdata, rtol=1e-12, atol=1e-15)
    assert sorted(rois) == sorted(jrois)
    for key in rois:
        np.testing.assert_array_equal(rois[key], jrois[key])
    with pytest.raises(RuntimeError, match="up to 3 dimensions"):
        selftest.generate_test_data(
            opts, {"a": [1, 2], "b": [1, 2], "c": [1, 2], "d": [1, 2]},
            device="cpu")


def test_self_test_matches_jax_at_double():
    """The exp model's self-test scenario, small: every ROI value and the
    noise within 1e-9 relative of the JAX harness at float64."""
    args = ("exp", {"dt": "0.1", "max-iterations": "10", "dtype": "double"},
            {"amp1": [1.0, 0.5], "r1": 1.0})
    kw = dict(nt=30, patchsize=3, noise=0.1, seed=3)
    jres, _ = jselftest.self_test(*args, **kw)
    res, log = selftest.self_test(*args, device="cpu", **kw)
    assert "Vb::Engine route:" in log
    assert sorted(res) == sorted(jres) == ["amp1", "noise"]
    for param in res:
        assert sorted(res[param]) == sorted(jres[param])
        for truth, got in res[param].items():
            ref = jres[param][truth]
            assert abs(got - ref) <= 1e-9 * abs(ref), (param, truth, got, ref)
    assert abs(res["amp1"][1.0] - 1.0) < 0.1


def test_self_test_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there "
                    "(tests/test_torch_cuda.py -k self_test)")
    with pytest.raises(Exception, match="device 'cuda' requested"):
        selftest.self_test("exp", {"dt": "0.1"}, {"amp1": [1.0, 0.5]},
                           nt=10, patchsize=1, seed=0)


@pytest.mark.parametrize("opts,values,indata", [
    ({"model": "poly", "degree": "2"}, {"c0": 1.0, "c1": -2.0, "c2": 0.5},
     None),
    ({"model": "exp", "dt": "0.05", "num-exps": "2"},
     {"amp1": 1.0, "r1": 0.8, "amp2": 0.4, "r2": 5.0}, None),
    ({"model": "linear", "basis": "BASIS"},
     {"Parameter_1": 1.5, "Parameter_2": -0.5}, None)],
    ids=["poly", "biexp", "linear"])
def test_model_evaluate_matches_jax(tmp_path, opts, values, indata):
    """FabberTpu.model_evaluate on device=cpu against the JAX API's (its
    float64 evaluation on its default device); without a card the
    default device raises."""
    nt = 15
    if opts.get("basis") == "BASIS":
        basis = tmp_path / "basis.mat"
        np.savetxt(basis, np.random.default_rng(2).normal(size=(nt, 2)))
        opts = {**opts, "basis": str(basis)}
    got = FabberTpu(device="cpu").model_evaluate(opts, values, nt)
    ref = JFabber().model_evaluate(opts, values, nt)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match="device 'cuda' requested"):
            FabberTpu().model_evaluate(opts, values, nt)


def test_cli_evaluate_matches_jax(tmp_path, capsys):
    """--evaluate prints the forward model on --device; with no --device
    it asks for the card, and here, without one, exits 1 naming it."""
    params = tmp_path / "params.txt"
    np.savetxt(params, [[1.0, 0.8, 0.4, 5.0]])
    data = tmp_path / "data.txt"
    np.savetxt(data, np.linspace(0, 1, 12)[:, None])
    args = ["--model=exp", "--num-exps=2", "--dt=0.05", "--evaluate=",
            "--evaluate-nt=12", f"--evaluate-params={params}",
            f"--evaluate-data={data}"]
    assert jcli.execute(args) == 0
    jout = capsys.readouterr().out
    assert tcli.execute(args + ["--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert out == jout and len(out.split()) == 12
    if not torch.cuda.is_available():
        assert tcli.execute(args) == 1
        assert "device 'cuda' requested" in capsys.readouterr().err


def test_cli_profile_dir_writes_a_trace(tmp_path):
    """--profile-dir wraps the run in torch.profiler: a Chrome trace
    (tensorboard_trace_handler's <host>_<pid>.<ns>.pt.trace.json) lands
    in the directory, the log says so, and the outputs are those of the
    run without the profiler."""
    rng = np.random.default_rng(4)
    t = np.arange(1, 21)
    vol = (2 + 0.3 * t + 0.1 * rng.standard_normal((3, 3, 2, 20))
           ).astype(np.float32)
    nifti.save(nifti.NiftiImage(vol), str(tmp_path / "data.nii.gz"))
    common = ["--model=poly", "--degree=1", "--method=vb", "--noise=white",
              "--dtype=single", f"--data={tmp_path / 'data.nii.gz'}",
              "--device=cpu"]
    prof = tmp_path / "prof"
    assert tcli.execute(common + [f"--output={tmp_path / 'a'}",
                                  f"--profile-dir={prof}"]) == 0
    assert tcli.execute(common + [f"--output={tmp_path / 'b'}"]) == 0
    traces = sorted(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    log = (tmp_path / "a" / "logfile").read_text()
    assert f"Profiler trace written to {prof}" in log
    assert "Profiler trace" not in (tmp_path / "b" / "logfile").read_text()
    for name in ("mean_c0.nii.gz", "mean_c1.nii.gz", "noise_means.nii.gz"):
        assert file_bytes(tmp_path / "a" / name) == \
            file_bytes(tmp_path / "b" / name)
