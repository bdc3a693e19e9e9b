"""Command-line interface — the `fabber` executable equivalent, for
method=vb, method=spatialvb and method=nlls.

Port of fabber_core_tpu/cli.py (fabber_core.cc:88-323): option parsing
with --key=value / -f optfile, the help/list/evaluate fast paths, NIFTI
file I/O with mask-based voxel packing, output-directory management
with '+'-suffix non-overwrite and a _latest link, logfile and
paramnames.txt emission, and the backwards-compatible default output
set. One option is the port's own: --device=cuda|cpu (default cuda;
nothing falls back from cuda to the CPU), which --evaluate's forward
pass takes too. --profile-dir=DIR writes a torch.profiler trace of the
run where the JAX CLI writes a jax.profiler one.

    python -m fabber_core_tpu_torch.cli --model=poly --degree=2 \\
        --method=vb --noise=white --dtype=single --data=d.nii.gz \\
        --output=out
"""

import os
import sys

import numpy as np

from . import resolve_device, runner
from .api import FabberTpu
from .core.volume import VolumeGeometry, VoxelDataStore
from .easylog import EasyLog
from .exceptions import DataNotFound, FabberError
from .io import nifti
from .models import get_model_class, resolve_parameters
from .noise import get_noise_class, known_noise_models
from .options import OptionSpec, OPT_STR, RunOptions
from .version import __version__

COMPAT_SAVE_DEFAULTS = ["save-mean", "save-std", "save-zstat",
                        "save-noise-mean", "save-noise-std",
                        "save-free-energy", "save-mvn"]

DEVICE_OPTION = OptionSpec("device", OPT_STR,
                           "Torch device to run on: cuda or cpu",
                           default="cuda")


class NiftiVoxelDataStore(VoxelDataStore):
    """Voxel data store that lazily loads NIFTI files named by options
    (the rundata_newimage role)."""

    def __init__(self, geometry, options, log):
        super().__init__(geometry)
        self.options = options
        self.log = log

    def get(self, key, _seen=None):
        try:
            return super().get(key, _seen)
        except DataNotFound:
            if self.options.have(key):
                filename = self.options.get_string(key)
                if os.path.exists(filename):
                    self.log.log(f"Loading data from '{filename}'")
                    img = nifti.load(filename)
                    self.set(key, img.data)
                    return super().get(key)
            raise


def parse_args(argv):
    options = RunOptions()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "-f":
            i += 1
            if i >= len(argv):
                raise FabberError("-f requires a filename argument")
            options.parse_option_file(argv[i])
        elif arg == "-@":
            i += 1
            if i >= len(argv):
                raise FabberError("-@ requires a filename argument")
            options.parse_old_style_option_file(argv[i])
        elif arg.startswith("--"):
            options.parse_cli([arg])
        else:
            raise FabberError(f"Option '{arg}' doesn't begin with --")
        i += 1
    if options.have("optfile"):
        options.parse_old_style_option_file(options.get_string("optfile"))
    return options


def print_usage(options):
    fab = FabberTpu(device="cpu")
    if options.have("model"):
        model = options.get_string("model")
        opts, desc = fab.get_options(model=model)
        print(f"Usage information for model: {model}\n\n{desc}\n\nOptions:\n")
    elif options.have("method"):
        method = options.get_string("method")
        opts, desc = fab.get_options(method=method)
        if method in ("vb", "spatialvb"):
            # the noise models' options (--noise=...) belong to VB's
            opts = opts + [
                {"name": s.name, "description": f"({name} noise) "
                 + s.description, "optional": True, "default": s.default}
                for name in known_noise_models()
                for s in get_noise_class(name).get_options()]
        print(f"Usage information for method: {method}\n\n{desc}\n\nOptions:\n")
    else:
        opts, desc = fab.get_options()
        opts = opts + [{"name": DEVICE_OPTION.name,
                        "description": DEVICE_OPTION.description,
                        "optional": True, "default": DEVICE_OPTION.default}]
        print(f"fabber_core_tpu_torch {__version__}\n\n{desc}\n\nOptions:\n")
    for o in opts:
        req = "" if o["optional"] else " (required)"
        dflt = f" [default: {o['default']}]" if o["default"] else ""
        print(f"  --{o['name']:<30} {o['description']}{req}{dflt}")


def pick_output_dir(options, log):
    """Output dir creation with '+' suffix semantics
    (rundata.cc:660-738)."""
    outdir = options.get_string("output")
    overwrite = options.get_bool("overwrite")
    if os.path.exists(outdir) and not overwrite:
        base = outdir
        while os.path.exists(outdir):
            outdir += "+"
        if outdir != base:
            log.log(f"Output directory exists; using {outdir}")
    os.makedirs(outdir, exist_ok=True)

    if options.get_bool("link-to-latest"):
        link = os.path.join(os.path.dirname(outdir.rstrip("/")) or ".",
                            os.path.basename(outdir.rstrip("/")).rstrip("+")
                            + "_latest")
        try:
            if os.path.islink(link):
                os.unlink(link)
            os.symlink(os.path.basename(outdir), link)
        except OSError as e:
            log.warn(f"Could not create latest link: {e}")
    return outdir


def execute(argv):
    """The reference execute() control flow. Returns exit code."""
    try:
        options = parse_args(argv)
    except FabberError as e:
        sys.stderr.write(f"{e}\n")
        return 1

    if not argv or options.get_bool("help"):
        print_usage(options)
        return 0
    if options.get_bool("version"):
        print(f"fabber_core_tpu_torch {__version__}")
        return 0
    fab = FabberTpu(device="cpu")
    if options.have("loadmodels"):
        from .models import load_models_from_file
        load_models_from_file(options.get_string("loadmodels"))
    if options.get_bool("listmodels"):
        print("\n".join(fab.get_models()))
        return 0
    if options.get_bool("listmethods"):
        print("\n".join(fab.get_methods()))
        return 0
    if options.get_bool("listparams"):
        print("\n".join(fab.get_model_params(options)))
        return 0
    if options.get_bool("descparams"):
        opts_model = get_model_class(options.get_string("model"))(options)
        for p in resolve_parameters(opts_model, options):
            print(f"{p.name} {p.desc or 'No description'} "
                  f"{p.units or '(no units)'}")
        return 0
    if options.get_bool("listoutputs"):
        print("\n".join(fab.get_model_outputs(options)))
        return 0
    try:
        if options.have("evaluate"):
            return _evaluate_fast_path(options)
        return _run(options)
    except (FabberError, NotImplementedError) as e:
        sys.stderr.write(f"Error: {e}\n")
        return 1


def _evaluate_fast_path(options):
    """--evaluate: run model forward pass (fabber_core.cc:221-256) on
    --device."""
    from .io import matfile
    key = options.get_string("evaluate")
    nt = options.get_int("evaluate-nt")
    pvals = matfile.read_matrix_file(
        options.get_string("evaluate-params")).ravel()
    model = get_model_class(options.get_string("model"))(options)
    params = resolve_parameters(model, options)
    if len(pvals) != len(params):
        sys.stderr.write(
            f"Expected {len(params)} parameter values, got {len(pvals)}\n")
        return 1
    values = {p.name: pvals[i] for i, p in enumerate(params)}
    indata = None
    if options.have("evaluate-data"):
        indata = matfile.read_matrix_file(
            options.get_string("evaluate-data"))[:, 0]
    fab = FabberTpu(device=options.get_string("device",
                                              DEVICE_OPTION.default))
    result = fab.model_evaluate(options, values, nt, indata=indata,
                                output_name=key)
    for val in result:
        print(f"{val:.6f}")
    return 0


def _run(options):
    log = EasyLog()
    simple_output = options.get_bool("simple-output")
    device = options.get_string("device", DEVICE_OPTION.default)

    outdir = pick_output_dir(options, log)
    logpath = os.path.join(outdir, "logfile")
    with open(logpath, "w") as logfile:
        log.start(logfile, echo=False)

        mask_img = None
        if options.have("mask"):
            mask_img = nifti.load(options.get_string("mask"))
            geom = VolumeGeometry(mask_img.shape[:3], mask_img.data)
            log.log(f"Mask applied: {geom.nvoxels} voxels")
        else:
            data_img = nifti.load(options.get_string("data"))
            geom = VolumeGeometry(data_img.shape[:3])
        store = NiftiVoxelDataStore(geom, options, log)

        def progress(vox, total):
            pct = 100 * vox // max(total, 1)
            if simple_output:
                print(pct)
            else:
                sys.stdout.write(f"\rProgress: {pct}%")
                sys.stdout.flush()

        # the CLI's backwards-compatible default output set
        # (rundata.cc:221-232)
        if not options.get_bool("no-compat-output"):
            for key in COMPAT_SAVE_DEFAULTS:
                if key not in options:
                    options.set(key, "")
        options.set("dump-param-names", "")

        # Optional profiling: a torch.profiler trace of the run (host
        # ops, and the card's kernels and copies on cuda), written by
        # tensorboard_trace_handler as <dir>/<host>_<pid>.<ns>.pt.trace.json
        # (Chrome trace JSON: TensorBoard, Perfetto, chrome://tracing)
        profile_dir = options.get_string("profile-dir", "")
        if profile_dir:
            result = _profiled_run(profile_dir, options, store, log, progress,
                                   device)
            log.log(f"Profiler trace written to {profile_dir}")
        else:
            result = runner.run(options, store, log=log,
                                progress_cb=progress, device=device)
        if not simple_output:
            print()

        with open(os.path.join(outdir, "paramnames.txt"), "w") as f:
            for name in result.param_names:
                f.write(name + "\n")
        # run-environment record, as the reference writes (rundata.cc:724)
        import platform
        with open(os.path.join(outdir, "uname.txt"), "w") as f:
            f.write(" ".join(platform.uname()) + "\n")

        affine = mask_img.affine_bytes if mask_img is not None else None
        pixdims = mask_img.pixdims if mask_img is not None else None
        for key, arr in result.outputs.items():
            vol = geom.from_voxels(np.asarray(arr, np.float32))
            intent = nifti.NIFTI_INTENT_SYMMATRIX if key == "finalMVN" \
                else nifti.NIFTI_INTENT_NONE
            img = nifti.NiftiImage(vol, pixdims=pixdims, intent=intent,
                                   affine_bytes=affine)
            nifti.save(img, os.path.join(outdir, key + ".nii.gz"))
            log.log(f"Saved {key}.nii.gz")

    if options.get_bool("gzip-log"):
        # compress the logfile on normal exit (fabber_core.cc:283-313)
        import gzip as _gzip
        with open(logpath, "rb") as fin, \
                _gzip.open(logpath + ".gz", "wb") as fout:
            fout.write(fin.read())
        os.remove(logpath)
    if not simple_output:
        print(f"Output in {outdir}")
    return 0


def _profiled_run(profile_dir, options, store, log, progress, device):
    """runner.run inside torch.profiler.profile: CPU activity, and CUDA
    when the run is on the card."""
    from torch import profiler
    acts = [profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(profiler.ProfilerActivity.CUDA)
    with profiler.profile(
            activities=acts,
            on_trace_ready=profiler.tensorboard_trace_handler(profile_dir)):
        return runner.run(options, store, log=log, progress_cb=progress,
                          device=device)


def main():
    sys.exit(execute(sys.argv[1:]))


if __name__ == "__main__":
    main()
