"""Build and bind the port's native C API (fabber_capi_torch.cc).

The shim and its standalone C host (test_host.c) are compiled at first
use with the system's C and C++ compilers, against the Python that runs
this function, into <repo>/build/capi/<key>/ (libfabber_core_tpu_torch.so
and test_host), where the key is a hash of both sources and the flags.
Each file is written to a temporary name and renamed, so concurrent
first uses do not see a half-written file.

The flags are those of `python3-config --includes` and
`python3-config --ldflags --embed` (capi/Makefile), taken from this
interpreter's sysconfig so they match the Python that will host the
library (a python3-config on the PATH may belong to another one), with
an rpath to libpython's directory. Both link the shared libpython,
which the C host then holds in its global scope for torch's extension
modules; a Python without one is refused.

    from fabber_core_tpu_torch import capi
    lib = capi.load()            # ctypes.CDLL, argtypes declared
    host = capi.build_host()     # path of the C host binary
"""

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import sysconfig
from pathlib import Path

from ..exceptions import FabberError

SRC_DIR = Path(__file__).resolve().parent
SHIM_SOURCE = SRC_DIR / "fabber_capi_torch.cc"
HOST_SOURCE = SRC_DIR / "test_host.c"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "capi"
LIB_NAME = "libfabber_core_tpu_torch.so"
HOST_NAME = "test_host"

_lib = None


def _var(name):
    return str(sysconfig.get_config_var(name) or "")


def python_flags():
    """(includes, ldflags) for this interpreter, as lists of arguments."""
    if _var("Py_ENABLE_SHARED") != "1":
        raise FabberError("the C API embeds a shared libpython, and this "
                          "Python was built without one")
    inc = []
    for key in ("include", "platinclude"):
        flag = "-I" + sysconfig.get_paths()[key]
        if flag not in inc:
            inc.append(flag)
    libdir = _var("LIBDIR")
    return inc, [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                 "-lpython" + _var("LDVERSION"),
                 *shlex.split(_var("LIBS")), *shlex.split(_var("SYSLIBS"))]


def _compiler(env, name):
    cmd = os.environ.get(env) or shutil.which(name)
    if not cmd:
        raise FabberError(f"no {name} compiler (set {env}); the C API is "
                          "built from fabber_core_tpu_torch/capi/ at first "
                          "use")
    return shlex.split(cmd)


def _commands(out_dir):
    inc, ldflags = python_flags()
    lib = out_dir / LIB_NAME
    shim = _compiler("CXX", "c++") + [
        "-O2", "-fPIC", "-Wall", *inc, "-shared", str(SHIM_SOURCE), "-o",
        "{out}", *ldflags]
    host = _compiler("CC", "cc") + [
        "-O2", "-Wall", *inc, str(HOST_SOURCE), "-o", "{out}",
        f"-L{out_dir}", "-l" + LIB_NAME[3:-3], "-Wl,-rpath,$ORIGIN",
        *ldflags]
    return {lib: shim, out_dir / HOST_NAME: host}


def build_dir():
    """build/capi/<key>: the key hashes both sources and every flag."""
    h = hashlib.sha256()
    for src in (SHIM_SOURCE, HOST_SOURCE):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for out, cmd in _commands(Path("<dir>")).items():
        h.update(" ".join([out.name] + cmd).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build(name):
    out_dir = build_dir()
    out = out_dir / name
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{name}.tmp{os.getpid()}")
    cmd = [a.replace("{out}", str(tmp)) for a in _commands(out_dir)[out]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise FabberError(f"building {name} failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build():
    """Path of the shim, compiled if this key has none yet."""
    return _build(LIB_NAME)


def build_host():
    """Path of the standalone C host, linked against the shim."""
    build()
    return _build(HOST_NAME)


def host_env(env=None):
    """Environment for the C host: FABBER_TPU_PYTHONPATH names the
    repository and this interpreter's sys.path entries, so the embedded
    interpreter imports the same packages as this one."""
    import sys
    env = dict(os.environ if env is None else env)
    paths = [str(Path(__file__).resolve().parents[2])] + [
        p for p in sys.path if p and os.path.isdir(p)]
    # the shim inserts each entry at the front of sys.path in turn
    env["FABBER_TPU_PYTHONPATH"] = ":".join(reversed(paths))
    return env


def load():
    """The port's shim as a ctypes.CDLL (built on first call)."""
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def bind(path):
    """A library of the fabber C ABI at path as a ctypes.CDLL (its own
    handle, RTLD_LOCAL), with argtypes and restype declared for every
    exported function."""
    lib = ctypes.CDLL(str(path))
    vp, cp, ui = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint
    fp = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "fabber_new": ([cp], vp),
        "fabber_destroy": ([vp], None),
        "fabber_load_models": ([vp, cp, cp], ctypes.c_int),
        "fabber_set_extent": ([vp, ui, ui, ui,
                               ctypes.POINTER(ctypes.c_int), cp],
                              ctypes.c_int),
        "fabber_set_opt": ([vp, cp, cp, cp], ctypes.c_int),
        "fabber_set_data": ([vp, cp, ui, fp, cp], ctypes.c_int),
        "fabber_get_data_size": ([vp, cp, cp], ctypes.c_int),
        "fabber_get_data": ([vp, cp, fp, cp], ctypes.c_int),
        "fabber_dorun": ([vp, ui, cp, cp, vp], ctypes.c_int),
        "fabber_get_options": ([vp, cp, cp, ui, cp, cp], ctypes.c_int),
        "fabber_model_evaluate": ([vp, ui, fp, ui, fp, fp, cp],
                                  ctypes.c_int),
        "fabber_model_evaluate_output": ([vp, ui, fp, ui, fp, cp, fp, cp],
                                         ctypes.c_int),
    }
    for name in ("fabber_get_models", "fabber_get_methods",
                 "fabber_get_model_params", "fabber_get_model_param_descs",
                 "fabber_get_model_outputs"):
        sigs[name] = ([vp, ui, cp, cp], ctypes.c_int)
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib
