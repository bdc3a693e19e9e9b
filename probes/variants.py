"""Builds of one kernel source with other nvcc flags, for the probes.

build(source, flags, srcdir) compiles one csrc/*.cu alone, or a patched
copy of one in srcdir (probes/csrc/ keeps those: its headers first, then
csrc/'s), with ops/_cuda.py's NVCC_FLAGS, then flags, into
build/kernels/variants/, a library of its own named by a hash of the
sources, the headers and the flags, and
returns (path, seconds, nvcc's output). swap(path, names) loads it and
makes ops/_cuda.load() return the main library with the C entry points
`names` taken from it (their argtypes and restype copied), so the
wrappers in ops/ launch the variant; restore() undoes that. One
variant's nvcc takes seconds where the whole library takes about a
minute, and several build in parallel (build_all).
"""

import ctypes
import hashlib
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


# the patched copies of kernel sources that the probes build
PATCHED = Path(__file__).resolve().parent / "csrc"


def _cuda():
    from fabber_core_tpu_torch.ops import _cuda
    return _cuda


def library_path(source, flags, srcdir=None):
    c = _cuda()
    srcdir = Path(srcdir or c.CSRC)
    h = hashlib.sha256(" ".join(c.NVCC_FLAGS + list(flags)).encode())
    h.update((srcdir / source).read_bytes())
    for name in c.SOURCES + c.HEADERS:   # a patched copy may include one
        h.update(name.encode())
        h.update((c.CSRC / name).read_bytes())
    for extra in sorted(srcdir.glob("*.cuh")):   # a patched copy's own
        h.update(extra.read_bytes())
    stem = source.rsplit(".", 1)[0]
    return c.BUILD_DIR / "variants" / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build(source, flags, srcdir=None):
    """(path, seconds, nvcc output) of source (in srcdir, default csrc/;
    its headers from srcdir, then csrc/) built with flags; raises with
    nvcc's output when it fails."""
    c = _cuda()
    srcdir = Path(srcdir or c.CSRC)
    out = library_path(source, flags, srcdir)
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [c._nvcc(), *c.NVCC_FLAGS, *flags, "-I", str(c.CSRC), "-shared",
           "-o", str(out), str(srcdir / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} {flags}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return out, secs, proc.stdout + proc.stderr


def build_all(jobs):
    """{key: build(*job)} for jobs {key: (source, flags[, srcdir])}, all
    nvcc processes started together."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(build, *job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


class _Swapped:
    """The main library with some entry points from a variant's."""

    def __init__(self, main, var, names):
        self._main, self._var, self._names = main, var, set(names)

    def __getattr__(self, name):
        return getattr(self._var if name in self._names else self._main,
                       name)


_main = None


def swap(path, names):
    """Launch the entry points `names` from the library at path."""
    global _main
    c = _cuda()
    if _main is None:
        _main = c.load()
    var = ctypes.CDLL(str(path))
    for n in names:
        f, g = getattr(var, n), getattr(_main, n)
        f.argtypes, f.restype = g.argtypes, g.restype
    c._lib = _Swapped(_main, var, names)


def restore():
    """The main library again."""
    if _main is not None:
        _cuda()._lib = _main


def sass_counts(path, kernel, parts, opcodes=("FFMA", "FMUL", "FADD",
                                              "MUFU", "MUFU.RSQ"),
                function=None):
    """Instruction counts of one kernel entry of the library at path,
    from cuobjdump's SASS: the entry whose mangled name holds kernel and
    every string of parts. Returns {"total": n, op: n, ..., "loop":
    {...}} where "loop" counts the body of the widest backward branch
    (the iteration loop, with the jitter-retry Cholesky it branches
    over: 2P MUFU.RSQ per step, so their count over 2P is the number of
    steps nvcc unrolled into it), or None when cuobjdump is absent. An
    opcode with a dot counts that exact form, one without any form.
    function, the entry's mangled name, has cuobjdump disassemble that
    entry alone (a whole library takes it most of a minute)."""
    tool = shutil.which("cuobjdump") or str(
        Path(_cuda()._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    only = [] if function is None else ["--function", function]
    text = subprocess.run([tool, "--dump-sass", *only, str(path)],
                          capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]
                 and all(p in f.split("\n", 1)[0] for p in parts)), None)
    if body is None:
        return {"error": f"no entry {kernel} {parts}"}
    ins, labels = [], {}
    pending = []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        addr, asm = int(m.group(1), 16), m.group(2)
        for lb in pending:
            labels[lb] = addr
        pending = []
        asm = re.sub(r"^@!?U?P[T0-9]+\s+", "", asm.strip())
        op = asm.split()[0] if asm else ""
        ins.append((addr, op, asm))

    def count(rows):
        out = {"total": len(rows)}
        for o in opcodes:
            out[o] = sum(1 for _, op, _ in rows
                         if (op if "." in o else op.split(".")[0]) == o)
        return out

    res = count(ins)
    best = None
    for addr, op, asm in ins:
        if op.split(".")[0] != "BRA":
            continue
        t = re.search(r"`\((\.L_x_\d+)\)", asm)
        tgt = labels.get(t.group(1)) if t else None
        if tgt is None:
            h = re.search(r"0x([0-9a-f]+)", asm)
            tgt = int(h.group(1), 16) if h else None
        if tgt is not None and tgt < addr and (
                best is None or addr - tgt > best[1] - best[0]):
            best = (tgt, addr)
    if best is not None:
        res["loop"] = count([r for r in ins if best[0] <= r[0] <= best[1]])
    return res


def _unhashed(text):
    """text with nvcc's per-file anonymous-namespace tags (which hash the
    source's path) reduced to the file's name."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?)_[0-9a-f]{8}",
                  r"_GLOBAL__N__\1", text)


def entry_key(name):
    """A kernel entry's mangled name up to its template arguments' end
    (the parameter list dropped: a parameter block's type may be spelt
    anew, as VBParamsFor<P> is, with the same layout and code)."""
    cut = name.find("EEv")
    return name if cut < 0 else name[:cut + 3]


def sass_text(path):
    """{kernel entry (entry_key): [instruction, ...]} of the library at
    path (cuobjdump --dump-sass; addresses, labels and the anonymous
    namespace's path hash dropped), or None when cuobjdump is absent."""
    tool = shutil.which("cuobjdump") or str(
        Path(_cuda()._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return None
    text = _unhashed(subprocess.run([tool, "--dump-sass", str(path)],
                                    capture_output=True, text=True).stdout)
    out = {}
    for f in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = f.split("\n", 1)
        out[entry_key(name.strip())] = [
            re.sub(r"`\(\.L_x_\d+\)", "L", m.group(1).strip())
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", body)]
    return out
