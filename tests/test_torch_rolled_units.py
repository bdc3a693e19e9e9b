"""The per-shape nonlinear units past ops/_cuda.py rolled_loops' sizes,
without nvcc: their inverse, their flags and what a launch builds.

  inverse       csrc/vb_device.cuh inverse_from_chol builds L^-1 in cov's
                storage, with no local array of its own: optimized, the
                CUDA 12.9 toolkit laid that array's local-memory slot over
                the caller's factor in a unit whose loops are rolled, and
                every lane of kernel 6 under trialmode came out non-finite
                (probes/wide_nl.py --bisect, --repair;
                probes/csrc/inverse_local.cuh keeps the faulty form). The
                form is held here, and the in-place arithmetic at double
                (g++, the loops rolled and unrolled) against numpy;
  flags         no unit and no generated functor is built with -G;
  units         a launch builds the one unit of its kernel (kernel 8's
                without Q); kernel 7 takes the form its unit says it
                compiled (kIterCoop: the cooperative one past
                rolled_loops' sizes, launched with vb 0).
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from fabber_core_tpu_torch.models.base import KERNEL_POLY, KernelModel
from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.ops import fused_vb as fv

import torch_hostcc

ROOT = Path(__file__).resolve().parents[1]


def _function(text, name):
    """The text of the template function name in text, head to brace."""
    start = text.index(f"void {name}(")
    start = text.rindex("template <", 0, start)
    depth, i = 0, text.index("{", start)
    while True:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
        if depth == 0:
            return text[start:i]


def test_inverse_from_chol_keeps_no_local_array():
    """The repaired form: L^-1 in cov's storage. The faulty form kept in
    probes/csrc/inverse_local.cuh is the one with a local array."""
    def local_arrays(body):
        return re.findall(r"^\s*float\s+\w+\[[^\]]+\];", body, re.M)
    fixed = _function((_cuda.CSRC / "vb_device.cuh").read_text(),
                      "inverse_from_chol")
    assert local_arrays(fixed) == []
    assert "float* const invl = cov;" in fixed
    faulty = _function((ROOT / "probes" / "csrc" /
                        "inverse_local.cuh").read_text(),
                       "inverse_from_chol")
    assert local_arrays(faulty) == ["  float invl[P * (P + 1) / 2];"]


@pytest.fixture(scope="module")
def inverse_lib(tmp_path_factory):
    """inverse_from_chol<P> for P in PS at double, from the headers as the
    kernels compile them: with the loops unrolled and rolled
    (FABBER_ROLL_LOOPS, in a unit of its own)."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    libs = {}
    for rolled in (False, True):
        d = tmp_path_factory.mktemp("inverse")
        src = ("#define FABBER_ROLL_LOOPS\n" if rolled else "") + \
            '#include "cuda_runtime.h"\n#include "vb_device.cuh"\n' + "".join(
                f'extern "C" void inv{p}(const double* ch, double* cov) '
                f"{{ fabber::inverse_from_chol<{p}>(ch, cov); }}\n"
                f'extern "C" void inv{p}r(const double* ch, double* cov) '
                f"{{ fabber::inverse_from_chol<{p}, true>(ch, cov); }}\n"
                for p in PS)
        libs[rolled] = torch_hostcc.build_source(d, "inverse", src)
    return libs


PS = (1, 3, 10, 24, 44)


def packed(m):
    p = m.shape[0]
    return np.array([m[i, j] for i in range(p) for j in range(i + 1)])


@pytest.mark.parametrize("rolled", [False, True], ids=["unrolled", "rolled"])
@pytest.mark.parametrize("p", PS)
def test_inverse_in_place_matches_numpy(inverse_lib, p, rolled):
    """The packed inverse from the factor, both divisions (BY_RECIP or
    not), within 1e-12 of numpy's inverse of a well-conditioned SPD
    matrix, the factor left as it was."""
    rng = np.random.default_rng(p)
    a = rng.standard_normal((p, p))
    spd = a @ a.T + p * np.eye(p)
    ch = packed(np.linalg.cholesky(spd))
    ref = packed(np.linalg.inv(spd))
    for name in (f"inv{p}", f"inv{p}r"):
        fn = getattr(inverse_lib[rolled], name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = None
        c = ch.copy()
        cov = np.full_like(ref, np.nan)
        fn(c.ctypes.data, cov.ctypes.data)
        assert np.array_equal(c, ch)
        assert np.abs(cov - ref).max() <= 1e-12 * np.abs(ref).max()


def test_no_unit_builds_with_debug_code():
    """Every per-shape unit (each family, each nonlinear unit, rolled or
    not) and every generated functor builds with its source's flags
    alone: no -G, nothing of the kind."""
    assert not hasattr(_cuda, "ROLL_FLAGS")
    for family, (sources, _) in _cuda.INSTANCE_FAMILIES.items():
        for src in sources:
            assert "-G" not in _cuda.SOURCE_FLAGS.get(src, [])
    for kernel in _cuda.GEN_KERNELS:
        assert "-G" not in _cuda._gen_flags(kernel)
    assert "-G" not in _cuda.NVCC_FLAGS


@pytest.mark.parametrize("name,kernel,q", [
    ("fused_nl_loop", "nl_loop", 4), ("nl_occupancy", "nl_loop", 4),
    ("fused_vb_iter", "vb_iter", 4), ("vb_iter_occupancy", "vb_iter", 4),
    ("vb_iter_coop", "vb_iter", 4), ("fused_nlls", "nlls", 1),
    ("nlls_occupancy", "nlls", 1)])
def test_a_launch_builds_its_own_unit(monkeypatch, name, kernel, q):
    """_nl_entry builds the one unit whose entry point a launch asks for
    (kernel 8's at Q = 1), keyed by (kernel, kind, P, Q)."""
    built = []

    class Lib:
        def __getattr__(self, attr):
            return attr

    monkeypatch.setattr(_cuda, "has_nl_instance", lambda *a: False)
    monkeypatch.setattr(_cuda, "has_nlls_instance", lambda *a: False)
    monkeypatch.setattr(_cuda, "build_instance",
                        lambda *a: built.append(a) or Lib())
    nq = None if kernel == "nlls" else 4
    fn, inst = _cuda._nl_entry(1, 24, nq, name)
    assert fn == f"fabber_inst_{name}" and inst
    assert built == [("nl", 24, q, 1, kernel)]


@pytest.mark.parametrize("p,nq,coop", [(10, 1, False), (16, 1, False),
                                       (18, 1, True), (8, 35, True),
                                       (44, 1, True), (143, 35, True)])
def test_cooperative_form_takes_no_tile(monkeypatch, p, nq, coop):
    """Kernel 7's launch takes the form its unit says it compiled
    (fabber_inst_vb_iter_coop, fabber_gen_vb_iter_coop: the header's
    kIterCoop, true where the unit defines FABBER_ROLL_LOOPS, past
    rolled_loops' sizes): the cooperative form with vb 0 (it reads the
    plane where it is; its C entry refuses another vb), whatever form a
    caller forces; the per-lane form the tile plan's vb, or the forced
    one. Here each stand-in unit answers from the source a build would
    compile."""
    class Unit:
        def __init__(self, text):
            self.coop = int("#define FABBER_ROLL_LOOPS" in text)

        def fabber_inst_vb_iter_coop(self):
            return self.coop

        def fabber_gen_vb_iter_coop(self):
            return self.coop

    def build(family, p, q, kind, kernel):
        return Unit(_cuda.instance_sources(family, p, q, kind,
                                           kernel)["fused_vb_iter"])

    class Model:
        def kernel_model(self):
            return KernelModel(KERNEL_POLY, p)

    class Functor:
        nparams = p
        libs = {("vb_iter", nq): Unit(_cuda.generated_source("", p, nq,
                                                             "vb_iter"))}

    monkeypatch.setattr(_cuda, "has_nl_instance", lambda *a: False)
    monkeypatch.setattr(_cuda, "build_instance", build)
    for functor in (None, Functor()):
        assert fv.iteration_form(Model(), nq, 100, functor) == (
            (True, 0) if coop else (False, _cuda.launch_vb(100, nq)))
        assert fv.iteration_form(Model(), nq, 100, functor, 64) == (
            (True, 0) if coop else (False, 64))
    # the prebuilt library's instances are per lane, and every unit's C
    # entry answers from kIterCoop
    monkeypatch.setattr(_cuda, "has_nl_instance", lambda *a: True)
    assert fv.iteration_form(Model(), nq, 100) == (
        False, _cuda.launch_vb(100, nq))
    answer = "_vb_iter_coop() { return kIterCoop ? 1 : 0; }"
    assert f"int fabber_inst{answer}" in (
        _cuda.CSRC / "fused_vb_iter.cu").read_text()
    assert f"int fabber_gen{answer}" in _cuda.generated_source(
        "", p, nq, "vb_iter")
