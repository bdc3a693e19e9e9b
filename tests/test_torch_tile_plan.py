"""The staged tile's plan (fabber_core_tpu_torch/ops/_cuda.py tile_plan,
launch_vb) for the kernels that stage their data tile (1, 4, 6, 7 and 8,
csrc/tile.cuh), on the CPU: the VB and shared-memory bytes at T = 1, 7,
8, 100 and at the edge where the tile stops fitting five one-warp
blocks per SM and just past it, for one weight per sample (kernel 8,
kernels 6 and 7 at Q=1), for Q = 2-4 and for kernel 4's P + QP + Q
design rows per sample; the rule at every T up to 1,200 (a staged tile
never leaves fewer than TILE_MIN_WARPS blocks per SM, a streamed T
would); and the C side's refusal rules (tile_bytes, and kernels 7's and
4's iter_smem and whole_smem, compiled as host C++ with g++ through
tests/torch_hostcc.py's shim; skipped without g++) refuse nothing the
plan picks and everything past the hardware's per-block limit. Kernel 1
takes the widest of STATS_WIDTHS whose blocks leave TILE_MIN_WARPS warps
per SM, and its C side (spectral_device.cuh stats_smem, kernel 3's too)
the same bytes."""

import ctypes
import re

import pytest

from fabber_core_tpu_torch.ops import _cuda
from fabber_core_tpu_torch.ops import fused_whole as fw

import torch_hostcc

# csrc/tile.cuh kMaxBlockSmem: the most shared memory one block may take
BLOCK_MAX = 232_448


def smem(nt, vb, nq):
    return 4 * (nt * vb + nt * nq)


@pytest.mark.parametrize("nt,nq,want", [
    (1, 1, (True, 32, smem(1, 32, 1))),
    (7, 1, (True, 32, smem(7, 32, 1))),
    (8, 1, (True, 32, smem(8, 32, 1))),
    (100, 1, (True, 32, 13_200)),
    (100, 4, (True, 32, 14_400)),
    (345, 1, (True, 32, 45_540)),
    (346, 1, (False, 128, 0)),
    (335, 2, (True, 32, smem(335, 32, 2))),
    (336, 2, (False, 128, 0)),
    (326, 3, (True, 32, smem(326, 32, 3))),
    (327, 3, (False, 128, 0)),
    (317, 4, (True, 32, 45_648)),
    (318, 4, (False, 128, 0)),
    (5000, 2, (False, 128, 0))])
def test_tile_plan(nt, nq, want):
    assert _cuda.tile_plan(nt, nq) == want


def blocks_per_sm(b):
    return _cuda.SMEM_PER_SM // (b + _cuda.SMEM_RESERVED)


def test_tile_plan_rule():
    """Staged: one-warp blocks, at least TILE_MIN_WARPS of them per SM
    (the budget: smem <= SMEM_PER_SM / 5 - the reservation), within the
    per-block limit; streamed: fewer would fit; once a T streams, every
    longer one does."""
    for nq in (1, 2, 3, 4):
        streamed = False
        for nt in range(1, 1200):
            staged, vb, b = _cuda.tile_plan(nt, nq)
            if staged:
                assert not streamed
                assert vb == _cuda.TILE_VB == 32 and b == smem(nt, vb, nq)
                assert blocks_per_sm(b) >= _cuda.TILE_MIN_WARPS
                assert b <= _cuda.SMEM_PER_SM // _cuda.TILE_MIN_WARPS \
                    - _cuda.SMEM_RESERVED
                assert b <= BLOCK_MAX
            else:
                streamed = True
                assert (vb, b) == (_cuda.STREAM_THREADS, 0)
                assert blocks_per_sm(smem(nt, 32, nq)) < _cuda.TILE_MIN_WARPS
        assert streamed


def test_launch_vb():
    assert _cuda.launch_vb(100, 1) == 32
    assert _cuda.launch_vb(300, 4) == 32
    assert _cuda.launch_vb(346, 1) == 0
    assert _cuda.launch_vb(100, 1, 0) == 0
    assert _cuda.launch_vb(100, 1, 128) == 128
    assert _cuda.launch_vb(100, 1, 48) == 48     # forced: the C side refuses


@pytest.fixture
def tile_bytes(tmp_path):
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    lib = torch_hostcc.build_source(
        tmp_path, "tile_bytes",
        '#include "cuda_runtime.h"\n#include "tile.cuh"\n'
        'extern "C" long long tb(int vb, int nt, int nw, int max_vb) {\n'
        "  return fabber::tile_bytes(vb, nt, nw, max_vb);\n}\n")
    lib.tb.restype = ctypes.c_longlong
    lib.tb.argtypes = [ctypes.c_int] * 4
    return lambda vb, nt, nw: lib.tb(vb, nt, nw, 128)


def test_c_side_takes_every_plan(tile_bytes):
    for nq in (1, 4):
        for nt in range(1, 1000, 3):
            staged, vb, b = _cuda.tile_plan(nt, nq)
            if staged:
                assert tile_bytes(vb, nt, nt * nq) == b


@pytest.mark.parametrize("vb,nt,nw", [
    (48, 100, 100), (16, 100, 100), (0, 100, 100), (160, 100, 100),
    (256, 10, 10), (128, 500, 500), (32, 1800, 1800)])
def test_c_side_refuses(tile_bytes, vb, nt, nw):
    assert tile_bytes(vb, nt, nw) == -1


def test_c_side_limit(tile_bytes):
    # the largest tile one block may opt in to, and one float more
    nt = (BLOCK_MAX // 4) // 129
    nw = BLOCK_MAX // 4 - nt * 128
    assert tile_bytes(128, nt, nw) == BLOCK_MAX
    assert tile_bytes(128, nt, nw + 1) == -1


# kernel 4 (P, Q) -> its design rows per sample, and the longest T staged
WHOLE_EDGES = [(1, 1, 3, 326), (3, 1, 7, 292), (3, 2, 11, 265),
               (4, 3, 19, 223)]


@pytest.mark.parametrize("p,nq,nw,last", WHOLE_EDGES,
                         ids=[f"P{p}-Q{q}" for p, q, _, _ in WHOLE_EDGES])
def test_whole_tile_plan(p, nq, nw, last):
    """Kernel 4 stages its tile beside its P + QP + Q design rows: at
    T=106 (the main paths' poly) in one-warp blocks, up to the last T
    where five such blocks fit an SM; the next T streams."""
    assert fw.tile_weights(p, nq) == nw
    assert _cuda.tile_plan(106, nw) == (True, 32, 4 * (106 * 32 + 106 * nw))
    assert _cuda.tile_plan(last, nw) == (True, 32, smem(last, 32, nw))
    assert _cuda.tile_plan(last + 1, nw) == (False, 128, 0)
    assert _cuda.launch_vb(106, nw) == 32
    assert _cuda.launch_vb(last + 1, nw) == 0


def _c_function(source, name, ret="long long"):
    """The text of one inline function of a csrc/ source."""
    text = (torch_hostcc.CSRC / source).read_text()
    m = re.search(rf"inline {ret} {name}\(.*?\n}}\n", text, re.S)
    assert m, name
    return m.group(0)


@pytest.fixture
def smem_rules(tmp_path):
    """Kernels 7's and 4's C entry points' shared-memory rules
    (iter_smem, whole_smem: -1 refuses the launch), compiled as host
    C++."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    src = ('#include "cuda_runtime.h"\n#include "tile.cuh"\n'
           "namespace {\nusing namespace fabber;\n"
           "constexpr int kThreads = 128;\n"
           + _c_function("fused_vb_iter.cuh", "iter_smem")
           + _c_function("fused_whole.cu", "whole_smem")
           + "}  // namespace\n"
           'extern "C" long long it(int vb, int nt, int q) {\n'
           "  return iter_smem(vb, nt, q);\n}\n"
           'extern "C" long long wh(int vb, int nt, int nrows) {\n'
           "  return whole_smem(vb, nt, nrows);\n}\n")
    lib = torch_hostcc.build_source(tmp_path, "smem_rules", src)
    for f in (lib.it, lib.wh):
        f.restype = ctypes.c_longlong
        f.argtypes = [ctypes.c_int] * 3
    return lib


def test_c_side_kernels_7_and_4_take_every_plan(smem_rules):
    for nt in range(1, 800, 7):
        for nq in (1, 4):
            staged, vb, b = _cuda.tile_plan(nt, nq)
            assert smem_rules.it(vb if staged else 0, nt, nq) == b
        for p, nq, nw, _ in WHOLE_EDGES:
            staged, vb, b = _cuda.tile_plan(nt, nw)
            want = b if staged else 4 * nw * nt   # streamed: the rows
            assert smem_rules.wh(vb if staged else 0, nt, nw * nt) == want


@pytest.mark.parametrize("vb,nt", [(48, 100), (16, 100), (160, 100),
                                   (256, 10), (128, 500), (32, 1800)])
def test_c_side_kernels_7_and_4_refuse(smem_rules, vb, nt):
    assert smem_rules.it(vb, nt, 1) == -1
    assert smem_rules.wh(vb, nt, 11 * nt) == -1


def test_c_side_whole_streamed_rows_limit(smem_rules):
    """Streamed, kernel 4's block holds the design rows alone: refused
    past a block's 232,448 bytes."""
    assert smem_rules.wh(0, 1000, BLOCK_MAX // 4) == BLOCK_MAX
    assert smem_rules.wh(0, 1000, BLOCK_MAX // 4 + 1) == -1


# -- kernel 1 (spectral_stats.cu): the widest of STATS_WIDTHS --------------

def test_stats_tile_plan():
    """At T=106 kernel 1 stages in blocks of 128 lanes for P = 1..8 (4
    blocks per SM at P=3: 57,240 bytes); at every T up to 1,200 a staged
    plan takes the widest of STATS_WIDTHS whose blocks leave at least
    TILE_MIN_WARPS warps per SM, and a streamed one has none."""
    assert _cuda.STATS_WIDTHS == (128, 64, 32)
    assert _cuda.tile_plan(106, 7, _cuda.STATS_WIDTHS) == (True, 128, 57_240)
    assert blocks_per_sm(57_240) == 4
    for p in range(1, 9):
        nq = 2 * p + 1
        assert _cuda.tile_plan(106, nq, _cuda.STATS_WIDTHS)[:2] == (True,
                                                                    128)
        streamed = False
        for nt in range(1, 1200):
            staged, vb, b = _cuda.tile_plan(nt, nq, _cuda.STATS_WIDTHS)
            fits = [w for w in _cuda.STATS_WIDTHS
                    if blocks_per_sm(smem(nt, w, nq)) * (w // 32)
                    >= _cuda.TILE_MIN_WARPS]
            if staged:
                assert not streamed and vb == fits[0]
                assert b == smem(nt, vb, nq) <= BLOCK_MAX
            else:
                streamed = True
                assert not fits and (vb, b) == (_cuda.STREAM_THREADS, 0)
        assert streamed
    assert _cuda.launch_vb(106, 7, None, _cuda.STATS_WIDTHS) == 128
    assert _cuda.launch_vb(106, 7, 32, _cuda.STATS_WIDTHS) == 32
    assert _cuda.launch_vb(2000, 7, None, _cuda.STATS_WIDTHS) == 0


@pytest.fixture
def stats_smem(tmp_path):
    """Kernels 1's and 3's C entry points' shared-memory rule
    (spectral_device.cuh stats_smem: -1 refuses the launch), compiled as
    host C++."""
    if not torch_hostcc.have_gxx():
        pytest.skip("g++ is not installed")
    src = ('#include "cuda_runtime.h"\n#include "spectral_device.cuh"\n'
           'extern "C" long long ss(int p, int vb, int nt) {\n'
           "  return fabber_spectral::stats_smem(p, vb, nt);\n}\n")
    lib = torch_hostcc.build_source(tmp_path, "stats_smem", src)
    lib.ss.restype = ctypes.c_longlong
    lib.ss.argtypes = [ctypes.c_int] * 3
    return lib.ss


def test_c_side_kernel_1_takes_every_plan(stats_smem):
    for nt in range(1, 1200, 7):
        for p in (1, 3, 8):
            nq = 2 * p + 1
            staged, vb, b = _cuda.tile_plan(nt, nq, _cuda.STATS_WIDTHS)
            want = b if staged else 4 * nq * nt   # streamed: the rows
            assert stats_smem(p, vb if staged else 0, nt) == want


@pytest.mark.parametrize("vb,nt", [(48, 100), (16, 100), (288, 100),
                                   (512, 10), (256, 300), (32, 1700)])
def test_c_side_kernel_1_refuses(stats_smem, vb, nt):
    assert stats_smem(3, vb, nt) == -1
