"""The staged tile's plan (fabber_core_tpu_torch/ops/_cuda.py tile_plan,
launch_vb) for the whole-loop kernels 6 and 8 (csrc/tile.cuh), on the
CPU: the VB and shared-memory bytes at T = 1, 7, 8, 100 and at the edge
where the tile stops fitting five one-warp blocks per SM and just past
it, for one weight per sample (kernel 8, kernel 6 at Q=1) and for Q =
2-4; the rule at every T up to 1,200 (a staged tile never leaves fewer
than TILE_MIN_WARPS blocks per SM, a streamed T would); and the C
side's refusal rule (tile_bytes, compiled as host C++ with g++ through
tests/torch_hostcc.py's shim; skipped without g++) refuses nothing the
plan picks and everything past the hardware's per-block limit."""

import ctypes

import pytest

from fabber_core_tpu_torch.ops import _cuda

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
