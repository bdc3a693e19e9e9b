"""CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc: without them every test here
skips (the `cuda` fixture decides at run time). On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -q

No jax here: the GPU machine runs the port alone. Bounds are those of
chip_smoke.py (errors over the max |plain| of each quantity).
"""

import numpy as np
import pytest
import torch

from fabber_core_tpu_torch.ops import fused_spectral as fs

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from fabber_core_tpu_torch.ops import _cuda
    _cuda.load()
    return torch.device("cuda", torch.cuda.current_device())


def design(p, nt):
    t = np.arange(1, nt + 1, dtype=np.float64) / nt
    cols = [np.ones(nt)] + [np.cos(np.pi * k * t) for k in range(1, p)]
    return np.stack(cols, axis=1)


def rel(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nt", [30, 106])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
def test_kernels_match_plain_every_p(cuda, p, nt, masked):
    """Every template instantiation (P = 1..8), ragged voxel count."""
    nv = 70_001
    gen = torch.Generator(device=cuda)
    gen.manual_seed(p * 1000 + nt)
    d = design(p, nt)
    q = np.ones(nt)
    if masked:
        q[[1, nt // 3]] = 0.0
    truth = torch.rand((p, nv), generator=gen, device=cuda) * 4 - 2
    data = torch.as_tensor(d, dtype=torch.float32, device=cuda) @ truth
    data += torch.randn((nt, nv), generator=gen, device=cuda)
    tc = fs.pack_mxu_consts(d, q, nt, torch.float32, cuda)
    ac = fs.pack_solve_consts(d, q, nt, torch.float32)
    before = fs.spectral_stats.launches
    ks = fs.spectral_stats(data, tc, ac)
    assert fs.spectral_stats.launches == before + 1
    ps = fs.spectral_stats_plain(data, tc, ac)
    a = ac.reshape(p, p).to(cuda).double()
    assert rel(ks[0], ps[0]) <= 1e-3
    assert rel(ks[1], ps[1]) <= 1e-4
    assert rel(ks[2].double() + a @ ks[0].double(),
               ps[2].double() + a @ ps[0].double()) <= 1e-5

    c_post = (q.sum() - 1) * 0.5 + 1e-6
    sc = fs.pack_spectral_consts(d, q, nt, np.full(p, 0.1), 1e-6, c_post,
                                 1e-8, 50.0, torch.float32,
                                 (-10.0, c_post + 0.5))
    pm = torch.rand((p, nv), generator=gen, device=cuda) - 0.5
    before = fs.spectral_core.launches
    kc = fs.spectral_core(*ps, pm, sc, 10)
    assert fs.spectral_core.launches == before + 1
    pc = fs.spectral_core_plain(*ps, pm, sc, 10)
    for k, r in zip(kc, pc):
        assert k.shape == r.shape
        assert rel(k, r) <= 1e-4


def test_wrappers_check_arguments_on_card(cuda):
    nt, nv, p = 30, 64, 3
    d = design(p, nt)
    q = np.ones(nt)
    tc = fs.pack_mxu_consts(d, q, nt, torch.float32, cuda)
    ac = fs.pack_solve_consts(d, q, nt, torch.float32)
    data = torch.zeros((nt, nv), device=cuda)
    with pytest.raises(TypeError):
        fs.spectral_stats(data.double(), tc, ac)
    with pytest.raises(ValueError, match="host"):
        fs.spectral_stats(data, tc, ac.to(cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fs.spectral_stats(torch.zeros((nv, nt), device=cuda).t(), tc, ac)
    with pytest.raises(ValueError, match="is on"):
        fs.spectral_stats(data, tc.cpu(), ac)


def test_engine_on_card_matches_cpu(cuda):
    from fabber_core_tpu_torch.inference.vb import VBInference
    from fabber_core_tpu_torch.models import get_model_class
    from fabber_core_tpu_torch.options import RunOptions

    rng = np.random.default_rng(0)
    nv, nt = 3000, 30
    t = np.arange(1, nt + 1)
    data = (rng.uniform(-1, 1, (nv, 1)) + rng.uniform(-.05, .05, (nv, 1)) * t
            + 0.1 * rng.standard_normal((nv, nt))).astype(np.float32)
    res = {}
    for dev in (cuda, "cpu"):
        opts = RunOptions({"model": "poly", "degree": "2", "noise": "white",
                           "dtype": "single", "print-free-energy": True})
        res[str(dev)] = VBInference(get_model_class("poly")(opts), opts,
                                    data, device=dev).run()
    g, c = res[str(cuda)], res["cpu"]
    sd = np.sqrt(np.diagonal(c.cov, axis1=1, axis2=2))
    assert np.max(np.abs(g.means - c.means) / sd) < 5e-3
    np.testing.assert_allclose(g.cov, c.cov, rtol=2e-3, atol=1e-7)
    np.testing.assert_allclose(g.noise_means, c.noise_means, rtol=1e-3)
    np.testing.assert_allclose(g.free_energy, c.free_energy, rtol=1e-3,
                               atol=5e-3)
    np.testing.assert_array_equal(g.iterations, c.iterations)
    assert not g.bad_voxels.any()
