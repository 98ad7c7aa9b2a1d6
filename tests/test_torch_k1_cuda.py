"""K1's CUDA kernel against its plain PyTorch version on the card.

Needs an NVIDIA GPU with nvcc (the kernel has no CPU or interpret mode), so
these tests skip elsewhere; they import no JAX so they run on the GPU host:
``python -m pytest -q -m cuda tests/test_torch_k1_cuda.py``. The kernel
evaluates the same planes with the same float32 rounding as the plain
version, so results must agree exactly up to 1e-5 (interpolation sums)."""

import numpy as np
import pytest
import torch

from impact_tpu_torch.render import raster_pallas as rp
from impact_tpu_torch.geometry.projection import perspective_projection_matrix


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _soup(seed, n, dev):
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-2.5, -2.5, -8.0], [2.5, 2.5, -2.0], size=(n, 1, 3))
    corners = centers + rng.uniform(0.05, 0.5, (n, 1, 1)) * rng.normal(size=(n, 3, 3))
    corners[:8, 2, 2] = 1.0
    pos9 = torch.tensor(corners.reshape(n, 9), dtype=torch.float32, device=dev)
    active = torch.tensor(rng.uniform(size=n) < 0.9, device=dev)
    attrs = torch.tensor(rng.normal(size=(n, 60)), dtype=torch.float32, device=dev)
    return pos9, active, attrs


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tile", [16, 32])
def test_kernel_matches_plain_on_card(cuda_device, seed, tile):
    pos9, active, attrs = _soup(seed, 3000, cuda_device)
    vp = perspective_projection_matrix(1.0, 1.0, 0.1, 100.0, device=cuda_device)
    rp.LAUNCHES.reset()
    b = rp.bin_depth_pos(pos9, active, vp, 200, 248, tile=tile, k_per_range=64,
                         big_budget=64, cull_backfaces=False)
    assert torch.equal(rp.raster_depth(b), rp.raster_depth_plain(b))
    b, a = rp.bin_attributes_pos(pos9, active, attrs, vp, 200, 248, tile=tile, k_per_range=64,
                                 big_budget=64, cull_backfaces=False)
    got, ref = rp.raster_attributes(b, a), rp.raster_attributes_plain(b, a)
    assert torch.equal(got[3], ref[3])
    for g, r in zip(got[:3], ref[:3]):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    assert rp.LAUNCHES == {"k1_raster_depth": 1, "k1_raster_attributes": 1}
