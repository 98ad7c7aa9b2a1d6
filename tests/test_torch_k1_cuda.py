"""K1's CUDA kernel against its plain PyTorch version on the card.

Needs an NVIDIA GPU with nvcc (the kernel has no CPU or interpret mode), so
these tests skip elsewhere; they import no JAX so they run on the GPU host:
``python -m pytest --noconftest -q -m cuda tests/test_torch_k1_cuda.py``. The kernel
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


def _soup(seed, n, dev, n_attr=20, spread=2.5, n_large=0):
    """n seeded triangles around the view axis (the first 8 cross the near
    plane, so their second halves go to the big block), the last ``n_large``
    of them 8x larger; ``spread`` is the half-width of the centres."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-spread, -spread, -8.0], [spread, spread, -2.0], size=(n, 1, 3))
    scale = rng.uniform(0.05, 0.5, (n, 1, 1))
    scale[n - n_large:] *= 8.0
    corners = centers + scale * rng.normal(size=(n, 3, 3))
    corners[:8, 2, 2] = 1.0
    pos9 = torch.tensor(corners.reshape(n, 9), dtype=torch.float32, device=dev)
    active = torch.tensor(rng.uniform(size=n) < 0.9, device=dev)
    attrs = torch.tensor(rng.normal(size=(n, 3 * n_attr)), dtype=torch.float32, device=dev)
    return pos9, active, attrs


def _assert_attributes_equal(b, n_attr):
    """The attribute kernel against its plain version: z and valid equal,
    interp and near within 1e-5 (chip_smoke.py's ATTR_ATOL)."""
    got, ref = rp.raster_attributes(b, n_attr), rp.raster_attributes_plain(b, n_attr)
    assert torch.equal(got[2], ref[2])
    assert torch.equal(got[3], ref[3])
    for g, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    return got


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


# edge cases of the kernels' staging and run layout: (seed, triangles, centre
# spread, large triangles, A, height, width, k_per_range)
EDGE_CASES = {
    # crowded centre: windows full at k_per_range 256 and overflowing, plus
    # large triangles and near-plane quad halves in the big block
    "full_windows": (3, 12000, 0.25, 400, 20, 256, 256, 256),
    # payload rows of 12 + 3*7 = 33 floats: no 16-byte aligned row
    "odd_attr": (4, 3000, 2.5, 0, 7, 200, 248, 64),
    # odd width and height: ragged right and bottom tiles; with an odd A the
    # rows' runs start off 16-byte alignment (scalar heads and tails)
    "odd_size": (5, 3000, 2.5, 40, 5, 201, 247, 64),
    # fewer tiles than the card's 132 SMs
    "small_view": (6, 600, 2.5, 10, 20, 64, 64, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("tile", [16, 32])
def test_kernel_edge_cases_match_plain(cuda_device, case, tile):
    seed, n, spread, n_large, n_attr, h, w, k = EDGE_CASES[case]
    pos9, active, attrs = _soup(seed, n, cuda_device, n_attr, spread, n_large)
    vp = perspective_projection_matrix(1.0, w / h, 0.1, 100.0, device=cuda_device)
    rp.LAUNCHES.reset()
    bd = rp.bin_depth_pos(pos9, active, vp, h, w, tile=tile, k_per_range=k,
                          cull_backfaces=False)
    depth = rp.raster_depth(bd)
    assert torch.equal(depth, rp.raster_depth_plain(bd))
    ba, a = rp.bin_attributes_pos(pos9, active, attrs, vp, h, w, tile=tile, k_per_range=k,
                                  cull_backfaces=False)
    assert a == n_attr
    got = _assert_attributes_equal(ba, a)
    # the depth kernel on the attribute payload: rows of 12 + 3A floats
    assert torch.equal(rp.raster_depth(ba), rp.raster_depth_plain(ba))
    assert rp.LAUNCHES == {"k1_raster_depth": 2, "k1_raster_attributes": 1}
    assert bool((depth < 1.0).any()) and bool(got[3].any())
    if case == "full_windows":
        assert int(ba.ranges[:, 4:].max()) == k and int(ba.n_drop) > 0
        assert int(ba.big_have.sum()) > 0 and int(bd.big_have.sum()) > 0
    elif case == "odd_attr":
        assert ba.rows % 4 == 1
    elif case == "odd_size":
        assert h % tile and w % tile and (w * n_attr) % 4
    else:
        assert ba.th * ba.tw < 132
