"""K2's CUDA kernels (K2 to 40³, K2-wide from 41³) against their plain
PyTorch version on the card.

Needs an NVIDIA GPU with nvcc (the kernel has no CPU or interpret mode), so
these tests skip elsewhere; they import no JAX, so they run on the GPU host:
``python -m pytest --noconftest -q -m cuda tests/test_torch_k2_cuda.py``.
Labels and sweep counts are integers: they must be equal; the two-level
labelling at 64³ must equal the flat sweep's."""

import numpy as np
import pytest
import torch

from impact_tpu_torch.ops import ccl_pallas as k2
from impact_tpu_torch.voxel.interaction import connected_component_labels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _grids(g, seed):
    rng = np.random.default_rng(seed)
    grids = [rng.uniform(size=(g, g, g)) < f for f in (0.2, 0.35, 0.5, 0.7)]
    snake = np.zeros((g, g, g), bool)
    snake[0::2, :, 0] = True
    for i in range(1, g, 2):
        snake[i, g - 1 if (i // 2) % 2 == 0 else 0, 0] = True
    grids += [snake, np.zeros((g, g, g), bool), np.ones((g, g, g), bool)]
    return np.stack(grids)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [8, 16, 32, 41, 48, 63])
@pytest.mark.parametrize("max_sweeps", [1, 16, 17, None])
def test_kernel_matches_plain_on_card(cuda_device, g, max_sweeps):
    occ = torch.tensor(_grids(g, g), device=cuda_device)
    lab0 = k2.initial_labels(occ)
    n = g ** 3 if max_sweeps is None else max_sweeps
    k2.LAUNCHES.reset()
    got, got_sw = k2.ccl_sweeps(occ, lab0, n)
    ref, ref_sw = k2.ccl_sweeps_plain(occ, lab0, n)
    torch.cuda.synchronize()
    if g ** 3 <= k2.MAX_GRID_VOXELS:
        assert k2.LAUNCHES["k2_ccl"] == 1 and k2.LAUNCHES["k2_ccl_wide"] == 0
    else:  # one K2-wide call per group of up to 16 sweeps
        assert k2.LAUNCHES["k2_ccl"] == 0 and k2.LAUNCHES["k2_ccl_wide"] >= 1
    assert torch.equal(got, ref)
    assert torch.equal(got_sw, ref_sw)


@pytest.mark.cuda
def test_kernel_takes_arbitrary_start_labels(cuda_device):
    """Labels need not start at the linear index: any values in [0, G³]."""
    g = 16
    rng = np.random.default_rng(3)
    occ = torch.tensor(rng.uniform(size=(2, g, g, g)) < 0.5, device=cuda_device)
    lab0 = torch.tensor(rng.integers(0, g ** 3 + 1, size=(2, g, g, g)), dtype=torch.int32,
                        device=cuda_device)
    for n in (3, g ** 3):
        got = k2.ccl_sweeps(occ, lab0, n)
        ref = k2.ccl_sweeps_plain(occ, lab0, n)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_labels_wrapper_on_card(cuda_device):
    occ = torch.tensor(_grids(32, 0), device=cuda_device)
    got = k2.connected_component_labels_batched(occ)
    ref = k2.connected_component_labels_batched(occ.cpu())
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_two_level_on_card_equals_flat(cuda_device):
    occ = torch.tensor(_grids(64, 1)[[0, 1, 2, 4]], device=cuda_device)
    two = connected_component_labels(occ)
    assert torch.equal(two, k2.connected_component_labels_batched(occ))
    assert torch.equal(two.cpu(), connected_component_labels(occ.cpu()))
