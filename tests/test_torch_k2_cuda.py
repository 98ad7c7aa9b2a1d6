"""K2's CUDA kernels against their plain PyTorch versions on the card: the
labels kernel at every G (the split checks of the chunked bench scenes at
64³ and 128³ included, where ``connected_component_labels`` routes to it on
the card), the sweep kernels (K2 while its buffers fit a block's shared
memory, to 38³; K2-wide past it).

Needs an NVIDIA GPU with nvcc (the kernel has no CPU or interpret mode), so
these tests skip elsewhere; they import no JAX, so they run on the GPU host:
``python -m pytest --noconftest -q -m cuda tests/test_torch_k2_cuda.py``.
Labels and sweep counts are integers: they must be equal; the two-level
labelling at 64³ must equal the flat sweep's; the labels kernel's atomics
may run in any order, so two calls on the same grids must be equal too."""

import numpy as np
import pytest
import torch

from impact_tpu_torch.ops import ccl_pallas as k2
from impact_tpu_torch.voxel import interaction
from impact_tpu_torch.voxel.interaction import (
    connected_component_labels,
    connected_component_labels_two_level,
)


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
    two = connected_component_labels_two_level(occ)
    assert torch.equal(two, k2.connected_component_labels_batched(occ))
    assert torch.equal(two.cpu(), connected_component_labels(occ.cpu()))


def _carved_asteroid(g, cuda_device):
    """Occupancy of the filled chunked bench scene's live objects after two
    carving steps (the carve splits the asteroid)."""
    from impact_tpu_torch.models.bench import bench_chunked_config, bench_chunked_fill_scene
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.voxel.object import occupancy

    cfg = bench_chunked_config(g)
    rt = HeadlessRuntime(compile_scene(bench_chunked_fill_scene(g), cfg, device=cuda_device),
                         cfg, enable_fracturing=False)
    rt.step(2)
    v = rt.sim.voxels
    return occupancy(v)[v.alive]


@pytest.mark.cuda
@pytest.mark.parametrize("g,nb", [(64, 4), (128, 2)])
@pytest.mark.parametrize("what", ["carved asteroid", "serpentine, full, empty"])
def test_labels_kernel_on_chunked_grids(cuda_device, g, nb, what):
    """The split checks' grids of the chunked bench: the labels kernel
    equals the two-level plain labelling (the CPU path) on the card."""
    if what == "carved asteroid":
        occ = _carved_asteroid(g, cuda_device)
        snake = torch.tensor(_grids(g, 0)[4], device=cuda_device)
        occ = torch.cat([occ, snake[None].expand(nb, g, g, g)])[:nb].contiguous()
    else:
        occ = torch.tensor(_grids(g, 0)[[4, 6, 5, 5][:nb]], device=cuda_device)
    k2.LAUNCHES.reset()
    got = k2.connected_component_labels_batched(occ)
    ref = connected_component_labels_two_level(occ)
    torch.cuda.synchronize()
    assert k2.LAUNCHES["k2_labels"] == 1
    assert torch.equal(got, ref)
    assert int((got >= 0).sum()) > 0


@pytest.mark.cuda
def test_routing_at_64_reaches_labels_kernel(cuda_device, monkeypatch):
    """``connected_component_labels`` on a CUDA 64³ batch launches the labels
    kernel and never runs the two-level labelling."""
    def refuse(occ):
        raise AssertionError("the two-level labelling ran on the card")

    monkeypatch.setattr(interaction, "connected_component_labels_two_level", refuse)
    occ = torch.tensor(_grids(64, 2)[[0, 1, 2, 4]], device=cuda_device)
    k2.LAUNCHES.reset()
    got = connected_component_labels(occ)
    torch.cuda.synchronize()
    assert dict(k2.LAUNCHES) == {"k2_labels": 1, "k2_ccl": 0, "k2_ccl_wide": 0,
                                  "k2_labels_slab": 0}
    assert torch.equal(got.cpu(), k2.connected_component_labels_batched(occ).cpu())


def _edge_grids(g, seed):
    """_grids plus a checkerboard (every voxel its own component) and one
    voxel at each corner."""
    i, j, k = np.indices((g, g, g))
    corners = np.zeros((g, g, g), bool)
    corners[::g - 1, ::g - 1, ::g - 1] = True
    return np.concatenate([_grids(g, seed), np.stack([(i + j + k) % 2 == 0, corners])])


@pytest.mark.cuda
@pytest.mark.parametrize("g", [8, 16, 31, 32, 33, 38, 39, 40, 41, 48, 63, 72])
def test_labels_kernel_matches_plain(cuda_device, g):
    occ = torch.tensor(_edge_grids(g, g), device=cuda_device)
    k2.LAUNCHES.reset()
    got = k2.connected_component_labels_batched(occ)
    again = k2.connected_component_labels_batched(occ)
    ref = k2.connected_component_labels_plain(occ)
    torch.cuda.synchronize()
    assert dict(k2.LAUNCHES) == {"k2_labels": 2, "k2_ccl": 0, "k2_ccl_wide": 0,
                                  "k2_labels_slab": 0}
    assert got.dtype == torch.int32 and got.shape == occ.shape
    assert torch.equal(got, ref)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [0, 1, 4])
def test_labels_kernel_batches(cuda_device, nb):
    occ = torch.tensor(_edge_grids(33, 5)[-nb:] if nb else np.zeros((0, 33, 33, 33), bool),
                       device=cuda_device)
    got = k2.connected_component_labels_batched(occ)
    again = k2.connected_component_labels_batched(occ)
    assert got.shape == occ.shape
    assert torch.equal(got, k2.connected_component_labels_plain(occ))
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [39, 40])
def test_sweeps_past_shared_memory(cuda_device, g):
    """The shared-memory sweep kernel's buffers outgrow a block's 232,448
    bytes at G = 39 (u16 labels would still fit): these grids take K2-wide."""
    occ = torch.tensor(_grids(g, g), device=cuda_device)
    lab0 = k2.initial_labels(occ)
    for n in (16, g ** 3):
        k2.LAUNCHES.reset()
        got, got_sw = k2.ccl_sweeps(occ, lab0, n)
        ref, ref_sw = k2.ccl_sweeps_plain(occ, lab0, n)
        torch.cuda.synchronize()
        assert k2.LAUNCHES["k2_ccl"] == 0 and k2.LAUNCHES["k2_ccl_wide"] >= 1
        assert torch.equal(got, ref)
        assert torch.equal(got_sw, ref_sw)
