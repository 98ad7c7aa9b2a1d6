"""P1 and P2's CUDA kernels against their plain PyTorch versions on the
card.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU or interpret mode), so
these tests skip elsewhere; they import no JAX, so they run on the GPU host:
``python -m pytest --noconftest -q -m cuda tests/test_torch_probe_cuda.py``.
Bars: P1's outputs equal (plane evaluations round as the plain version's,
and select adds the same two columns in the same order); P2's float32
variants equal, its TF32 variants within the repo's raster bars (coverage
equal on 0.99 of the pixels, z within 2e-3 where both cover)."""

import pytest
import torch

from impact_tpu_torch.devtools import probe_kernel_ablate as p2
from impact_tpu_torch.devtools import probe_kernel_floor as p1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", p1.MODES)
def test_p1_matches_plain_on_card(cuda_device, mode):
    ranges, payload = p1.reference_inputs(cuda_device, seed=1, n_tiles=480)
    ranges[240:, 2] = 130  # window 0 skips block 2 ...
    ranges[360:, 3] = 100  # ... and window 1 blocks 1 and 2
    got = p1.probe_floor(mode, ranges, payload)
    torch.cuda.synchronize()
    assert torch.equal(got, p1.probe_floor_plain(mode, ranges, payload))


@pytest.mark.cuda
@pytest.mark.parametrize("flip", [False, True], ids=["as_written", "clip_z_negated"])
@pytest.mark.parametrize("name,kw", p2.VARIANTS, ids=[n for n, _ in p2.VARIANTS])
def test_p2_matches_plain_on_card(cuda_device, flip, name, kw):
    inp = p2.reference_inputs(cuda_device, seed=2, flip_clip_z=flip, n=65536, size=256,
                              size_scale=8.0)
    got = p2.probe_ablate(inp, **kw)
    torch.cuda.synchronize()
    ref = p2.probe_ablate_plain(inp, **kw)
    if not kw["mxu"]:
        assert torch.equal(got, ref)
    else:
        cov_g, cov_r = got < 1.0, ref < 1.0
        assert (cov_g == cov_r).float().mean().item() >= 0.99
        both = cov_g & cov_r
        if bool(both.any()):
            assert (got[both] - ref[both]).abs().max().item() <= 2e-3
    if flip:
        assert (got < 1.0).float().mean().item() > 0.1  # the projected centres crowd the middle
    else:
        assert bool((got == 1.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", p1.MODES)
def test_p1_edges_match_plain_on_card(cuda_device, mode):
    """Planted ties (twin lanes within a block, twin blocks, both windows on
    one block, a tie across windows at a smaller index in window 1), counts
    0, 1, 127, 128, 129, 255 and 256, and window starts at, past and below
    the payload's ends, over 302 tiles."""
    ranges, payload = p1.tie_inputs(cuda_device, seed=4, n_tiles=302, past_end=True)
    got = p1.probe_floor(mode, ranges, payload)
    torch.cuda.synchronize()
    assert torch.equal(got, p1.probe_floor_plain(mode, ranges, payload))


def _p2_holds(got, ref, kw):
    if not kw["mxu"]:
        assert torch.equal(got, ref)
        return
    cov_g, cov_r = got < 1.0, ref < 1.0
    assert (cov_g == cov_r).float().mean().item() >= 0.99
    both = cov_g & cov_r
    if bool(both.any()):
        assert (got[both] - ref[both]).abs().max().item() <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(256, 272), (32, 48)], ids=["272_tiles", "6_tiles"])
@pytest.mark.parametrize("name,kw", p2.VARIANTS, ids=[n for n, _ in p2.VARIANTS])
def test_p2_edges_match_plain_on_card(cuda_device, name, kw, size):
    """Tile counts that the persistent grid does not divide (272) or exceeds
    (6), empty tiles beside crowded ones, starts and counts off the 128
    boundary; two launches in a row agree, and the tile counter is left at
    zero."""
    inp = p2.edge_inputs(cuda_device, seed=5, height=size[0], width=size[1],
                         n=65536 if size[0] > 32 else 4096)
    got = p2.probe_ablate(inp, **kw)
    again = p2.probe_ablate(inp, **kw)
    torch.cuda.synchronize()
    ref = p2.probe_ablate_plain(inp, **kw)
    _p2_holds(got, ref, kw)
    assert torch.equal(got, again)
    assert (got < 1.0).any()
    if kw["dbuf"]:
        assert p2._tile_counter(inp.payload.device).tolist() == [0, 0]
