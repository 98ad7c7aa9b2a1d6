"""The port's connected-component labels at grid sizes past K2's u16 limit
(G³ > 65535, G ≥ 41) against impact_tpu on the CPU.

The reference routes G ≥ 64 with G a multiple of 16 to its two-level
labelling and every other G to the flat fixpoint sweep; the port routes the
same way, the flat sweep going to K2-wide on the card and to the plain
sweep on the CPU. Bars: labels exactly equal (integer minima have no
rounding), and the split pools exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.voxel import interaction as jint
from impact_tpu.voxel import object as jobj
from impact_tpu.voxel.encoding import encode_sdf_i8
from impact_tpu_torch import bridge
from impact_tpu_torch.ops import ccl_pallas as k2
from impact_tpu_torch.voxel import interaction as tint
from impact_tpu_torch.voxel.object import VoxelObjectPool


def two_cubes_and_fill(g, seed, fill=0.15):
    """Two solid cubes far apart plus a sparse random fill around them."""
    occ = np.random.default_rng(seed).uniform(size=(g, g, g)) < fill
    occ[2:10, 3:11, 1:9] = True
    occ[g - 12:g - 2, g - 11:g - 3, g - 13:g - 4] = True
    return occ


@pytest.mark.parametrize("g", [41, 48, 63, 64, 72])
def test_labels_match_reference(g):
    occ = two_cubes_and_fill(g, g)
    ref = np.asarray(jint.connected_component_labels(jnp.asarray(occ)))
    got = tint.connected_component_labels(torch.from_numpy(occ))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # the two cubes lie in two components, each labelled at or below its corner
    assert 0 <= ref[2, 3, 1] <= 2 * g * g + 3 * g + 1
    assert ref[g - 12, g - 11, g - 13] != ref[2, 3, 1]


@pytest.mark.parametrize("g", [64, 80])
def test_two_level_equals_flat_sweep(g):
    """Batched two-level labels against the flat plain sweep, on random fills
    around the percolation threshold (components cross many chunk faces)."""
    rng = np.random.default_rng(g)
    occ = torch.from_numpy(np.stack([rng.uniform(size=(g, g, g)) < f for f in (0.3, 0.45)]))
    two = tint.connected_component_labels_two_level(occ)
    flat = k2.connected_component_labels_batched(occ)
    assert torch.equal(two, flat)
    routed = tint.connected_component_labels(occ)
    assert torch.equal(routed, flat)


def test_serpentine_across_chunks():
    """One path through every chunk of the k = 0 plane: the table
    contraction must join 16 chunk components into one label."""
    g = 64
    occ = np.zeros((g, g, g), bool)
    occ[0::2, :, 0] = True
    for i in range(1, g, 2):
        occ[i, g - 1 if (i // 2) % 2 == 0 else 0, 0] = True
    got = tint.connected_component_labels(torch.from_numpy(occ)).numpy()
    assert set(np.unique(got).tolist()) == {-1, 0}
    np.testing.assert_array_equal(got, np.asarray(jint.connected_component_labels_two_level(
        jnp.asarray(occ))))


def test_wide_plain_sweeps_count_like_the_narrow_ones():
    """The plain sweep takes any G: at G = 48 it stops a grid after its first
    unchanged sweep, as at G ≤ 40 (sweeps = the longest label path + 1)."""
    occ = torch.zeros((2, 48, 48, 48), dtype=torch.bool)
    occ[0, :, 5, 5] = True  # a 48-voxel rod: label 0 travels 47 voxels
    lab, sweeps = k2.ccl_sweeps(occ, k2.initial_labels(occ), 48 ** 3)
    assert sweeps.tolist() == [48, 1]
    assert bool((lab[0][occ[0]] == 5 * 48 + 5).all())
    assert bool((lab[1] == 48 ** 3).all())


def test_split_off_regions_at_48_matches_reference():
    g = 48
    occ = two_cubes_and_fill(g, 7, fill=0.0)
    occ[20:26, 20:26, 20:26] = True
    grid = np.where(occ, -0.1, 0.5).astype(np.float32)
    pool = jobj.empty_voxel_object_pool(6, g, jnp.int8)
    sdf = np.asarray(pool.sdf).copy()
    sdf[1] = np.asarray(encode_sdf_i8(jnp.asarray(grid), 0.25))
    alive = np.arange(6) == 1
    pool = pool._replace(alive=jnp.asarray(alive), sdf=jnp.asarray(sdf),
                         vtype=jnp.asarray(np.where(alive[:, None, None, None], 2, 0)
                                           .astype(np.int32) * np.ones((1, g, g, g), np.int32)),
                         voxel_extent=jnp.asarray(np.where(alive, 0.25, 1.0).astype(np.float32)),
                         origin=jnp.asarray(np.tile([[-6.0, -6.1, -5.9]], (6, 1))
                                            .astype(np.float32)),
                         split_pending=jnp.asarray(alive), mesh_dirty=jnp.asarray(alive))
    free = np.array([3, 4, 5], np.int32)
    ref, ref_n, ref_after = jint.split_off_disconnected_regions(pool, 1, jnp.asarray(free))
    tpool = bridge.tuple_from_reference(VoxelObjectPool, pool, device="cpu")
    got, n, after = tint.split_off_disconnected_regions(tpool, torch.tensor(1),
                                                        torch.from_numpy(free).long())
    for f in VoxelObjectPool._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert int(n) == int(ref_n) == 2 and bool(after) == bool(ref_after) is False
