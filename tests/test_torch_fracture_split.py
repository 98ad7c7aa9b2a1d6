"""The port's fracture and split against impact_tpu on the CPU.

The reference draws its seed jitter from threefry keys, which the port
cannot reproduce; the tests draw those uniforms with JAX from the key the
reference uses and hand them to the port, so both fracture the same
geometry. Bars: seeds within 1e-5 (float32 trigonometry and powers in two
libraries); the fractured and split pools — i8 SDFs, types, alive, dirty
and pending masks, origins, extents — exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.voxel import interaction as jint
from impact_tpu.voxel import object as jobj
from impact_tpu.voxel import sdf as jsdf
from impact_tpu.voxel.encoding import encode_sdf_i8
from impact_tpu_torch import bridge
from impact_tpu_torch.voxel import interaction as tint
from impact_tpu_torch.voxel.object import VoxelObjectPool

G, N_SEEDS = 16, 8


def jax_uniforms(key, n_seeds):
    """The three uniform draws of sample_fracture_seeds (interaction.py:744)."""
    kt, kp, kr = jax.random.split(key, 3)
    draws = (jax.random.uniform(kt, (n_seeds,), minval=-0.5, maxval=0.5),
             jax.random.uniform(kp, (n_seeds,), minval=-0.5, maxval=0.5),
             jax.random.uniform(kr, (n_seeds,)))
    return tuple(torch.from_numpy(np.array(d)) for d in draws)


def pool_with(grids, n_objects=12):
    """A jax i8 pool holding ``grids`` (f32 SDFs, 0.25 m voxels) in slots 0..;
    slot 0's origin offset so the grid is off-centre."""
    pool = jobj.empty_voxel_object_pool(n_objects, G, jnp.int8)
    sdf = np.asarray(pool.sdf).copy()
    vt = np.zeros((n_objects, G, G, G), np.int32)
    origin = np.zeros((n_objects, 3), np.float32)
    for i, grid in enumerate(grids):
        sdf[i] = np.asarray(encode_sdf_i8(jnp.asarray(grid), 0.25))
        vt[i] = i + 1
        origin[i] = [-2.0, -2.1, -1.9]
    alive = np.arange(n_objects) < len(grids)
    return pool._replace(alive=jnp.asarray(alive), sdf=jnp.asarray(sdf), vtype=jnp.asarray(vt),
                         voxel_extent=jnp.asarray(np.where(alive, 0.25, 1.0).astype(np.float32)),
                         origin=jnp.asarray(origin), mesh_dirty=jnp.asarray(alive.copy()),
                         body_index=jnp.arange(n_objects, dtype=jnp.int32) + 4)


def assert_pools_equal(got: VoxelObjectPool, ref):
    for f in VoxelObjectPool._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def box_grid(extent):
    grid, _ = jobj.generate_sdf_grid(jsdf.box((extent,) * 3), G, 0.25)
    return np.asarray(grid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fracture_object_matches_reference(seed):
    pool = pool_with([box_grid(3.0), box_grid(2.0)])
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    impact = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
    free = np.array([2, 3, 4, 5, 6, 7, -1], np.int32)
    ref = jint.fracture_object(pool, 0, jnp.asarray(impact), key, jnp.asarray(free), 2.0, N_SEEDS)
    tpool = bridge.tuple_from_reference(VoxelObjectPool, pool, device="cpu")
    got = tint.fracture_object(tpool, torch.tensor(0), torch.from_numpy(impact),
                               jax_uniforms(key, N_SEEDS), torch.from_numpy(free).long(),
                               torch.tensor(2.0), N_SEEDS)
    assert int(np.asarray(ref.alive).sum()) > 4  # fragments moved out
    assert_pools_equal(got, ref)


def test_fracture_seeds_match_reference():
    key = jax.random.PRNGKey(5)
    impact = np.array([0.4, -1.2, 0.9], np.float32)
    ref = np.asarray(jint.sample_fracture_seeds(key, jnp.asarray(impact), -jnp.asarray(impact),
                                                2.5, 191))
    got = tint.sample_fracture_seeds(jax_uniforms(key, 191), torch.from_numpy(impact),
                                     -torch.from_numpy(impact), 2.5, 191)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_fracture_uniforms_come_from_the_generator():
    g = torch.Generator().manual_seed(3)
    ju, jv, ur = tint.draw_fracture_uniforms(g, 1000)
    assert ju.min() >= -0.5 and ju.max() < 0.5 and jv.min() >= -0.5 and jv.max() < 0.5
    assert ur.min() >= 0.0 and ur.max() < 1.0 and abs(float(ur.mean()) - 0.5) < 0.05
    again = tint.draw_fracture_uniforms(torch.Generator().manual_seed(3), 1000)
    assert all(torch.equal(a, b) for a, b in zip((ju, jv, ur), again))


def three_pieces():
    """Two boxes and a cube that touches one of them only along an edge: four
    6-connected components in one grid."""
    occ = np.zeros((G, G, G), bool)
    occ[1:6, 1:6, 1:6] = True
    occ[9:14, 2:12, 3:9] = True
    occ[6:8, 6:8, 6:8] = True  # edge contact with the first box at (5,5,*)
    occ[2:4, 12:15, 11:14] = True
    return np.where(occ, -0.1, 0.5).astype(np.float32)


@pytest.mark.parametrize("free", [[3, 4, 5], [3, -1, 5], [3, 4]], ids=str)
def test_split_off_disconnected_regions_matches_reference(free):
    pool = pool_with([box_grid(3.0), box_grid(1.0), three_pieces()])
    pool = pool._replace(split_pending=pool.alive)
    free = np.array(free, np.int32)
    ref, ref_n, ref_after = jint.split_off_disconnected_regions(pool, 2, jnp.asarray(free))
    tpool = bridge.tuple_from_reference(VoxelObjectPool, pool, device="cpu")
    got, n, after = tint.split_off_disconnected_regions(tpool, torch.tensor(2),
                                                        torch.from_numpy(free).long())
    assert_pools_equal(got, ref)
    assert int(n) == int(ref_n) > 0 and bool(after) == bool(ref_after)
    # precomputed labels (the batched K2 launch of the engine) give the same pool
    labels = tint.connected_component_labels(tint.occupancy(tpool)[2:3])[0]
    again, _, _ = tint.split_off_disconnected_regions(tpool, torch.tensor(2),
                                                      torch.from_numpy(free).long(), labels)
    assert_pools_equal(again, ref)


def test_connected_object_clears_its_pending_flag():
    pool = pool_with([box_grid(3.0)])
    pool = pool._replace(split_pending=pool.alive)
    free = jnp.asarray(np.array([4, 5, 6], np.int32))
    ref, _, _ = jint.split_off_disconnected_regions(pool, 0, free)
    got, n, after = tint.split_off_disconnected_regions(
        bridge.tuple_from_reference(VoxelObjectPool, pool, device="cpu"), torch.tensor(0),
        torch.from_numpy(np.array(free)).long())
    assert_pools_equal(got, ref)
    assert int(n) == 0 and not bool(after) and not bool(got.split_pending[0])
