"""The port's voxel collision against impact_tpu on the CPU: probe extraction,
i8 corner packing, the shifted-grid broad phase and voxel contacts, on
numpy-seeded pools.

Bars: probes, packed words, unpacked bytes, broad-phase pairs and the
overflow count exactly equal (integer work, stable sorts, the same float
formulas on the same inputs); contacts with equal keys, masks and bodies,
and geometry within 1e-5 (float32 round-off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.physics import collision as jcoll
from impact_tpu.voxel import collision as jvc
from impact_tpu.voxel import object as jobj
from impact_tpu.voxel import sdf as jsdf
from impact_tpu.voxel.encoding import encode_sdf_i8
from impact_tpu_torch import bridge
from impact_tpu_torch.physics import collision as tcoll
from impact_tpu_torch.voxel import collision as tvc
from impact_tpu_torch.voxel.object import VoxelObjectPool


def random_pool(n_objects, g, seed, n_alive=None, i8=True):
    """A jax pool of spheres and boxes of random sizes (0.25 m voxels), with
    i8 or f32 SDF storage."""
    rng = np.random.default_rng(seed)
    n_alive = n_objects if n_alive is None else n_alive
    pool = jobj.empty_voxel_object_pool(n_objects, g, jnp.int8 if i8 else jnp.float32)
    sdf = np.asarray(pool.sdf).copy()
    origin = np.zeros((n_objects, 3), np.float32)
    extent = np.ones(n_objects, np.float32)
    for i in range(n_alive):
        r = rng.uniform(0.2, 0.45) * g * 0.25
        graph = (jsdf.sphere(r) if i % 2 else
                 jsdf.box(tuple(rng.uniform(0.4, 0.85, 3) * g * 0.25)))
        grid, org = jobj.generate_sdf_grid(graph, g, 0.25)
        sdf[i] = np.asarray(encode_sdf_i8(grid, 0.25) if i8 else grid)
        origin[i], extent[i] = np.asarray(org), 0.25
    return pool._replace(
        alive=jnp.asarray(np.arange(n_objects) < n_alive),
        body_index=jnp.asarray(np.arange(n_objects, dtype=np.int32) + 2),
        voxel_extent=jnp.asarray(extent), origin=jnp.asarray(origin), sdf=jnp.asarray(sdf),
        vtype=jnp.zeros_like(pool.vtype))


def port_pool(pool):
    return bridge.tuple_from_reference(VoxelObjectPool, pool, device="cpu")


def test_probes_match_reference():
    pool = random_pool(6, 16, 0, n_alive=5)
    resp = np.random.default_rng(0).uniform(0.1, 0.9, (6, 3)).astype(np.float32)
    ref = jvc.extract_probes(pool, jnp.asarray(resp))
    got = tvc.extract_probes(port_pool(pool), torch.from_numpy(resp))
    assert int(np.asarray(ref.active).sum()) > 20
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_corner_packing_and_unpacking_are_exact():
    """Four signed bytes per i32 word: the sign extension of the arithmetic
    shift must match byte for byte, including -128 and 127."""
    rng = np.random.default_rng(1)
    sdf = rng.integers(-128, 128, (3, 9, 9, 9)).astype(np.int8)
    sdf[0, 0, 0, 0], sdf[0, 1, 0, 0], sdf[0, 0, 1, 0], sdf[0, 1, 1, 0] = -128, 127, -1, 0
    ref = np.asarray(jvc.pack_cell_corners_i8(jnp.asarray(sdf)))
    got = tvc.pack_cell_corners_i8(torch.from_numpy(sdf))
    np.testing.assert_array_equal(got.numpy(), ref)
    for k in range(4):
        np.testing.assert_array_equal(tvc.unpack_byte_i8(got, k).numpy(),
                                      np.asarray(jvc._unpack_byte_i8(jnp.asarray(ref), k)))


@pytest.mark.parametrize("clustered", [False, True], ids=["spread", "overflowing"])
def test_grid_broad_phase_matches_reference(clustered):
    """≥ 64 objects: the shifted-grid path. Clustered, more than ``window``
    objects share a cell and the overflow count is nonzero."""
    rng = np.random.default_rng(2)
    n = 96
    centers = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    if clustered:
        centers[:48] = rng.uniform(-0.5, 0.5, (48, 3)).astype(np.float32)
    radii = rng.uniform(0.5, 2.0, n).astype(np.float32)
    radii[[3, 50]] = 6.0  # two large objects leave the grid
    alive = rng.uniform(size=n) < 0.95
    margin = np.full(n, 0.25, np.float32)
    ref = jvc.broad_phase_pairs(jnp.asarray(centers), jnp.asarray(radii), jnp.asarray(alive),
                                max_pairs=4096, margin=jnp.asarray(margin))
    got = tvc.broad_phase_pairs(torch.from_numpy(centers), torch.from_numpy(radii),
                                torch.from_numpy(alive), max_pairs=4096,
                                margin=torch.from_numpy(margin))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (int(got[3]) > 0) == clustered
    assert int(got[2].sum()) > 10


def _bodies(n_objects, seed, spread):
    rng = np.random.default_rng(seed)
    n = n_objects + 2
    pos = np.zeros((n, 3), np.float32)
    pos[2:] = rng.uniform(-spread, spread, (n_objects, 3)) + [0.0, 1.2, 0.0]
    q = rng.normal(size=(n, 4))
    q[:2] = [0, 0, 0, 1]
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    return pos, q


def _collidables():
    """The ground plane on body 0 and one sphere on body 1."""
    p = jcoll.empty_collidable_pools(n_spheres=1, n_planes=1, n_capsules=1)
    return p._replace(
        pln_body=jnp.zeros(1, jnp.int32), pln_mask=jnp.ones(1, bool),
        pln_response=jnp.asarray([[0.3, 0.7, 0.5]], jnp.float32),
        sph_body=jnp.ones(1, jnp.int32), sph_radius=jnp.asarray([1.0], jnp.float32),
        sph_mask=jnp.ones(1, bool), sph_response=jnp.asarray([[0.2, 0.6, 0.4]], jnp.float32))


@pytest.mark.parametrize("n_objects,g,spread,i8", [(6, 16, 1.2, True), (64, 8, 3.0, True),
                                                   (6, 16, 1.2, False)],
                         ids=["dense_pairs", "grid_pairs", "dense_pairs_f32"])
def test_voxel_contacts_match_reference(n_objects, g, spread, i8):
    pool = random_pool(n_objects, g, 3, n_alive=n_objects - 1, i8=i8)
    resp = np.random.default_rng(3).uniform(0.1, 0.9, (n_objects, 3)).astype(np.float32)
    probes = jvc.extract_probes(pool, jnp.asarray(resp))
    pos, q = _bodies(n_objects, 4, spread)
    coll = _collidables()
    ref = jvc.voxel_contacts(pool, probes, coll, jnp.asarray(pos), jnp.asarray(q), 2048)
    tprobes = bridge.tuple_from_reference(tvc.VoxelProbes, probes, device="cpu")
    got = tvc.voxel_contacts(port_pool(pool), tprobes,
                             bridge.tuple_from_reference(tcoll.CollidablePools, coll, "cpu"),
                             torch.from_numpy(pos), torch.from_numpy(q), 2048)
    act = np.asarray(ref.active)
    assert act.sum() > 30
    p = (g // 4) ** 3
    pair_keys = np.asarray(ref.key)[act] >= jvc.VOXEL_KEY_BASE + 2 * n_objects * p
    assert pair_keys.sum() > 5  # voxel-voxel contacts, beyond the plane and sphere keys
    for f in ref._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5, err_msg=f)
    merged = tvc.merge_contact_buffers(got, got, 4096)
    assert int(merged.active.sum()) == 2 * int(got.active.sum())
