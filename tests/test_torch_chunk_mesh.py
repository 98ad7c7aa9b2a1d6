"""The port's chunk-gated meshing (``voxel/chunk_mesh.py``) against
impact_tpu's on the CPU, from the same pool and the same dirty state.

The pool holds two noise-modified spheres of 32³ i8 voxels typed by gradient
noise (three materials). ``remesh_chunks`` runs round after round with a
budget smaller than the dirty count; after every round the slot maps, slot
owners, chunk ids, dirty flags, active triangles and drop counters must be
equal, triangle positions and normals within 1e-5 (the same float32 Surface
Nets arithmetic, summed in another order) and the baked materials within
1e-6 (sums of the same products). The slot-pool exhaustion count,
``reset_objects`` and ``chunk_mesh_scene_fields`` (within 1e-5) are held the
same way. The reference's ``remesh_chunks`` runs jitted, as its engine step
runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.scene.materials import default_registry, material_corner_table
from impact_tpu.voxel import chunk_mesh as jcm
from impact_tpu.voxel import encoding as jenc
from impact_tpu.voxel import object as jobj
from impact_tpu.voxel import sdf as jsdf
from impact_tpu_torch import bridge
from impact_tpu_torch.voxel import chunk_mesh as tcm
from impact_tpu_torch.voxel.object import VoxelObjectPool
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)

G = 32
EXT = 0.3
TABLE = material_corner_table(default_registry())
INT_FIELDS = ("owner", "chunk", "active", "slot_of", "chunk_dirty", "tri_active", "tri_type",
              "n_dropped_verts", "n_dropped_tris", "n_dropped_chunks")
MATERIAL_FIELDS = ("tri_albedo", "tri_f0", "tri_rough", "tri_emissive")
jremesh = jax.jit(jcm.remesh_chunks, static_argnums=(3, 4), static_argnames=("merge_levels",))


def _jax_pool(n_objects=3):
    pool = jobj.empty_voxel_object_pool(n_objects, G, jnp.int8)
    coords = jobj.grid_coords(G) * EXT
    for o, (radius, seed) in enumerate(((12.0, 7), (9.0, 3))):
        graph = jsdf.noise_modifier(jsdf.sphere(radius * EXT), 4, 0.22, 2.0, 0.55, 1.6, seed)
        sdf, origin = jobj.generate_sdf_grid(graph, G, EXT)
        noise = jsdf.gradient_noise(coords * 0.35, seed=seed)
        vt = jnp.clip(((noise * 0.5 + 0.5) * 3).astype(jnp.int32), 0, 2)
        pool = pool._replace(
            alive=pool.alive.at[o].set(True),
            voxel_extent=pool.voxel_extent.at[o].set(EXT),
            origin=pool.origin.at[o].set(origin),
            sdf=pool.sdf.at[o].set(jenc.encode_sdf_i8(sdf, EXT)),
            vtype=pool.vtype.at[o].set(vt),
        )
    return pool


@pytest.fixture(scope="module")
def pools():
    jp = _jax_pool()
    return jp, bridge.tuple_from_reference(VoxelObjectPool, jp, device="cpu")


def _fresh(pool, n_slots, tri_cap=512):
    cp = jcm.empty_chunk_mesh_pool(n_slots, tri_cap, pool.n_objects, G)
    return jcm.mark_objects_dirty(cp, pool.alive)


def assert_pools_equal(tc, jc, what):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f"{what}: {f}")
    for f in ("tri_pos", "tri_normal"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   atol=1e-5, err_msg=f"{what}: {f}")
    for f in MATERIAL_FIELDS:
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   atol=1e-6, err_msg=f"{what}: {f}")


@pytest.mark.parametrize("merge_levels", [0, 2])
def test_remesh_rounds_match_reference(pools, merge_levels):
    jp, tp = pools
    jc = _fresh(jp, 32)
    tc = bridge.chunk_mesh_pool_from_reference(jc, device="cpu")
    ttab = torch.from_numpy(np.array(TABLE))
    n_dirty = int(np.asarray(jc.chunk_dirty & jp.alive[:, None]).sum())
    assert n_dirty == 16
    for r in range(4):  # budget 5 of 16 dirty chunks: 4 rounds
        jc = jremesh(jc, jp, TABLE, 5, 1024, merge_levels=merge_levels)
        tc = tcm.remesh_chunks(tc, tp, ttab, 5, 1024, merge_levels=merge_levels)
        assert_pools_equal(tc, jc, f"round {r}")
    assert int(tc.active.sum()) > 8 and not bool(tc.chunk_dirty.any())

    # object 1 emptied: its slots are released; object 0 re-meshed in place
    jp2 = jp._replace(sdf=jp.sdf.at[1].set(127))
    tp2 = tp._replace(sdf=tp.sdf.clone().index_fill(0, torch.tensor([1]), 127))
    jc = jcm.mark_objects_dirty(jc, jp.alive)
    tc = tcm.mark_objects_dirty(tc, tp.alive)
    for r in range(4):
        jc = jremesh(jc, jp2, TABLE, 5, 1024, merge_levels=merge_levels)
        tc = tcm.remesh_chunks(tc, tp2, ttab, 5, 1024, merge_levels=merge_levels)
        assert_pools_equal(tc, jc, f"release round {r}")
    assert not bool(tc.slot_of[1].ge(0).any())


def test_slot_pool_exhaustion_counts_and_retries(pools):
    jp, tp = pools
    jc = _fresh(jp, 6)
    tc = bridge.chunk_mesh_pool_from_reference(jc, device="cpu")
    ttab = torch.from_numpy(np.array(TABLE))
    for r in range(3):
        jc = jremesh(jc, jp, TABLE, 16, 1024)
        tc = tcm.remesh_chunks(tc, tp, ttab, 16, 1024)
        assert_pools_equal(tc, jc, f"exhausted round {r}")
    assert int(tc.n_dropped_chunks) > 0 and bool(tc.chunk_dirty.any())


def test_reset_objects_and_scene_fields(pools):
    jp, tp = pools
    jc = _fresh(jp, 32)
    for _ in range(2):
        jc = jremesh(jc, jp, TABLE, 8, 1024, merge_levels=2)
    tc = bridge.chunk_mesh_pool_from_reference(jc, device="cpu")
    mask = np.array([False, True, False])
    assert_pools_equal(tcm.reset_objects(tc, torch.from_numpy(mask)),
                       jcm.reset_objects(jc, jnp.asarray(mask)), "reset_objects")

    rng = np.random.default_rng(5)
    n = 8
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 3
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos_p = pos + rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    q_p = q + rng.normal(size=(n, 4)).astype(np.float32) * 0.05
    q_p /= np.linalg.norm(q_p, axis=1, keepdims=True)
    body_index = np.array([5, 2, 7], np.int32)
    jp2 = jp._replace(body_index=jnp.asarray(body_index))
    tp2 = tp._replace(body_index=torch.from_numpy(body_index).long())
    want = jcm.chunk_mesh_scene_fields(jc, jp2, *map(jnp.asarray, (pos, q, pos_p, q_p)))
    got = tcm.chunk_mesh_scene_fields(tc, tp2, *map(torch.from_numpy, (pos, q, pos_p, q_p)))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)
    assert int(got["tri_active"].sum()) > 0
