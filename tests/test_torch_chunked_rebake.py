"""The chunk-submesh pool's top-2 type blend and the registry rebake of a
chunked scene in the port against impact_tpu on the CPU.

The scene is the chunked engine test's asteroid (three noise-mixed voxel
types) at 32³ with ``tpu.chunked_remesh = True``, compiled by the
reference and carried over by the bridge (``tests/test_torch_chunked_engine.py``).

* A remesh: both packages free every slot of the bridged pool
  (``reset_objects``) and remesh all chunks in one budget. Slot maps,
  owners, chunks and triangle masks equal; ``tri_type`` and ``tri_type2``
  equal; ``tri_blend`` and the baked corner materials within 1e-6.
* The rebake with a registry whose colours differ from the default:
  ``bake_mesh_materials`` of the bridged pool (a pool keeps no vertex
  census, so both fall back to the top-2 blend) within 1e-6 of the
  reference's; ``HeadlessRuntime(registry=...)`` rebakes the chunked scene
  (it raised before) to the same materials and its material table, and the
  reference's runtime to the same.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_chunked_engine import jax_asteroid, jax_compile_chunked, jax_config
from test_torch_parity_scenes import cache_small_compiles  # noqa: F401  (an autouse fixture)

import impact_tpu.voxel.chunk_mesh as jchunk_mesh
import impact_tpu.voxel.mesh as jmesh
from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu.scene.materials import material_corner_table as jtable
from impact_tpu.scene.materials import make_voxel_type_registry as jregistry
from impact_tpu_torch import bridge
from impact_tpu_torch.models.bench import bench_chunked_config
from impact_tpu_torch.runtime import HeadlessRuntime
from impact_tpu_torch.scene.materials import make_voxel_type_registry, material_corner_table
from impact_tpu_torch.voxel import chunk_mesh
from impact_tpu_torch.voxel.chunk_mesh import ChunkMeshPool
from impact_tpu_torch.voxel.mesh import bake_mesh_materials

G, N_OBJECTS, RADIUS = 32, 2, 12.0
SETUP_BUDGET = 64  # impact_tpu/runtime/setup.py:1181, above the 16 chunks here
EXACT = ("slot_of", "owner", "chunk", "active", "tri_active", "tri_type", "tri_type2")
CLOSE = ("tri_blend", "tri_albedo", "tri_f0", "tri_rough", "tri_emissive")
SPECS = [{"name": "Basalt", "color": (0.9, 0.1, 0.2), "roughness": 0.3},
         {"name": "Copper", "color": (0.2, 0.8, 0.4), "metalness": 1.0, "roughness": 0.5},
         {"name": "Glass", "color": (0.1, 0.3, 0.9), "specular_reflectance": 0.2,
          "roughness": 0.1, "emissive_luminance": 2.0}]


@functools.lru_cache(maxsize=None)
def reference_build():
    return jax_compile_chunked(jax_asteroid(RADIUS), jax_config(G, N_OBJECTS))


def port_config():
    cfg = bench_chunked_config(64)
    cfg.tpu.voxel_grid_size = G
    cfg.tpu.max_voxel_objects, cfg.tpu.max_bodies = N_OBJECTS, N_OBJECTS + 8
    return cfg


def assert_pools_match(got, ref):
    assert isinstance(got, ChunkMeshPool)
    live = np.asarray(ref.active)
    for f in EXACT + CLOSE:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if f.startswith("tri_"):  # the rows of live slots (free slots keep stale rows)
            a, b = a[live], b[live]
        if f in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f)


def test_remesh_builds_the_reference_blend():
    build = reference_build()
    tc = port_config().tpu
    pool_j, cp_j = build.sim.voxels, build.sim.meshes
    table_j = build.params.material_table
    cp_j = jchunk_mesh.reset_objects(cp_j, pool_j.alive)
    budget = SETUP_BUDGET  # every chunk in one call, as the reference's setup remeshes
    ref = jax.jit(jchunk_mesh.remesh_chunks, static_argnums=(3, 4),
                  static_argnames=("merge_levels",))(
        cp_j, pool_j, table_j, budget, tc.chunk_vert_cap, merge_levels=tc.mesh_merge_levels)
    sim = bridge.sim_state_from_reference(build.sim, "cpu")
    cp = chunk_mesh.reset_objects(sim.meshes, sim.voxels.alive)
    got = chunk_mesh.remesh_chunks(cp, sim.voxels, torch.tensor(np.asarray(table_j)), budget,
                                   tc.chunk_vert_cap, merge_levels=tc.mesh_merge_levels)
    assert not bool(got.chunk_dirty.any())
    assert_pools_match(got, ref)
    live = got.active
    t1, t2 = got.tri_type[live][got.tri_active[live]], got.tri_type2[live][got.tri_active[live]]
    assert bool((t1 != t2).any()), "the scene has no blended corner"
    assert float(got.tri_blend.max()) <= 0.5


def test_registry_rebake_matches_reference():
    build = reference_build()
    table_j = jtable(jregistry(SPECS))
    ref = jmesh.bake_mesh_materials(build.sim.meshes, table_j)
    registry = make_voxel_type_registry(SPECS)
    table = material_corner_table(registry)
    np.testing.assert_allclose(table.numpy(), np.asarray(table_j), rtol=0, atol=1e-7)
    pool = bridge.sim_state_from_reference(build.sim, "cpu").meshes
    got = bake_mesh_materials(pool, table)
    assert_pools_match(got, ref)
    assert not np.allclose(got.tri_albedo.numpy(), pool.tri_albedo.numpy())

    # the runtime rebakes the chunked scene with the registry, as the reference's does
    rt = HeadlessRuntime(bridge.scene_build_from_reference(build, "cpu"), port_config(),
                         registry=registry)
    assert torch.equal(rt.params.material_table, table)
    assert_pools_match(rt.sim.meshes, ref)
    jrt = JRuntime(build, jax_config(G, N_OBJECTS), registry=jregistry(SPECS))
    assert_pools_match(rt.sim.meshes, jrt.sim.meshes)
    np.testing.assert_allclose(rt.params.material_table.numpy(),
                               np.asarray(jrt.params.material_table), rtol=0, atol=1e-7)
    assert jnp.asarray(jrt.sim.meshes.tri_blend).shape == rt.sim.meshes.tri_blend.shape
