"""The port's voxel SDF, i8 encoding, Surface Nets and mesh compaction
against impact_tpu's on one 32³ box (the bench's shape).

SDF values and i8 codes must be exactly equal; meshes must have equal vertex
and triangle counts, equal topology, and positions/normals within atol 1e-5
(the crossing centroids are the same float32 arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.scene import materials as jmat
from impact_tpu.voxel import encoding as jenc, mesh as jmesh, object as jobj, sdf as jsdf
from impact_tpu_torch.scene import materials as tmat
from impact_tpu_torch.voxel import encoding as tenc, mesh as tmesh, object as tobj, sdf as tsdf

G = 32


def _box_grids(extent_voxels, ve=0.25):
    e = extent_voxels * ve
    sj, oj = jobj.generate_sdf_grid(jsdf.box((e, e, e)), G, ve)
    st, ot = tobj.generate_sdf_grid(tsdf.box((e, e, e)), G, ve, device="cpu")
    return (np.asarray(sj), np.asarray(oj)), (st.numpy(), ot.numpy())


@pytest.mark.parametrize("extent", [10.0, 26.0])
def test_box_sdf_and_i8_codes_equal(extent):
    (sj, oj), (st, ot) = _box_grids(extent)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(ot, oj)
    cj = np.asarray(jenc.encode_sdf_i8(jnp.asarray(sj), 0.25))
    ct = tenc.encode_sdf_i8(torch.from_numpy(st), 0.25).numpy()
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(
        tenc.decode_sdf_i8(torch.from_numpy(ct), 0.25).numpy(),
        np.asarray(jenc.decode_sdf_i8(jnp.asarray(cj), 0.25)))


@pytest.mark.parametrize("extent,merge_levels", [(26.0, 2), (10.0, 0)])
def test_surface_nets_and_compaction(extent, merge_levels):
    (sj, _), _ = _box_grids(extent)
    codes = np.asarray(jenc.encode_sdf_i8(jnp.asarray(sj), 0.25))
    world = codes.astype(np.float32) * np.float32(0.25 * 0.02)
    vt = np.zeros((G, G, G), np.int32)
    mj = jmesh.surface_nets(jnp.asarray(world), jnp.asarray(vt), merge_levels)
    mt = tmesh.surface_nets(torch.from_numpy(world), torch.from_numpy(vt), merge_levels)
    np.testing.assert_array_equal(mt.vert_active.numpy(), np.asarray(mj.vert_active))
    np.testing.assert_array_equal(mt.tri_active.numpy(), np.asarray(mj.tri_active))
    np.testing.assert_array_equal(mt.tri_indices.numpy(), np.asarray(mj.tri_indices))
    act = mt.vert_active.numpy()
    np.testing.assert_allclose(mt.vert_pos.numpy()[act], np.asarray(mj.vert_pos)[act], atol=1e-5)
    np.testing.assert_allclose(mt.vert_normal.numpy()[act], np.asarray(mj.vert_normal)[act],
                               atol=1e-5)

    cj = jmesh.compact_mesh(mj, 4096, 8192)
    ct = tmesh.compact_mesh(mt, 4096, 8192)
    assert int(ct.tri_active.sum()) == int(np.sum(cj.tri_active)) > 0
    assert int(ct.vert_active.sum()) == int(np.sum(cj.vert_active))
    assert int(ct.n_dropped_tris) == int(cj.n_dropped_tris)
    assert int(ct.n_dropped_verts) == int(cj.n_dropped_verts)
    np.testing.assert_array_equal(ct.tri_indices.numpy(), np.asarray(cj.tri_indices))
    np.testing.assert_allclose(ct.tri_pos.numpy(), np.asarray(cj.tri_pos), atol=1e-5)

    tab_j = jmat.material_corner_table(jmat.default_registry())
    tab_t = tmat.material_corner_table(tmat.default_registry(device="cpu"))
    np.testing.assert_allclose(tab_t.numpy(), np.asarray(tab_j), atol=1e-7)
    bj = jmesh.bake_mesh_materials(cj, tab_j)
    bt = tmesh.bake_mesh_materials(ct, tab_t)
    for f in ("tri_albedo", "tri_f0", "tri_rough", "tri_emissive"):
        np.testing.assert_allclose(getattr(bt, f).numpy(), np.asarray(getattr(bj, f)), atol=1e-6)
