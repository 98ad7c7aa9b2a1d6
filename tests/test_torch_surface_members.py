"""The class members and record layouts of the reference's surface against
impact_tpu on the CPU, on the same numpy inputs.

* ``CompactMesh.vert_type``, ``vert_type2`` and ``vert_blend``: Surface
  Nets then ``compact_mesh`` in both packages on a two-material 16³ grid,
  for one mesh and for a batch of 2 (the reference's
  ``compact_mesh_batched``), at caps that keep every vertex and at caps
  that drop some: the types equal, the blend within 1e-6. The bridge maps
  the reference's mesh with the three fields.
* Positional builds: ``RenderConfig``, ``EngineParams``, ``PhysicsConfig``
  and ``TpuConfig`` built from the reference's values in the reference's
  field order (positionally, or by ``_make``), and ``RenderState`` from
  three fields, equal a keyword build field by field; ``EngineParams``
  requires ``dist_rules`` and ``casts_shadows_base``, and a
  ``MeshInstancePool`` built without ``material`` has none, as the
  reference's.
* ``Isometry.identity``, ``Similarity.identity`` and
  ``BodyState.is_kinematic`` equal the reference's; the parity harness has
  the reference harness's ``REF_DIR`` and ``REF_CONFIG``, and
  ``score_reference_scene`` scores a frame against ``REF_DIR``'s golden,
  or one in the directory it is given, with its drop count, and raises
  where the golden is absent.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parity_scenes import reference_harness

from impact_tpu.math import transform as jtransform
from impact_tpu.physics import state as jstate
from impact_tpu.render import pipeline as jpipe
from impact_tpu.runtime import engine as jengine
from impact_tpu.scene import assembly as jassembly
from impact_tpu.utils import config as jconfig
from impact_tpu.voxel import mesh as jmesh
from impact_tpu_torch import bridge
from impact_tpu_torch.apps import parity_snapshots as ps
from impact_tpu_torch.math import transform as ttransform
from impact_tpu_torch.physics import state as tstate
from impact_tpu_torch.render import pipeline as tpipe
from impact_tpu_torch.runtime import engine as tengine
from impact_tpu_torch.scene import assembly as tassembly
from impact_tpu_torch.utils import config as tconfig
from impact_tpu_torch.voxel import mesh as tmesh

G = 16
VERT_FIELDS = ("vert_type", "vert_type2", "vert_blend")


def two_material_grids(n, seed=3):
    """[n,G,G,G] sphere SDFs (radius 5.5 voxels about a jittered centre)
    and voxel types: 1 on the low-x half, 2 on the other, with 10 % of the
    voxels flipped at random."""
    rng = np.random.default_rng(seed)
    idx = np.stack(np.meshgrid(*(np.arange(G) + 0.5,) * 3, indexing="ij"), -1)
    sdf, vt = [], []
    for _ in range(n):
        c = G / 2 + rng.uniform(-1.0, 1.0, 3)
        sdf.append((np.linalg.norm(idx - c, axis=-1) - 5.5).astype(np.float32))
        t = np.where(idx[..., 0] < c[0], 1, 2).astype(np.int32)
        flip = rng.random(t.shape) < 0.1
        vt.append(np.where(flip, 3 - t, t).astype(np.int32))
    return np.stack(sdf), np.stack(vt)


def assert_vertex_fields_equal(got, ref):
    np.testing.assert_array_equal(got.vert_type.numpy(), np.asarray(ref.vert_type))
    np.testing.assert_array_equal(got.vert_type2.numpy(), np.asarray(ref.vert_type2))
    np.testing.assert_allclose(got.vert_blend.numpy(), np.asarray(ref.vert_blend), rtol=0,
                               atol=1e-6)
    assert got.vert_type.dtype == torch.int32 and got.vert_blend.dtype == torch.float32


@pytest.fixture(scope="module")
def grids():
    """The two grids and the reference's Surface Nets meshes of them
    (jitted: the op-by-op run costs seconds more)."""
    sdf, vt = two_material_grids(2)
    return sdf, vt, jax.jit(jmesh.make_surface_nets_batched(0))(jnp.asarray(sdf),
                                                                jnp.asarray(vt))


@pytest.mark.parametrize("caps", [(3375, 8192), (200, 300)], ids=["whole", "dropping"])
def test_compact_mesh_carries_the_vertex_materials(caps, grids):
    """A batch of 2, as the engine meshes its objects, then the first mesh
    alone through the port's single-mesh path (the reference's batched
    compaction is its ``compact_mesh`` under ``vmap``)."""
    sdf, vt, jbatch = grids
    ref = jax.jit(jmesh.compact_mesh_batched, static_argnums=(1, 2))(jbatch, *caps)
    got = tmesh.compact_mesh(tmesh.surface_nets(torch.from_numpy(sdf), torch.from_numpy(vt), 0),
                             *caps)
    assert_vertex_fields_equal(got, ref)
    ref_one = jax.tree.map(lambda x: x[0], ref)
    got_one = tmesh.compact_mesh(tmesh.surface_nets(torch.from_numpy(sdf[0]),
                                                    torch.from_numpy(vt[0]), 0), *caps)
    assert_vertex_fields_equal(got_one, ref_one)
    assert int(np.asarray(ref_one.vert_active).sum()) > 0
    assert (np.asarray(ref_one.vert_blend) > 0).any()  # the mesh has two-material vertices
    assert [f for f in got._fields] == list(ref._fields)
    # the bridge maps the reference's mesh field by field
    bridged = bridge._meshes_from_reference(ref, "cpu")
    for f in VERT_FIELDS:
        assert torch.equal(getattr(bridged, f), torch.from_numpy(np.array(getattr(ref, f))))


def _tree_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        for f in a._fields:
            _tree_equal(getattr(a, f), getattr(b, f))
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_records_build_positionally_in_the_reference_order():
    ref = jpipe.RenderConfig(width=64, exposure_iso=100.0, soft_shadows=True,
                             sky_luminance=(1.0, 2.0, 3.0), bf16_shading=True)
    values = tuple(ref)
    assert tpipe.RenderConfig._make(values) == tpipe.RenderConfig(**ref._asdict())
    assert tpipe.RenderConfig(*values).soft_shadows and tpipe.RenderConfig(*values).width == 64

    # EngineParams: the reference's field order, every field required
    names = jengine.EngineParams._fields
    marks = tuple(f"value of {n}" for n in names)
    assert tengine.EngineParams(*marks)._asdict() == dict(zip(names, marks))
    with pytest.raises(TypeError):
        tengine.EngineParams(*marks[:10])

    # the config dataclasses, from the reference's values in its order
    jtpu = jconfig.TpuConfig(max_bodies=7, solver_mode="jacobi", soft_shadows=True,
                             steps_per_dispatch=3, raster_backend="raster")
    tpu_values = dataclasses.astuple(jtpu)
    assert tconfig.TpuConfig(*tpu_values) == tconfig.TpuConfig(**dataclasses.asdict(jtpu))
    assert tconfig.TpuConfig(*tpu_values).solver_mode == "jacobi"
    port_physics = tconfig.PhysicsConfig()
    physics_values = [getattr(port_physics, f.name)
                      for f in dataclasses.fields(jconfig.PhysicsConfig)]
    assert tconfig.PhysicsConfig(*physics_values) == port_physics

    # RenderState from three fields: no drops, as the reference's
    h = np.zeros((4, 6, 3), np.float32)
    jrs = jpipe.RenderState(jnp.asarray(h), jnp.asarray(1000.0), 0)
    trs = tpipe.RenderState(torch.from_numpy(h), torch.tensor(1000.0), 0)
    assert jrs.n_raster_drops == trs.n_raster_drops == 0
    _tree_equal(trs, tpipe.RenderState(history_luminance=trs.history_luminance,
                                       avg_luminance=trs.avg_luminance, frame_index=0,
                                       n_raster_drops=0))

    # a mesh-instance pool built without its texture layers has none
    fields = {f: None for f in jassembly.MeshInstancePool._fields[:14]}
    assert jassembly.MeshInstancePool(**fields).material is None
    assert tassembly.MeshInstancePool(**fields).material is None


def test_identity_and_is_kinematic_equal_the_reference():
    for cls in ("Isometry", "Similarity"):
        for shape in ((), (2, 3)):
            ref = getattr(jtransform, cls).identity(shape)
            got = getattr(ttransform, cls).identity(shape, device="cpu")
            assert type(got).__name__ == cls
            for f in ref._fields:
                g, r = getattr(got, f), np.asarray(getattr(ref, f))
                assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, (cls, f)
                np.testing.assert_array_equal(g.numpy(), r)
    kind = np.array([0, 1, 2, 2, 1, 0], np.int32)
    ref = jstate.empty_body_state(6)._replace(kind=jnp.asarray(kind))
    got = tstate.empty_body_state(6, device="cpu")._replace(kind=torch.from_numpy(kind))
    np.testing.assert_array_equal(got.is_kinematic.numpy(), np.asarray(ref.is_kinematic))
    assert int(got.is_kinematic.sum()) == 2


def test_parity_harness_scores_against_the_reference_goldens(tmp_path, monkeypatch):
    harness = reference_harness()
    assert ps.REF_DIR == harness.REF_DIR and ps.REF_CONFIG == harness.REF_CONFIG
    monkeypatch.setattr(ps, "REF_DIR", tmp_path / "absent")
    with pytest.raises(FileNotFoundError):
        ps.score_reference_scene("Bloom", device="cpu")

    # a golden beside a stand-in runtime: the score and the drop count
    from impact_tpu_torch.utils.image import rgb_hybrid_compare, save_png

    rng = np.random.default_rng(5)
    golden = rng.integers(0, 256, (12, 16, 4), dtype=np.uint8)
    frame = golden[..., :3].copy()
    frame[:4] = 0
    save_png(tmp_path / "Bloom.png", golden)
    seen = {}

    class Runtime:
        def render(self):
            return torch.from_numpy(frame)

        def dropped_raster_candidates(self):
            return 0

    def build_runtime(name, backend=None, cfg=None, device="cuda"):
        seen.update(name=name, backend=backend, device=device)
        return Runtime()

    monkeypatch.setattr(ps, "REF_DIR", tmp_path)
    monkeypatch.setattr(ps, "build_runtime", build_runtime)
    got = ps.score_reference_scene("Bloom", "raster", device="cpu")
    assert seen == {"name": "Bloom", "backend": "raster", "device": "cpu"}
    assert got == {"score": float(rgb_hybrid_compare(frame, golden[..., :3])),
                   "raster_drops": 0}
    assert got["score"] < 1.0
    monkeypatch.setattr(ps, "REF_DIR", tmp_path / "absent")
    assert ps.score_reference_scene("Bloom", "raster", device="cpu", goldens=tmp_path) == got
