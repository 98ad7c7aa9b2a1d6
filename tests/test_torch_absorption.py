"""The port's absorption (``voxel/interaction.py``) against impact_tpu's on
the CPU, on bridged pools.

Three noise-modified spheres of 32³ voxels (i8 and f32) on bodies with
seeded poses, under two absorbing spheres and an absorbing capsule on other
bodies (one sphere masked off). The dense pass, the object-gated pass with a
gate smaller than the overlapping objects, and the chunk-gated carve with a
budget smaller than the overlapped chunks, at three rotations, must give
equal SDFs (i8 codes, or f32 values: the same float32 arithmetic), equal
``mesh_dirty``/``split_pending``, ``changed``, ``dirty_chunks`` and deferred
counts. A scene's absorbers compile onto kinematic bodies of their own,
after the ground planes, spheres before capsules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from impact_tpu.voxel import encoding as jenc
from impact_tpu.voxel import interaction as ji
from impact_tpu.voxel import object as jobj
from impact_tpu.voxel import sdf as jsdf
from impact_tpu_torch import bridge
from impact_tpu_torch.voxel import interaction as ti
from impact_tpu_torch.voxel.object import VoxelObjectPool
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)

G = 32
EXT = 0.3
N_BODIES = 8


def _jax_pool(i8):
    pool = jobj.empty_voxel_object_pool(4, G, jnp.int8 if i8 else jnp.float32)
    for o, (radius, seed) in enumerate(((13.0, 7), (10.0, 3), (11.0, 5))):
        graph = jsdf.noise_modifier(jsdf.sphere(radius * EXT), 4, 0.22, 2.0, 0.55, 1.6, seed)
        sdf, origin = jobj.generate_sdf_grid(graph, G, EXT)
        pool = pool._replace(
            alive=pool.alive.at[o].set(True),
            body_index=pool.body_index.at[o].set(4 + o),
            voxel_extent=pool.voxel_extent.at[o].set(EXT),
            origin=pool.origin.at[o].set(origin),
            sdf=pool.sdf.at[o].set(jenc.encode_sdf_i8(sdf, EXT) if i8 else sdf),
        )
    return pool


def _jax_absorbers():
    a = ji.empty_absorber_pools()
    return a._replace(
        sph_body=a.sph_body.at[0].set(0).at[1].set(1).at[2].set(2),
        sph_offset=a.sph_offset.at[0].set(jnp.array([0.5, -0.2, 0.1])),
        sph_radius=a.sph_radius.at[0].set(3.0).at[1].set(2.2).at[2].set(9.0),
        sph_mask=a.sph_mask.at[0].set(True).at[1].set(True),  # slot 2 masked off
        cap_body=a.cap_body.at[0].set(3),
        cap_start=a.cap_start.at[0].set(jnp.array([0.0, -2.0, 0.0])),
        cap_end=a.cap_end.at[0].set(jnp.array([0.0, 2.5, 0.3])),
        cap_radius=a.cap_radius.at[0].set(1.2),
        cap_mask=a.cap_mask.at[0].set(True),
    )


def _poses():
    rng = np.random.default_rng(11)
    pos = np.zeros((N_BODIES, 3), np.float32)
    # objects 0 and 1 near the sphere absorbers, 2 by the capsule
    pos[4:7] = [[0.0, 0.0, 0.0], [9.0, 1.0, 0.0], [0.0, 0.0, 9.0]]
    pos[:4] = [[3.0, 3.0, 0.0], [7.0, -1.0, 2.0], [50.0, 50.0, 50.0], [1.5, 0.5, 8.0]]
    pos += rng.normal(size=pos.shape).astype(np.float32) * 0.1
    q = rng.normal(size=(N_BODIES, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return pos, q


@pytest.fixture(scope="module", params=["i8", "f32"])
def case(request):
    jp = _jax_pool(request.param == "i8")
    ja = _jax_absorbers()
    pos, q = _poses()
    return dict(j=(jp, ja, jnp.asarray(pos), jnp.asarray(q)),
                t=(bridge.tuple_from_reference(VoxelObjectPool, jp, device="cpu"),
                   bridge.tuple_from_reference(ti.AbsorberPools, ja, device="cpu"),
                   torch.from_numpy(pos), torch.from_numpy(q)))


def _pools_equal(tp, jp):
    for f in ("sdf", "mesh_dirty", "split_pending"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)


@pytest.mark.parametrize("gate_cap", [None, 1])
def test_dense_and_gated_absorption(case, gate_cap):
    want = ji.apply_absorption(*case["j"], gate_cap=gate_cap)
    got = ti.apply_absorption(*case["t"], gate_cap=gate_cap)
    _pools_equal(got, want)
    jp = case["j"][0]
    changed = np.asarray(want.sdf != jp.sdf).reshape(4, -1).any(axis=1)
    assert changed.sum() == (1 if gate_cap else 3)
    if gate_cap:
        deferred = ti.deferred_absorption_count(*case["t"], gate_cap)
        assert int(deferred) == int(ji.deferred_absorption_count(*case["j"], gate_cap)) == 2


@pytest.mark.parametrize("rotation", [0, 37, 5 * 7])
def test_chunk_gated_absorption(case, rotation):
    budget = 5
    hit_t = ti._chunk_absorber_hit(*case["t"])
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(ji._chunk_absorber_hit(*case["j"])))
    assert int(hit_t.sum()) > budget
    jp, jc, jd, jdef = ji.apply_absorption_chunk_gated(*case["j"], budget, rotation=rotation)
    tp, tc, td, tdef = ti.apply_absorption_chunk_gated(*case["t"], budget, rotation=rotation)
    _pools_equal(tp, jp)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(tdef) == int(jdef) == int(hit_t.sum()) - budget
    assert bool(tc.any())


def test_scene_absorbers_compile_onto_kinematic_bodies():
    from impact_tpu_torch.ecs import components as TC
    from impact_tpu_torch.models import voxel_box_tumbler
    from impact_tpu_torch.physics.state import KIND_KINEMATIC
    from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
    from impact_tpu_torch.utils.config import EngineConfig

    cfg = EngineConfig()
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts = 2, 8, 64
    t.solver_mode, t.sdf_encoding = "jacobi", "i8"
    world = voxel_box_tumbler(n_boxes=1, seed=0)
    box = tuple(world.get_component(world.entities_with(TC.VoxelBox)[0],
                                    TC.ReferenceFrame).position.tolist())
    world.create_entity(TC.ReferenceFrame(position=box), TC.VoxelAbsorbingSphere(radius=0.8))
    world.create_entity(TC.ReferenceFrame(position=(40.0, 0.0, 0.0)),
                        TC.VoxelAbsorbingCapsule(radius=0.5, segment_end=(0.0, 2.0, 0.0)))
    build = compile_scene(world, cfg, device="cpu")
    a, b = build.params.absorbers, build.sim.phys.bodies
    assert (a.sph_mask.tolist()[:2], a.cap_mask.tolist()[:2]) == ([True, False], [True, False])
    assert (int(a.sph_body[0]), int(a.cap_body[0])) == (1, 2)  # the ground plane takes body 0
    assert b.kind[:3].tolist() == [KIND_KINEMATIC] * 3
    np.testing.assert_allclose(b.position[1].numpy(), box)
    np.testing.assert_allclose(a.cap_end[0].numpy(), [0.0, 2.0, 0.0])
    rt = HeadlessRuntime(build, cfg, enable_fracturing=False)
    before = build.sim.voxels.sdf.clone()
    rt.step(1)
    assert int((rt.sim.voxels.sdf != before)[0].sum()) > 0  # the sphere carved the box
