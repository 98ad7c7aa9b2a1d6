"""The port's ``compile_scene(world, cfg)`` against impact_tpu's on the CPU.

Each case builds a reference world, carries it into the port with
``bridge.world_from_reference`` and compiles both. The two compiles are
held equal field by field: integers, masks, slots and i8 SDFs exactly,
floats within ATOL + RTOL·|reference| (``tests/test_torch_engine_step.py``'s
bar: a voxel body's mass, inertia and centre of mass are float32 sums over
its voxels, taken in another order). The
worlds:

* interleaved entity kinds at the Voxel Range game's configuration: a
  rigid body before the ground plane, an absorber between rigid bodies, a
  joint and a distance rule naming them, three mesh entities (one on a
  body, a static one, and a textured one whose textures are registered
  with ``register_texture`` in each package), plain and shadowable lights
  in mixed order, voxel boxes, a sphere and a capsule between the bodies.
  The game's own world is compiled in ``tests/test_torch_impact_game.py``,
  which shares that configuration (and the reference's compiled programs
  when both files run in one process).

Each component the port does not lower yet raises NotImplementedError
naming its ROADMAP.md item, and so do ``sdf_generators``.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)

import impact_tpu.runtime.setup as jsetup
from impact_tpu.ecs import World
from impact_tpu.ecs import components as C
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch import bridge
from impact_tpu_torch.ecs import components as TC
from impact_tpu_torch.runtime import compile_scene
from impact_tpu_torch.runtime import setup as tsetup
from impact_tpu_torch.scene.spec import NOT_PORTED
from impact_tpu_torch.utils.config import EngineConfig

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def cache_small_compiles():
    """The reference's compile of a world runs ~800 small XLA compiles of
    ~45 ms each, under the suite's 2 s floor for the persistent compilation
    cache (tests/conftest.py): cache them too while this module runs."""
    floor = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", floor)


@pytest.fixture(autouse=True)
def texture_registries():
    """Both packages' texture registries as they were before each test."""
    saved = dict(jsetup.TEXTURE_SOURCES), dict(tsetup.TEXTURE_SOURCES)
    yield
    for reg, old in zip((jsetup.TEXTURE_SOURCES, tsetup.TEXTURE_SOURCES), saved):
        reg.clear()
        reg.update(old)


def configure(cfg):
    """The game's pools (24 objects of 16³, 40 bodies, 512 contacts) with
    a small render and texture size."""
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 24, 40, 512, 16
    t.max_fracture_fragments = 8
    t.render_width, t.render_height = 64, 48
    t.texture_resolution = 16
    cfg.physics.rigid_body_force.drag_load_map_config.directory = None
    return cfg


def assert_tree_close(got, ref, what):
    """Every field of the port's tuple against the reference's."""
    if ref is None or got is None:
        assert got is None and ref is None, what
    elif isinstance(ref, dict):
        for k in ref:
            assert_tree_close(got[k], ref[k], f"{what}.{k}")
    elif isinstance(ref, (list, tuple)) and not hasattr(ref, "_fields"):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_tree_close(g, r, f"{what}[{i}]")
    elif hasattr(ref, "_fields"):
        for f in got._fields:
            assert_tree_close(getattr(got, f), getattr(ref, f), f"{what}.{f}")
    else:
        a = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        b = np.asarray(ref)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=what)


def assert_builds_equal(got, ref):
    s, r = got.sim, ref.sim
    for f in ("bodies", "solver_cache"):
        assert_tree_close(getattr(s.phys, f), getattr(r.phys, f), f)
    for f in ("voxels", "meshes", "probes", "prev_position", "prev_orientation"):
        assert_tree_close(getattr(s, f), getattr(r, f), f)
    for group in ("collidables", "forces", "drivers", "joints"):
        assert_tree_close(getattr(got.params.phys_params, group),
                          getattr(ref.params.phys_params, group), group)
    for f in ("lights", "camera", "absorbers", "mesh_instances", "dist_rules",
              "casts_shadows_base", "type_density", "voxel_response", "fracturable",
              "fracture_threshold", "fracture_radius", "material_table"):
        assert_tree_close(getattr(got.params, f), getattr(ref.params, f), f)
    assert_tree_close(got.params.static_geometry.corners, ref.params.static_geometry.corners,
                      "static corners")
    for k in ("n_regular_bodies", "n_voxel_objects", "mesh_vert_cap", "mesh_tri_cap"):
        assert got.info[k] == ref.info[k], k
    assert [dict(o) for o in got.info["voxel_objects"]] == ref.info["voxel_objects"]
    assert_tree_close(got.info["entity_texture_layers"], ref.info["entity_texture_layers"],
                      "entity texture layers")


def interleaved_world():
    """Entity kinds in mixed order, each slot family fed out of order."""
    rng = np.random.default_rng(3)
    sources = {"albedo": rng.uniform(size=(16, 16, 3)).astype(np.float32),
               "rough": rng.uniform(size=(8, 8)).astype(np.float32),
               "height": rng.uniform(size=(16, 16, 1)).astype(np.float32)}
    ids = {k: jsetup.register_texture(f"world-compile-{k}", v) for k, v in sources.items()}
    assert ids == {k: tsetup.register_texture(f"world-compile-{k}", v)
                   for k, v in sources.items()}
    w = World()
    w.create_entity(C.AmbientEmission(illuminance=(500.0, 500.0, 500.0)))
    w.create_entity(C.ReferenceFrame(position=(8.0, 9.0, 4.0)),
                    C.ShadowableOmnidirectionalEmission(luminous_intensity=(3e5, 3e5, 3e5),
                                                        source_extent=0.3))
    ball = w.create_entity(  # a rigid body before the ground plane, with a mesh
        C.ReferenceFrame(position=(-3.0, 4.0, 0.5)), C.Motion(linear_velocity=(1.0, 0.0, 0.0)),
        C.SphereMesh(n_rings=6), C.UniformColor(color=(0.8, 0.2, 0.2)), C.ModelTransform(scale=0.6),
        C.SphericalCollidable(kind=0, radius=0.6, restitution=0.4),
        C.DynamicRigidBodySubstance(mass_density=900.0),
        C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)))
    w.create_entity(C.ReferenceFrame(position=(-6.0, 7.0, 2.0)),
                    C.OmnidirectionalEmission(luminous_intensity=(1e5, 1e5, 1e5)))
    w.create_entity(C.ReferenceFrame(),
                    C.PlanarCollidable(kind=1, normal=(0.0, 1.0, 0.0), displacement=0.0,
                                       restitution=0.2, static_friction=0.8,
                                       dynamic_friction=0.6))
    box = w.create_entity(
        C.ReferenceFrame(position=(0.0, 2.0, 0.0), orientation=(0.0, 0.3826834, 0.0, 0.9238795)),
        C.VoxelBox(voxel_extent=0.25, extent_x=8.0, extent_y=6.0, extent_z=8.0),
        C.SameVoxelType(voxel_type=2), C.DynamicVoxels(),
        C.VoxelCollidable(kind=0, restitution=0.1, static_friction=0.8, dynamic_friction=0.6),
        C.FracturingProperties(impulse_threshold=20.0, fracture_radius=2.0),
        C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)))
    w.create_entity(C.ReferenceFrame(position=(5.0, 1.0, -2.0)),
                    C.VoxelAbsorbingSphere(offset=(0.0, 0.5, 0.0), radius=1.2, rate=2.0))
    rod = w.create_entity(  # a dynamic capsule with a local force, after the absorber
        C.ReferenceFrame(position=(2.0, 5.0, 1.0)),
        C.CapsularCollidable(kind=0, segment_start=(0.0, -0.5, 0.0), segment_end=(0.0, 0.7, 0.0),
                             radius=0.3),
        C.DynamicRigidBodySubstance(mass_density=500.0),
        C.LocalForce(force=(0.0, 0.0, 2.0), point=(0.0, 0.5, 0.0)),
        C.FixedDirectionAlignmentTorque(strength=2.0))
    w.create_entity(C.UnidirectionalEmission(perpendicular_illuminance=(2e4, 2e4, 2e4),
                                             direction=(-0.3, -1.0, -0.2)))
    w.create_entity(C.ReferenceFrame(position=(-1.0, 0.0, -4.0)),  # a static mesh entity
                    C.BoxMesh(extent_x=2.0, extent_y=0.5, extent_z=1.0),
                    C.UniformColor(color=(0.2, 0.3, 0.9)), C.UniformMetalness(metalness=1.0),
                    C.UniformRoughness(roughness=0.3), C.SceneEntityFlags(flags=2))
    osc = w.create_entity(C.ReferenceFrame(position=(0.0, 6.0, -3.0)),
                          C.SphericalCollidable(kind=2, radius=0.4),
                          C.HarmonicOscillation(center=(0.0, 6.0, -3.0), amplitude=0.5,
                                                period=1.5))
    w.create_entity(  # a second voxel object, after the bodies, casting no shadow
        C.ReferenceFrame(position=(3.0, 3.0, 3.0)), C.Motion(angular_velocity=(0.0, 1.0, 0.0)),
        C.VoxelSphere(voxel_extent=0.25, radius=4.0), C.SameVoxelType(voxel_type=1),
        C.DynamicVoxels(), C.VoxelCollidable(kind=0), C.SceneEntityFlags(flags=2))
    w.create_entity(C.ReferenceFrame(position=(-5.0, 0.5, 5.0)),
                    C.VoxelAbsorbingCapsule(segment_end=(0.0, 1.5, 0.0), radius=0.5, rate=1.0))
    w.create_entity(C.ReferenceFrame(position=(0.0, 1.0, 6.0)), C.BoxMesh(),  # textured
                    C.UniformColor(color=(0.5, 0.5, 0.5)), C.TexturedColor(texture_id=ids["albedo"]),
                    C.TexturedRoughness(texture_id=ids["rough"], scale_factor=0.5),
                    C.ParallaxMap(height_map_texture_id=ids["height"], displacement_scale=0.05))
    w.create_entity(C.ReferenceFrame(position=(-4.0, 5.0, -6.0)),
                    C.VoxelCapsule(voxel_extent=0.25, segment_length=6.0, radius=3.0),
                    C.SameVoxelType(voxel_type=0))
    w.create_entity(C.ReferenceFrame(position=(6.0, 5.0, -6.0)),
                    C.VoxelBox(voxel_extent=0.3, extent_x=5.0, extent_y=5.0, extent_z=5.0),
                    C.DynamicVoxels(), C.VoxelCollidable(kind=0))
    w.create_entity(C.SphericalJoint(entity_a=ball, entity_b=rod, anchor_a=(0.5, 0.0, 0.0),
                                     anchor_b=(0.0, -0.5, 0.0)))
    w.add_component(box, C.DistanceTriggeredRules(anchor_id=osc, no_shadowing_dist_squared=400.0,
                                                  removal_dist_squared=900.0))
    w.create_entity(C.ReferenceFrame(position=(0.0, 6.0, 16.0),
                                     orientation=(0.0, 0.0, 0.0, 1.0)),
                    C.PerspectiveCamera(vertical_field_of_view=0.9, near_distance=0.1,
                                        far_distance=200.0))
    return w


def test_interleaved_world_compiles_as_the_reference():
    world = interleaved_world()
    port_world = bridge.world_from_reference(world)
    ref = jcompile(world, configure(JConfig()))
    got = compile_scene(port_world, configure(EngineConfig()), device="cpu")
    assert_builds_equal(got, ref)
    # the slots the interleaving fixes: bodies in entity order (ball 0,
    # ground 1, absorber 2, rod 3, oscillator 4, capsule absorber 5), the
    # ball's mesh on body 0, the static and the textured meshes unposed;
    # voxel object 0 (the box) on body 40 - 24
    assert got.sim.phys.bodies.kind[:7].tolist() == [1, 2, 2, 1, 2, 2, 0]
    assert got.params.absorbers.sph_body[0] == 2 and got.params.absorbers.cap_body[0] == 5
    assert got.params.mesh_instances.body_index.tolist() == [0, -1, -1]
    assert got.params.mesh_instances.material.tolist() == [-1, -1, 0]
    assert len(got.info["entity_texture_layers"]) == 1
    joints = got.params.phys_params.joints
    assert (int(joints.body_a[0]), int(joints.body_b[0])) == (0, 3)
    assert (int(got.params.dist_rules.body[0]), int(got.params.dist_rules.anchor_body[0])) == (16, 4)
    assert got.params.lights.omni_shadowable.tolist() == [False, True]
    assert got.info["n_voxel_objects"] == 4 and got.info["n_unique_shapes"] == 4
    # compiling strips the setup components from the world, as the reference does
    assert not port_world.entities_with(TC.VoxelBox)


def test_unregistered_texture_id_raises():
    w = World()
    w.create_entity(C.BoxMesh(), C.NormalMap(texture_id=12345))
    with pytest.raises(KeyError, match="not registered"):
        compile_scene(bridge.world_from_reference(w), configure(EngineConfig()), device="cpu")


UNSUPPORTED = {
    "VoxelSphereUnion": lambda: C.VoxelSphereUnion(),
    "GeneratedVoxelObject": lambda: C.GeneratedVoxelObject(generator_id=1),
    "HemisphereMesh": lambda: C.HemisphereMesh(),
    "CylinderMesh": lambda: C.CylinderMesh(),
    "ConeMesh": lambda: C.ConeMesh(),
    "RectangleMesh": lambda: C.RectangleMesh(),
    "TriangleMeshFile": lambda: C.TriangleMeshFile(path_hash=1),
    "OrthographicCamera": lambda: C.OrthographicCamera(),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED) + ["sdf_generators"])
def test_unsupported_component_raises(name):
    assert set(UNSUPPORTED) == set(NOT_PORTED)
    w = World()
    w.create_entity(C.ReferenceFrame(), C.VoxelBox(extent_x=4.0, extent_y=4.0, extent_z=4.0))
    kwargs = {}
    if name == "sdf_generators":
        kwargs["sdf_generators"] = {1: object()}
    else:
        w.create_entity(C.ReferenceFrame(), UNSUPPORTED[name]())
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        compile_scene(bridge.world_from_reference(w), configure(EngineConfig()), device="cpu",
                      **kwargs)
