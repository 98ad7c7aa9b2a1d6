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

* each component the port lowers since the SDF generation slice
  (VoxelSphereUnion, GeneratedVoxelObject with ``sdf_generators``, the
  hemisphere, cylinder, cone and rectangle meshes, an OBJ mesh file, the
  orthographic camera) in a small world, compiled and stepped once in both
  packages; and the reference's behaviours the port keeps: an unregistered
  mesh file lowers to no mesh, a generated object's seed and scale factor
  change nothing, an unknown generator id raises KeyError.
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
from impact_tpu.voxel import sdf as jsdf
from impact_tpu_torch import bridge
from impact_tpu_torch.ecs import components as TC
from impact_tpu_torch.runtime import compile_scene
from impact_tpu_torch.runtime import setup as tsetup
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


def assert_tree_close(got, ref, what, atol_of_magnitude=0.0):
    """Every field of the port's tuple against the reference's; each float
    field within ATOL (or ``atol_of_magnitude`` of its largest magnitude,
    the larger) + RTOL·|reference|."""
    if ref is None or got is None:
        assert got is None and ref is None, what
    elif isinstance(ref, dict):
        for k in ref:
            assert_tree_close(got[k], ref[k], f"{what}.{k}", atol_of_magnitude)
    elif isinstance(ref, (list, tuple)) and not hasattr(ref, "_fields"):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_tree_close(g, r, f"{what}[{i}]", atol_of_magnitude)
    elif hasattr(ref, "_fields"):
        for f in got._fields:
            assert_tree_close(getattr(got, f), getattr(ref, f), f"{what}.{f}",
                              atol_of_magnitude)
    else:
        a = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        b = np.asarray(ref)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            mag = float(np.abs(b).max()) if b.size else 0.0
            np.testing.assert_allclose(a, b, atol=max(ATOL, atol_of_magnitude * mag),
                                       rtol=RTOL, err_msg=what)


def assert_builds_equal(got, ref, atol_of_magnitude=0.0):
    def close(g, r, what):
        assert_tree_close(g, r, what, atol_of_magnitude)

    s, r = got.sim, ref.sim
    for f in ("bodies", "solver_cache"):
        close(getattr(s.phys, f), getattr(r.phys, f), f)
    for f in ("voxels", "meshes", "probes", "prev_position", "prev_orientation"):
        close(getattr(s, f), getattr(r, f), f)
    for group in ("collidables", "forces", "drivers", "joints"):
        close(getattr(got.params.phys_params, group), getattr(ref.params.phys_params, group),
              group)
    for f in ("lights", "camera", "absorbers", "mesh_instances", "dist_rules",
              "casts_shadows_base", "type_density", "voxel_response", "fracturable",
              "fracture_threshold", "fracture_radius", "material_table"):
        close(getattr(got.params, f), getattr(ref.params, f), f)
    close(got.params.static_geometry.corners, ref.params.static_geometry.corners,
          "static corners")
    for k in ("n_regular_bodies", "n_voxel_objects", "mesh_vert_cap", "mesh_tri_cap"):
        assert got.info[k] == ref.info[k], k
    assert [dict(o) for o in got.info["voxel_objects"]] == ref.info["voxel_objects"]
    close(got.info["entity_texture_layers"], ref.info["entity_texture_layers"],
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


# --- the components the port lowers since the SDF generation slice ---------------
#
# Each case compiles a small world that holds the component (or, for
# ``sdf_generators``, GeneratedVoxelObjects whose graphs the call registers)
# in both packages: a ground plane, one voxel object, one mesh entity on a
# dynamic sphere body and a camera, so that every case has the same pool
# shapes and the reference compiles its step once. The builds are held
# equal under this file's bars, except that each float field is also
# allowed an atol of 1e-6 of its magnitude (the scan tests' bar): the mass
# properties of a curved voxel object are float32 sums over its voxels taken
# in another order, and the terms that cancel to 0 leave ~1e-8 of the
# magnitude. Then one step, with the voxel object resting on the ground,
# is held to the reference's under the scan tests' bar (rtol 1e-5 and 1e-6
# of each field's magnitude).

SCAN_RTOL, ATOL_OF_MAGNITUDE = 1e-5, 1e-6
STEP_FIELDS = ("position", "orientation", "velocity", "angular_velocity", "momentum",
               "angular_momentum")


def small(cfg):
    """8 objects of 16³, 16 bodies, 128 contact slots, a 64x48 frame."""
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 8, 16, 128, 16
    t.max_fracture_fragments = 4
    t.render_width, t.render_height = 64, 48
    t.steps_per_dispatch = 1
    cfg.physics.rigid_body_force.drag_load_map_config.directory = None
    return cfg


def example_graph(sdf):
    """The voxel generator's example graph at 0.12 of its size: a noisy rock
    with a capsule spike, inside a 16³ grid of 0.25-unit voxels."""
    rock = sdf.noise_modifier(sdf.sphere(9.0), octaves=4, frequency=0.25, persistence=0.55,
                              amplitude=1.8, seed=7)
    return sdf.scaling(sdf.union(rock, sdf.translation(sdf.capsule(1.5, 10.0), (0.0, 6.0, 0.0)),
                                 smoothness=1.5), 0.12)


def meta_graph():
    """A meta graph lowered at seed 7: boxes on a sphere of radius 1.2."""
    from impact_tpu_torch.voxel import meta_sdf

    return meta_sdf.lower(meta_sdf.sphere_surface_transforms(
        meta_sdf.meta_boxes(extent=meta_sdf.uniform(0.2, 0.5)), count=6, sphere_radius=1.2,
        jitter=0.2), seed=7)


def write_obj(path):
    """A closed unit box as an OBJ of quads, its normals computed on load."""
    path.write_text(
        "v -0.5 -0.5 -0.5\nv 0.5 -0.5 -0.5\nv 0.5 0.5 -0.5\nv -0.5 0.5 -0.5\n"
        "v -0.5 -0.5 0.5\nv 0.5 -0.5 0.5\nv 0.5 0.5 0.5\nv -0.5 0.5 0.5\n"
        "f 1 4 3 2\nf 5 6 7 8\nf 1 2 6 5\nf 2 3 7 6\nf 3 4 8 7\nf 4 1 5 8\n")
    return path


def generation_world(voxel=None, mesh=None, ortho=False):
    """The reference world of a case: ``voxel`` (default a voxel box) rests
    on the ground, ``mesh`` (default a box mesh) rides a falling sphere."""
    w = World()
    w.create_entity(C.AmbientEmission(illuminance=(400.0, 400.0, 400.0)))
    w.create_entity(C.ReferenceFrame(position=(4.0, 8.0, 4.0)),
                    C.ShadowableOmnidirectionalEmission(luminous_intensity=(2e5, 2e5, 2e5)))
    w.create_entity(C.ReferenceFrame(),
                    C.PlanarCollidable(kind=1, normal=(0.0, 1.0, 0.0), displacement=0.0,
                                       restitution=0.2, static_friction=0.8,
                                       dynamic_friction=0.6))
    w.create_entity(C.ReferenceFrame(position=(0.0, 0.7, 0.0)),
                    voxel if voxel is not None else C.VoxelBox(extent_x=6.0, extent_y=6.0,
                                                               extent_z=6.0),
                    C.DynamicVoxels(), C.SameVoxelType(voxel_type=1),
                    C.VoxelCollidable(kind=0, restitution=0.1, static_friction=0.8,
                                      dynamic_friction=0.6),
                    C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)))
    w.create_entity(C.ReferenceFrame(position=(3.0, 2.0, -1.0)),
                    mesh if mesh is not None else C.BoxMesh(),
                    C.UniformColor(color=(0.3, 0.6, 0.9)), C.ModelTransform(scale=0.8),
                    C.SphericalCollidable(kind=0, radius=0.5),
                    C.DynamicRigidBodySubstance(mass_density=500.0),
                    C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)))
    cam = (C.OrthographicCamera(vertical_field_of_view=0.3, near_distance=0.1,
                                far_distance=40.0) if ortho
           else C.PerspectiveCamera(vertical_field_of_view=1.0, near_distance=0.1,
                                    far_distance=100.0))
    w.create_entity(C.ReferenceFrame(position=(0.0, 3.0, 12.0)), cam)
    return w


FORMERLY_UNSUPPORTED = {
    "VoxelSphereUnion": lambda tmp: dict(voxel=C.VoxelSphereUnion(
        radius_1=3.0, radius_2=2.5, center_offsets=(4.0, 0.0, 0.0), smoothness=1.5)),
    "GeneratedVoxelObject": lambda tmp: dict(
        voxel=C.GeneratedVoxelObject(generator_id=3), sdf_generators={3: meta_graph()}),
    "HemisphereMesh": lambda tmp: dict(mesh=C.HemisphereMesh(n_rings=5)),
    "CylinderMesh": lambda tmp: dict(mesh=C.CylinderMesh(length=1.5, diameter=0.8,
                                                         n_circumference_vertices=12)),
    "ConeMesh": lambda tmp: dict(mesh=C.ConeMesh(length=1.2, max_diameter=0.9,
                                                 n_circumference_vertices=10)),
    "RectangleMesh": lambda tmp: dict(mesh=C.RectangleMesh(extent_x=1.5, extent_z=0.7)),
    "TriangleMeshFile": lambda tmp: dict(mesh=C.TriangleMeshFile(
        path_hash=register_mesh_files(write_obj(tmp / "box.obj")))),
    "OrthographicCamera": lambda tmp: dict(ortho=True),
    "sdf_generators": lambda tmp: dict(
        voxel=C.GeneratedVoxelObject(generator_id=tsetup.hash_str_to_u64("rock") & 0xFFFFFFFF),
        sdf_generators={tsetup.hash_str_to_u64("rock") & 0xFFFFFFFF: example_graph(jsdf),
                        5: meta_graph()}),
}


def register_mesh_files(path):
    h = jsetup.register_mesh_file(path)
    assert tsetup.register_mesh_file(path) == h
    return h


@pytest.fixture(autouse=True)
def mesh_file_registries():
    """Both packages' mesh-file registries as they were before each test."""
    saved = dict(jsetup.MESH_FILE_PATHS), dict(tsetup.MESH_FILE_PATHS)
    yield
    for reg, old in zip((jsetup.MESH_FILE_PATHS, tsetup.MESH_FILE_PATHS), saved):
        reg.clear()
        reg.update(old)


def assert_builds_close(got, ref):
    """``assert_builds_equal`` with each float field also allowed an atol
    of ATOL_OF_MAGNITUDE of its magnitude."""
    assert_builds_equal(got, ref, atol_of_magnitude=ATOL_OF_MAGNITUDE)


def compile_both(case, tmp_path):
    """(port build, port config, reference build, reference config) of a case."""
    kw = dict(FORMERLY_UNSUPPORTED[case](tmp_path))
    gens = kw.pop("sdf_generators", None)
    world = generation_world(**kw)
    port_world = bridge.world_from_reference(world)
    jcfg, cfg = small(JConfig()), small(EngineConfig())
    ref = jcompile(world, jcfg, sdf_generators=gens)
    got = compile_scene(port_world, cfg, sdf_generators=gens, device="cpu")
    return got, cfg, ref, jcfg


@pytest.fixture(scope="module")
def reference_step():
    """build, config → the reference's state after one step. Every case has
    the same pool shapes, absorbers (none) and distance rules (none), the
    step's only static inputs from the scene, so one runtime's jitted step
    serves them all."""
    from impact_tpu.runtime import HeadlessRuntime as JRuntime

    runtime = []

    def step(build, jcfg):
        if not runtime:
            runtime.append(JRuntime(build, jcfg))
        return runtime[0]._step(build.sim, build.params)

    return step


@pytest.mark.parametrize("name", list(FORMERLY_UNSUPPORTED))
def test_unsupported_component_raises(name, tmp_path, reference_step):
    """Each component that ``compile_scene`` once refused with
    NotImplementedError, and ``sdf_generators``, now compiles as the
    reference's and steps as the reference's."""
    from impact_tpu_torch.runtime import HeadlessRuntime

    got, cfg, ref, jcfg = compile_both(name, tmp_path)
    assert_builds_close(got, ref)
    assert cfg.tpu.orthographic_camera == jcfg.tpu.orthographic_camera == (
        name == "OrthographicCamera")
    assert got.info["n_voxel_objects"] == 1
    assert got.params.mesh_instances.alive.tolist() == [True]
    rt = HeadlessRuntime(got, cfg)
    rt.step(1)
    jsim = reference_step(ref, jcfg)
    for f in STEP_FIELDS:
        want = np.asarray(getattr(jsim.phys.bodies, f))
        atol = ATOL_OF_MAGNITUDE * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(getattr(rt.sim.phys.bodies, f).numpy(), want, rtol=SCAN_RTOL,
                                   atol=atol, err_msg=f"{name}: {f} after one step")
    assert int(rt.sim.phys.solver_cache.active.sum()) == int(
        np.asarray(jsim.phys.solver_cache.active).sum()) > 0


def test_unregistered_mesh_file_lowers_no_mesh(tmp_path):
    """A TriangleMeshFile whose path was never registered lowers to no mesh
    entity (impact_tpu/runtime/setup.py:530-532, 547-548); its body stays."""
    world = generation_world(mesh=C.TriangleMeshFile(path_hash=12345))
    port_world = bridge.world_from_reference(world)
    ref = jcompile(world, small(JConfig()))
    got = compile_scene(port_world, small(EngineConfig()), device="cpu")
    assert_builds_close(got, ref)
    assert got.params.mesh_instances.alive.shape == (0,)
    assert got.info["n_regular_bodies"] == 2


def test_generated_object_reads_only_generator_id(tmp_path):
    """A GeneratedVoxelObject's ``seed`` and ``scale_factor`` change
    nothing: the reference reads only ``generator_id``
    (impact_tpu/runtime/setup.py:366-367)."""
    gens = {3: meta_graph()}
    plain = generation_world(voxel=C.GeneratedVoxelObject(generator_id=3))
    varied = generation_world(voxel=C.GeneratedVoxelObject(generator_id=3, seed=99,
                                                           scale_factor=2.5))
    port_varied = bridge.world_from_reference(varied)
    ref = jcompile(varied, small(JConfig()), sdf_generators=gens)
    got = compile_scene(port_varied, small(EngineConfig()), sdf_generators=gens, device="cpu")
    base = compile_scene(bridge.world_from_reference(plain), small(EngineConfig()),
                         sdf_generators=gens, device="cpu")
    assert_builds_close(got, ref)
    assert torch.equal(got.sim.voxels.sdf, base.sim.voxels.sdf)
    assert torch.equal(got.sim.phys.bodies.mass, base.sim.phys.bodies.mass)


def test_unknown_generator_id_raises():
    """A GeneratedVoxelObject whose generator_id is not in sdf_generators
    raises KeyError, as the reference's lookup does."""
    gens = {3: meta_graph()}
    for compile_fn, world, cfg, kw in (
            (jcompile, generation_world(voxel=C.GeneratedVoxelObject(generator_id=4)),
             small(JConfig()), {}),
            (compile_scene, bridge.world_from_reference(generation_world(
                voxel=C.GeneratedVoxelObject(generator_id=4))), small(EngineConfig()),
             dict(device="cpu"))):
        with pytest.raises(KeyError):
            compile_fn(world, cfg, sdf_generators=gens, **kw)
