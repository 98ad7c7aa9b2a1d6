"""Scene-driven physics in the port against impact_tpu on the CPU.

* Compiles: HarmonicOscillation, FreeRotation and DragDrop (as written, and
  with a medium of density 10), a SphericalJoint pair and a distance-rule
  scene. Every pool the compiles fill (bodies, collidables, forces with the
  drag tables, motion drivers, joints, distance rules, mesh instances,
  lights, camera, static geometry) equal, or within 1e-6 for floats
  computed by the same formulas; the drag tables equal (the same float64
  numpy). Drag maps are built without their disk cache
  (``directory=None``) in both packages.
* Steps: the three scenes and the joint pair, each compiled by impact_tpu,
  carried over by the bridge (drivers, forces, drag tables and joints) and
  stepped by both packages' ``HeadlessRuntime`` under the default ``scan``
  solver. DragDrop (in the medium) is bridged from the reference's state
  after 116 steps, so the ten steps both packages take end in floor
  contact (from step 124). Bar: the scan solve's (tests/test_torch_scan_solver.py), every
  body field within rtol 1e-5 and an atol of 1e-6 of the field's largest
  magnitude: the same formulas in float32, but XLA may fuse a multiply and
  an add where torch rounds twice, and each step carries the rounding on.
* The distance-rule scene of ``tests/test_runtime_features.py:202-245``
  stepped by the port, and DragDrop's missing drag (a reference fault).
"""

import functools

import numpy as np
import pytest
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)

from impact_tpu.ecs import World
from impact_tpu.ecs import components as C
from impact_tpu.models import SCENES as JSCENES
from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch import bridge
from impact_tpu_torch.models import SCENES
from impact_tpu_torch.ecs import World as TWorld
from impact_tpu_torch.ecs import components as TC
from impact_tpu_torch.physics.state import KIND_DYNAMIC, KIND_KINEMATIC
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene
from impact_tpu_torch.utils.config import EngineConfig
from impact_tpu_torch.utils.hashing import hash_str_to_u64

ATOL = 1e-6
FIELDS = ("position", "orientation", "momentum", "angular_momentum", "velocity",
          "angular_velocity")
RTOL, ATOL_OF_MAGNITUDE = 1e-5, 1e-6
# case → (steps the reference takes alone before the bridge, steps both take)
STEPS = {"HarmonicOscillation": (0, 20), "FreeRotation": (0, 30), "DragDrop_medium": (116, 10),
         "SphericalJoint": (0, 30)}


def configure(cfg, medium=0.0, n_objects=1, n_bodies=8, grid=8):
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = (
        n_objects, n_bodies, 8, grid)
    t.render_width, t.render_height = 48, 32
    # no quad merging: these scenes' only voxel surface is the distance-rule
    # box, and merging costs the reference's first compile ~17 s of JIT
    t.mesh_merge_levels = 0
    if hasattr(t, "steps_per_dispatch"):
        t.steps_per_dispatch = 1
    cfg.physics.simulator.initial_time_step_duration = 0.01
    cfg.physics.medium.mass_density = medium
    cfg.physics.rigid_body_force.drag_load_map_config.directory = None
    return cfg


def joint_pair():
    """A kinematic anchor and a dynamic ball on a SphericalJoint, swinging
    under gravity with a sideways push: (reference world, port world)."""
    w = World()
    a = w.create_entity(C.ReferenceFrame(position=(0.0, 5.0, 0.0)), C.KinematicRigidBodyMarker())
    b = w.create_entity(
        C.ReferenceFrame(position=(1.2, 5.0, 0.3)), C.Motion(linear_velocity=(0.0, 0.0, 1.0)),
        C.SphericalCollidable(kind=2, radius=0.3), C.DynamicRigidBodySubstance(mass_density=800.0),
        C.ConstantAcceleration(acceleration=(0.0, -9.81, 0.0)))
    w.create_entity(C.SphericalJoint(entity_a=a, entity_b=b, anchor_a=(0.0, 0.0, 0.0),
                                     anchor_b=(-1.2, 0.0, -0.3)))
    return w, bridge.world_from_reference(w)


def distance_rule_scene():
    """tests/test_runtime_features.py:202-245: a voxel box drifting away
    from a kinematic anchor at 2 m/s, its shadows off beyond 6 m, removed
    beyond 10 m: (reference world, port world)."""
    w = World()
    anchor = w.create_entity(C.ReferenceFrame(position=(0.0, 0.0, 0.0)),
                             C.KinematicRigidBodyMarker())
    w.create_entity(
        C.ReferenceFrame(position=(4.0, 0.0, 0.0)), C.Motion(linear_velocity=(2.0, 0.0, 0.0)),
        C.VoxelBox(voxel_extent=0.25, extent_x=6, extent_y=6, extent_z=6),
        C.SameVoxelType(voxel_type=0), C.DynamicVoxels(),
        C.DistanceTriggeredRules(anchor_id=anchor, no_shadowing_dist_squared=36.0,
                                 removal_dist_squared=100.0))
    return w, bridge.world_from_reference(w)


def rule_config(cfg):
    """The distance-rule test's configuration (but 8 contact slots), stepped
    under ``jacobi``: the scene has no contact, and the CPU's plain scan loop
    walks every slot every step."""
    cfg = configure(cfg, n_objects=2, n_bodies=16, grid=16)
    cfg.rendering.shadow_mapping.enabled = False
    cfg.rendering.ambient_occlusion.enabled = False
    cfg.tpu.solver_mode = "jacobi"
    return cfg


# name → (reference world, port world, configure kwargs)
CASES = {
    "HarmonicOscillation": lambda: (JSCENES["HarmonicOscillation"](),
                                    SCENES["HarmonicOscillation"](), {}),
    "FreeRotation": lambda: (JSCENES["FreeRotation"](), SCENES["FreeRotation"](), {}),
    "DragDrop": lambda: (JSCENES["DragDrop"](), SCENES["DragDrop"](), {}),
    "DragDrop_medium": lambda: (JSCENES["DragDrop"](), SCENES["DragDrop"](), dict(medium=10.0)),
    "SphericalJoint": lambda: (*joint_pair(), {}),
}


@functools.lru_cache(maxsize=None)
def builds(name):
    """(reference build, port build, port config, reference config) of a
    case."""
    world, scene, kw = CASES[name]()
    jcfg = configure(JConfig(), **kw)
    ref = jcompile(world, jcfg)
    cfg = configure(EngineConfig(), **kw)
    return ref, compile_scene(scene, cfg, device="cpu"), cfg, jcfg


def assert_tree_close(got, ref, what):
    """Every field the port's tuple shares with the reference's: equal, or
    within ATOL for floats."""
    if ref is None or got is None:
        assert got is None and ref is None, what
    elif isinstance(ref, dict):
        for k in ref:
            assert_tree_close(got[k], ref[k], f"{what}.{k}")
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
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_scene_compile_matches_reference(name):
    ref, got, *_ = builds(name)
    assert_tree_close(got.sim.phys.bodies, ref.sim.phys.bodies, "bodies")
    for group in ("collidables", "forces", "drivers", "joints"):
        assert_tree_close(getattr(got.params.phys_params, group),
                          getattr(ref.params.phys_params, group), group)
    for f in ("lights", "camera", "mesh_instances", "dist_rules", "casts_shadows_base"):
        assert_tree_close(getattr(got.params, f), getattr(ref.params, f), f)
    assert_tree_close(got.params.static_geometry.corners, ref.params.static_geometry.corners,
                      "static corners")
    assert got.info["n_regular_bodies"] == ref.info["n_regular_bodies"]


@pytest.mark.parametrize("name", list(STEPS))
def test_bridged_scene_steps_match_reference(name):
    ref_build, _, cfg, jcfg = builds(name)
    alone, both = STEPS[name]
    jr = JRuntime(ref_build, jcfg)
    jr.step(alone)
    build = bridge.scene_build_from_reference(ref_build, device="cpu")
    build.sim = bridge.sim_state_from_reference(jr.sim, device="cpu")
    jr.step(both)
    rt = HeadlessRuntime(build, cfg)
    rt.step(both)
    for f in FIELDS:
        ref = np.asarray(getattr(jr.sim.phys.bodies, f))
        got = getattr(rt.sim.phys.bodies, f).numpy()
        atol = ATOL_OF_MAGNITUDE * max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=f)
    if name == "DragDrop_medium":
        # the spheres reached the floor: the scan solve had contacts to walk
        assert int(np.asarray(jr.sim.phys.solver_cache.active).sum()) > 0
        assert int(rt.sim.phys.solver_cache.active.sum()) > 0


def test_scene_table_matches_reference():
    assert list(SCENES) == list(JSCENES)


def test_scene_physics_pools_are_filled():
    """What the three scenes set up: a phantom sphere on a kinematic body
    under a harmonic driver; a dynamic body with an explicit inertia; two
    dynamic spheres under gravity with detailed drag of coefficients 0 and
    4, each with its map, as the reference builds them."""
    osc = builds("HarmonicOscillation")[1].params.phys_params
    assert int(osc.drivers.osc_mask.sum()) == 1 and int(osc.collidables.sph_kind[0]) == 2
    rot = builds("FreeRotation")[1]
    assert int(rot.sim.phys.bodies.kind[0]) == KIND_DYNAMIC
    torch.testing.assert_close(rot.sim.phys.bodies.inertia_body[0],
                               torch.diag(torch.tensor([0.2, 1.0, 2.0])))
    dd = builds("DragDrop_medium")[1].params.phys_params.forces
    assert dd.drag_map_index[:3].tolist() == [-1, 0, 1] and dd.drag_map_table.shape == (2, 32, 64, 6)
    assert float(dd.medium_density) == 10.0 and dd.drag_coef[:3].tolist() == [0.0, 0.0, 4.0]
    joint = builds("SphericalJoint")[1]
    assert joint.sim.phys.bodies.kind[:2].tolist() == [KIND_KINEMATIC, KIND_DYNAMIC]
    assert joint.params.phys_params.joints.mask.sum() == 1


def test_missing_scene_texture_raises():
    w = TWorld()
    w.create_entity(TC.BoxMesh(), TC.TexturedColor(texture_id=hash_str_to_u64("not-there")))
    with pytest.raises(KeyError):
        compile_scene(w, configure(EngineConfig()), device="cpu")


def test_distance_rules_compile_and_act_as_the_reference_test():
    """The compile against the reference's (at the other cases' small
    config), then the reference test's steps in the port at its config:
    within 6 m both flags stay on, after 180 more steps (~7.6 m) the box
    casts no shadow but lives, after 200 more (~11.6 m) its slot is dead and
    its body empty (kind 0)."""
    world, scene = distance_rule_scene()
    ref = jcompile(world, configure(JConfig()))
    got = compile_scene(scene, configure(EngineConfig()), device="cpu")
    for f in ("dist_rules", "casts_shadows_base"):
        assert_tree_close(getattr(got.params, f), getattr(ref.params, f), f)
    assert_tree_close(got.sim.phys.bodies.kind, ref.sim.phys.bodies.kind, "kind")
    cfg = rule_config(EngineConfig())
    rt = HeadlessRuntime(compile_scene(distance_rule_scene()[1], cfg, device="cpu"), cfg)
    assert bool(rt.sim.voxels.casts_shadows[0])
    rt.step(1)
    assert bool(rt.sim.voxels.casts_shadows[0]) and bool(rt.sim.voxels.alive[0])
    rt.step(180)
    assert not bool(rt.sim.voxels.casts_shadows[0]) and bool(rt.sim.voxels.alive[0])
    rt.step(200)
    assert not bool(rt.sim.voxels.alive[0])
    assert int(rt.sim.phys.bodies.kind[int(rt.params.dist_rules.body[0])]) == 0


def test_drag_drop_as_written_has_no_drag():
    """A reference fault, reproduced: DragDrop's "dense medium" is the
    default medium of density 0, where DetailedDrag acts not at all
    (impact_tpu/physics/forces.py:186). Both spheres falling at 5 m/s feel
    the same force in both packages as written, and different forces in a
    medium of density 10; stepped by the port, the spheres fall alike."""
    import jax.numpy as jnp

    from impact_tpu.physics import forces as jforces
    from impact_tpu.physics import state as jstate
    from impact_tpu_torch import bridge
    from impact_tpu_torch.physics import forces as tforces
    from impact_tpu_torch.physics import state as tstate

    for name, alike in (("DragDrop", True), ("DragDrop_medium", False)):
        ref, got, *_ = builds(name)
        jb = ref.sim.phys.bodies
        v = np.zeros(jb.velocity.shape, np.float32)
        v[1:3, 1] = -5.0
        jb = jstate.synchronize_momenta(jb, jnp.asarray(v), jb.angular_velocity)
        jf = np.asarray(jforces.apply_forces_and_torques(jb, ref.params.phys_params.forces)
                        .total_force)
        tf = tforces.apply_forces_and_torques(bridge.tuple_from_reference(
            tstate.BodyState, jb, device="cpu"), got.params.phys_params.forces).total_force
        np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-6, atol=1e-6)
        assert (jf[1, 1] == jf[2, 1]) == alike and (float(tf[1, 1]) == float(tf[2, 1])) == alike
    _, got, cfg, _ = builds("DragDrop")
    rt = HeadlessRuntime(got, cfg)
    rt.step(30)
    b = rt.sim.phys.bodies
    assert torch.equal(b.velocity[1], b.velocity[2])
    assert float(b.position[1, 1]) == float(b.position[2, 1]) < 7.6  # 8 m − g(0.3 s)²/2 = 7.56
