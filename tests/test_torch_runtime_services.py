"""The port's runtime services on the CPU: the cases of
``tests/test_runtime_features.py:36-130,191`` on a small port-only world
(BallPit with three balls, 2 object slots of 16³, 24 bodies, 16 contact
slots, 48x32), with no JAX stepping. The gizmo commands toggle
``visible_gizmos`` as the reference's do (the overlay itself is held
against impact_tpu in ``tests/test_torch_gizmos.py``).

* Commands: pause makes ``step`` a no-op (state ``torch.equal``), resume
  restores stepping; a physics command rebuilds the step (keeping the host
  read count); a rendering command rebuilds the render configuration (the
  exposure compensation as the reference's ``Variant``); reset; the
  reference's ValueErrors.
* Checkpoints: a round trip is ``torch.equal`` on every field; save, step
  k, load, step k gives a state ``torch.equal`` to the first k steps'
  (the fracture generator's state included), and a checkpoint's keys are
  the reference's field paths.
* ``profile`` writes a Chrome trace; ``run`` returns its frames and
  records frame durations.
* ``enable_absorption`` (and the engine step's ``enable_voxel_contacts``)
  and a custom voxel-type ``registry`` (the material rebake).
"""

import json

import numpy as np
import pytest
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)

from impact_tpu_torch.ecs import components as C
from impact_tpu_torch.models import ball_pit, voxel_box_tumbler
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene, make_engine_step
from impact_tpu_torch.runtime.checkpoint import RNG_STATE_KEY
from impact_tpu_torch.scene.materials import make_voxel_type_registry, material_corner_table
from impact_tpu_torch.utils.config import EngineConfig
from impact_tpu_torch.utils.ron import Variant


def tiny_config():
    cfg = EngineConfig()
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 2, 24, 16, 16
    t.render_width, t.render_height = 48, 32
    cfg.rendering.shadow_mapping.enabled = False
    cfg.rendering.ambient_occlusion.enabled = False
    return cfg


def tiny_runtime(**kwargs):
    cfg = tiny_config()
    return HeadlessRuntime(compile_scene(ball_pit(n_balls=3), cfg, device="cpu"), cfg, **kwargs)


def states_equal(a, b):
    """Every tensor of two SimStates equal, the generators in one state."""
    for (name, x), y in zip(a._asdict().items(), b):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), name
        elif hasattr(x, "_fields"):
            states_equal(x, y)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name


def test_pause_resume():
    rt = tiny_runtime()
    rt.step(3)
    before = rt.sim
    rt.enqueue_command("game_loop", "pause")
    rt.step(3)
    assert rt.paused and rt.sim is before
    states_equal(rt.sim, before)
    rt.enqueue_command("game_loop", "resume")
    rt.step(3)
    assert not torch.equal(before.phys.bodies.position, rt.sim.phys.bodies.position)


def test_physics_command_rebuilds_the_step():
    rt = tiny_runtime()
    rt.step(2)
    old_step, syncs = rt._step, rt.host_syncs
    rt.enqueue_command("physics", "set_n_iterations", 2)
    rt.enqueue_command("physics", "set_simulation_speed", 0.005)
    rt.step(1)
    assert rt.config.physics.constraint_solver.n_iterations == 2
    assert rt._step is not old_step and rt.host_syncs > syncs
    assert float(rt.sim.phys.time) == pytest.approx(2 * 0.01667 + 0.005, rel=1e-5)


def test_rendering_commands_rebuild_the_render_config():
    rt = tiny_runtime()
    rt.enqueue_command("rendering", "set_tone_mapping", "KhronosPBRNeutral")
    rt.enqueue_command("rendering", "set_bloom_enabled", False)
    rt.enqueue_command("rendering", "set_exposure_compensation", 1.5)
    rt.apply_commands()
    rc = rt.render_config
    assert rc.tone_mapping == "KhronosPBRNeutral" and not rc.bloom_enabled
    sens = rt.config.rendering.capturing_camera.settings.sensitivity
    assert isinstance(sens, Variant) and sens.fields == {"ev_compensation": 1.5}
    assert rc.exposure_ev_compensation == 1.5 and rc.exposure_iso is None


def test_reset_world():
    rt = tiny_runtime()
    p0 = rt.sim.phys.bodies.position.clone()
    rt.step(5)
    rt.enqueue_command("system", "reset_world")
    rt.apply_commands()
    assert torch.equal(p0, rt.sim.phys.bodies.position)


@pytest.mark.parametrize("category, action", [("rendering", "bogus"), ("physics", "bogus"),
                                              ("game_loop", "bogus"), ("system", "bogus"),
                                              ("bogus", "pause")])
def test_unknown_command_raises(category, action):
    rt = tiny_runtime()
    rt.enqueue_command(category, action, 1)
    with pytest.raises(ValueError):
        rt.apply_commands()


@pytest.mark.parametrize("action, value, before, after", [
    ("show", "reference_frame_axes", ("linear_velocity",),
     ("linear_velocity", "reference_frame_axes")),
    ("hide", "linear_velocity", ("contacts", "linear_velocity"), ("contacts",)),
    ("set_visible", ["torque", "force", "torque"], ("contacts",), ("force", "torque")),
])
def test_gizmo_commands_toggle_visibility(action, value, before, after):
    """The reference's gizmo commands (runtime/command.py:112-123): the
    visible kinds become a sorted tuple; an unknown action raises."""
    rt = tiny_runtime()
    rt.visible_gizmos = before
    rt.enqueue_command("gizmo", action, value)
    rt.apply_commands()
    assert rt.visible_gizmos == after
    rt.enqueue_command("gizmo", "bogus", value)
    with pytest.raises(ValueError, match="unknown gizmo command"):
        rt.apply_commands()


def test_checkpoint_round_trip_is_equal(tmp_path):
    rt = tiny_runtime()
    rt.step(4)
    saved = rt.sim
    path = rt.save_checkpoint(tmp_path / "ckpt.npz", {"frame": 4})
    rt.step(4)
    assert rt.load_checkpoint(path) == {"frame": 4}
    states_equal(rt.sim, saved)
    with np.load(path) as data:
        keys = set(data)
    assert {"phys/bodies/position", "voxels/sdf", "meshes/tri_active", "probes/active",
            "render/frame_index", "prev_position", RNG_STATE_KEY} <= keys


def test_resume_determinism(tmp_path):
    """save, step k, load, step k: the two states are torch.equal, fracture
    generator included (the fracturing scene's event falls in the steps)."""
    cfg = tiny_config()
    cfg.tpu.max_voxel_objects, cfg.tpu.max_bodies, cfg.tpu.max_contacts = 12, 24, 32
    cfg.tpu.max_fracture_fragments = 8
    world = voxel_box_tumbler(n_boxes=1, seed=0)
    ball = world.create_entity(C.ReferenceFrame(position=(-6.0, 1.5, 0.0)),
                               C.Motion(linear_velocity=(30.0, 0.0, 0.0)),
                               C.VoxelSphere(voxel_extent=0.25, radius=3.0),
                               C.DynamicVoxels(), C.VoxelCollidable(kind=0))
    for eid in world.entities_with(C.VoxelBox):
        world.add_component(eid, C.FracturingProperties(impulse_threshold=0.5,
                                                        fracture_radius=1.5))
        world.set_field(eid, C.ReferenceFrame, "position", (0.0, 1.5, 0.0))
    assert ball
    rt = HeadlessRuntime(compile_scene(world, cfg, device="cpu"), cfg)
    rt.save_checkpoint(tmp_path / "c.npz")
    alive0 = int(rt.sim.voxels.alive.sum())
    rt.step(10)
    first = rt.sim
    assert int(first.voxels.alive.sum()) > alive0  # the box fractured
    rt.load_checkpoint(tmp_path / "c.npz")
    rt.step(10)
    states_equal(rt.sim, first)


def test_profile_writes_a_trace(tmp_path):
    rt = tiny_runtime()
    with rt.profile(str(tmp_path)) as prof:
        rt.render()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any(e.key.startswith("aten::") for e in prof.key_averages())


def test_run_returns_frames_and_records_durations(tmp_path):
    rt = tiny_runtime()
    frames = rt.run(6, render_every=3, screenshot_path=str(tmp_path))
    assert len(frames) == 2 and tuple(frames[0].shape) == (32, 48, 3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["frame_00000.png", "frame_00003.png"]
    assert rt.metrics.fps > 0 and rt.metrics.current_smooth_frame_duration > 0
    times = rt.metrics.last_task_execution_times
    assert times["step"][1] == 6 and times["render"][1] == 2


def test_feature_flags_reach_the_step():
    """Without absorption the scene's absorber carves nothing (and defers
    nothing); an engine step without voxel contacts lets the box fall
    through the floor (``make_engine_step(enable_voxel_contacts=False)``)."""
    cfg = tiny_config()

    def world():
        w = voxel_box_tumbler(n_boxes=1, seed=0)
        box = w.entities_with(C.VoxelBox)[0]
        pos = w.get_component(box, C.ReferenceFrame).position
        pos[1] = 1.0
        w.set_field(box, C.ReferenceFrame, "position", pos)
        w.create_entity(C.ReferenceFrame(position=pos), C.VoxelAbsorbingSphere(radius=1.0))
        return w

    carved, rts = {}, {}
    for absorb in (True, False):
        rt = rts[absorb] = HeadlessRuntime(compile_scene(world(), cfg, device="cpu"), cfg,
                                           enable_fracturing=False, enable_absorption=absorb)
        sdf0 = rt.sim.voxels.sdf.clone()
        rt.step(10)
        carved[absorb] = not torch.equal(sdf0, rt.sim.voxels.sdf)
    assert carved == {True: True, False: False}
    assert rts[False].deferred_absorptions() == 0
    build = compile_scene(world(), cfg, device="cpu")
    step = make_engine_step(build.params, cfg, build.info["mesh_vert_cap"],
                            build.info["mesh_tri_cap"], enable_voxel_contacts=False,
                            enable_fracturing=False)
    sim = build.sim
    for _ in range(10):
        sim = step(sim)
    y = {k: float(s.phys.bodies.position[s.voxels.body_index[0], 1])
         for k, s in (("contacts", rts[False].sim), ("no contacts", sim))}
    assert y["no contacts"] < y["contacts"] - 0.05


def test_custom_registry_rebakes_the_materials():
    cfg = tiny_config()
    build = compile_scene(voxel_box_tumbler(n_boxes=1, seed=0), cfg, device="cpu")
    red = make_voxel_type_registry([{"name": "Red", "color": (1.0, 0.0, 0.0), "roughness": 0.5}])
    rt = HeadlessRuntime(build, cfg, registry=red)
    assert torch.equal(rt.params.material_table, material_corner_table(red))
    tris = rt.sim.meshes.tri_active[0]
    albedo = rt.sim.meshes.tri_albedo[0][tris]
    assert torch.allclose(albedo, torch.tensor([1.0, 0.0, 0.0]).repeat(1, 3).expand_as(albedo))
    assert not torch.equal(build.sim.meshes.tri_albedo, rt.sim.meshes.tri_albedo)
