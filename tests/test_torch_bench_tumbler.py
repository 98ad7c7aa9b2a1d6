"""The bench tumbler's placement, stepped in both packages on the CPU at
reduced depth (6 of the bench's 62 boxes, 8 slots).

``bench.py`` grows the tumbler's boxes from 10 to 26 voxels (6.5 m) but
keeps the scene's 5 m spacing, so the tower starts interpenetrated; the
jacobi solve diverges on the interlocked contacts (infinite friction) and
the body state is no longer finite after two steps, in impact_tpu as in the
port. The port keeps that behaviour (ROADMAP Queue 3) and steps
``bench_step_scene`` instead, whose 11.5 m spacing clears a box's
bounding sphere: there both packages stay finite and agree."""

import jax.numpy as jnp
import numpy as np
import pytest

from impact_tpu.ecs import components as C
from impact_tpu.models import voxel_box_tumbler as jtumbler
from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch.ecs import components as TC
from impact_tpu_torch.models import bench
from impact_tpu_torch.models import voxel_box_tumbler as ttumbler
from impact_tpu_torch.runtime import HeadlessRuntime as TRuntime
from impact_tpu_torch.runtime import compile_scene as tcompile

N_BOXES = 6


def _jax_config():
    c = JConfig()
    t = c.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts = 8, 24, 1024
    t.voxel_grid_size, t.sdf_encoding, t.solver_mode = 32, "i8", "jacobi"
    t.render_width, t.render_height, t.steps_per_dispatch = 64, 48, 1
    c.physics.simulator.initial_time_step_duration = bench.DT
    return c


def _port_config():
    c = bench.bench_config(64, 48)
    c.tpu.max_voxel_objects, c.tpu.max_bodies = 8, 24
    return c


def _finite(bodies, to_np):
    return all(np.isfinite(to_np(getattr(bodies, f))).all()
               for f in ("position", "momentum", "angular_momentum"))


def _port_world(spacing):
    """The port's tumbler at N_BOXES boxes, edited as ``models/bench.py``'s
    ``bench_scene`` (26-voxel boxes) and ``bench_step_scene`` (box i at
    height 6 + spacing·i) edit the bench's 62."""
    world = ttumbler(n_boxes=N_BOXES, seed=bench.SEED)
    for i, eid in enumerate(world.entities_with(TC.VoxelBox)):
        for f in ("extent_x", "extent_y", "extent_z"):
            world.set_field(eid, TC.VoxelBox, f, bench.BOX_EXTENT)
        pos = world.get_component(eid, TC.ReferenceFrame).position
        pos[1] = 6.0 + spacing * i
        world.set_field(eid, TC.ReferenceFrame, "position", pos)
    return world


@pytest.fixture(scope="module")
def reference():
    """The reference's build of the bench placement and one runtime (one
    step compile shared by both cases)."""
    world = jtumbler(n_boxes=N_BOXES, seed=bench.SEED)
    for eid in world.entities_with(C.VoxelBox):
        for f in ("extent_x", "extent_y", "extent_z"):
            world.set_field(eid, C.VoxelBox, f, bench.BOX_EXTENT)
    jc = _jax_config()
    build = jcompile(world, jc)
    return build, JRuntime(build, jc, enable_fracturing=False)


@pytest.mark.parametrize("spacing", [5.0, bench.STEP_SPACING], ids=["bench", "spaced"])
def test_bench_tumbler_placement_in_both_packages(reference, spacing):
    build, jrt = reference
    world = _port_world(spacing)
    tc = _port_config()
    trt = TRuntime(tcompile(world, tc, device="cpu"), tc, enable_fracturing=False)
    # the reference's build with box i raised by (spacing − 5)·i: the boxes
    # are centred in their grids, so their COM sits at the frame origin
    sim = build.sim
    lift = np.zeros((sim.phys.bodies.position.shape[0], 3), np.float32)
    bi = np.asarray(sim.voxels.body_index)[:N_BOXES]
    lift[bi, 1] = (spacing - 5.0) * np.arange(N_BOXES)
    pos = np.asarray(sim.phys.bodies.position) + lift
    jrt.sim = sim._replace(phys=sim.phys._replace(
        bodies=sim.phys.bodies._replace(position=jnp.asarray(pos))))
    np.testing.assert_allclose(trt.sim.phys.bodies.position.numpy(), pos, atol=1e-5)
    for _ in range(3):
        jrt.step(1)
        trt.step(1)
    j_ok = _finite(jrt.sim.phys.bodies, np.asarray)
    t_ok = _finite(trt.sim.phys.bodies, lambda t: t.numpy())
    assert j_ok == t_ok == (spacing != 5.0)
    if t_ok:
        np.testing.assert_allclose(trt.sim.phys.bodies.position.numpy(),
                                   np.asarray(jrt.sim.phys.bodies.position), atol=1e-4)
