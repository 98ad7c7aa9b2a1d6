"""The chunked engine path as a whole: impact_tpu's compiled chunked asteroid
carried over by the bridge and stepped in both packages on the CPU.

The scene is the chunked bench's (``bench.py:bench_chunked``): the asteroid
in i8 grids with chunked meshing (512 submesh slots, 16 chunks re-meshed a
step), jacobi at dt 0.005, no fracturing, and the bench's absorbing sphere
(radius 3 at (4, 4, 0)) carving it every step. Here at 32³ with 2 slots and
a radius of 12 voxels, stepped 6 steps; ``test_torch_chunked_engine_fill.py``
runs the filled 64³ bench scene. After every step:

* alive, split_pending, the chunk pool's slot map, slot owners, chunks,
  active slots and dirty chunks, ``deferred_absorptions()`` and
  ``dropped_mesh_elements()`` equal;
* i8 SDF codes equal except where a body pose that differs in the last
  float32 bits moves a carved code across a rounding boundary: at most 1e-4
  of the voxels, each by ±1;
* body state within 8× the reference's own spread plus 1e-6 of the
  magnitude, the bar of tests/test_torch_physics.py. The spread here is that
  of the voxel mass properties (the sync's float32 sums over the grid, taken
  in another order by the port): the reference stepped again with its
  ``inertial_properties`` summed over transposed grids;
* three host reads per step (split candidates, dirty objects, dirty chunks:
  ``runtime/engine.py``).

Then one 128×80 frame of the chunked state through the port's CPU render,
without shadow maps, scored against the port's dense render of the same
state (≥ 0.95), as impact_tpu's ``test_chunked_render_matches_dense``
compares its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import impact_tpu.runtime.engine as jengine
import impact_tpu.voxel.chunk_mesh as jchunk_mesh
from impact_tpu.ecs import components as C
from impact_tpu.models import asteroid as jasteroid
from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch import bridge
from impact_tpu_torch.models.bench import bench_chunked_config
from impact_tpu_torch.runtime import HeadlessRuntime as TRuntime
from impact_tpu_torch.runtime.engine import remesh_objects
from impact_tpu_torch.utils.image import rgb_hybrid_compare

BODY_FIELDS = ("position", "orientation", "momentum", "angular_momentum", "velocity",
               "angular_velocity")
SLOT_FIELDS = ("slot_of", "owner", "chunk", "active", "chunk_dirty")
FLIP_SHARE = 1e-4
READS_PER_STEP = 3
PARITY_BAR = 0.95


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads in these modules: the suite runs six test processes
    on the CPU at once, and the port's 64³ work on every core makes them all
    wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_config(g, n_objects):
    cfg = JConfig()
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts = n_objects, n_objects + 8, 256
    t.voxel_grid_size = g
    t.render_width, t.render_height = 320, 200
    t.solver_mode, t.sdf_encoding = "jacobi", "i8"
    t.chunked_remesh = True
    t.chunk_submesh_slots, t.chunk_remesh_budget = 512, 16
    cfg.physics.simulator.initial_time_step_duration = 0.005
    if hasattr(t, "steps_per_dispatch"):
        t.steps_per_dispatch = 1
    return cfg


def jax_asteroid(radius):
    world = jasteroid()
    for eid in world.entities_with(C.VoxelSphere):
        world.set_field(eid, C.VoxelSphere, "radius", radius)
    world.create_entity(C.ReferenceFrame(position=(4.0, 4.0, 0.0)),
                        C.VoxelAbsorbingSphere(offset=(0.0, 0.0, 0.0), radius=3.0, rate=2.0))
    return world


def jax_compile_chunked(world, cfg):
    """The reference's ``compile_scene`` with its setup's chunk remesh jitted,
    as its engine step runs it (eager, each pass costs ~10 s of op-by-op
    compiles here)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jchunk_mesh, "remesh_chunks",
               jax.jit(jchunk_mesh.remesh_chunks, static_argnums=(3, 4),
                       static_argnames=("merge_levels",)))
    try:
        return jcompile(world, cfg)
    finally:
        mp.undo()


def _transposed_inertial_properties(pool, type_density, _orig=jengine.inertial_properties):
    """The reference's mass properties summed over grids with x and z
    swapped (another float32 summation order), mapped back."""
    perm = jnp.array([2, 1, 0])
    sub = pool._replace(sdf=jnp.transpose(pool.sdf, (0, 3, 2, 1)),
                        vtype=jnp.transpose(pool.vtype, (0, 3, 2, 1)),
                        origin=pool.origin[:, perm])
    mass, com, inertia = _orig(sub, type_density)
    return mass, com[:, perm], inertia[:, perm][:, :, perm]


def run_both(g, n_objects, radius, n_steps, monkeypatch):
    """Step the reference, the reference with transposed mass sums, and the
    port from the reference's compiled state; returns per-step records."""
    jc = jax_config(g, n_objects)
    build = jax_compile_chunked(jax_asteroid(radius), jc)
    jrt = JRuntime(build, jc, enable_fracturing=False)
    tc = bench_chunked_config(64)
    tc.tpu.voxel_grid_size = g
    tc.tpu.max_voxel_objects, tc.tpu.max_bodies = n_objects, n_objects + 8
    trt = TRuntime(bridge.scene_build_from_reference(build, device="cpu"), tc,
                   enable_fracturing=False)
    n_active0 = int((np.asarray(build.sim.voxels.sdf) < 0).sum())
    steps = []
    for _ in range(n_steps):
        jrt.step(1)
        trt.step(1)
        steps.append(dict(ref=jrt.sim, port=trt.sim, ref_deferred=jrt.deferred_absorptions(),
                          port_deferred=trt.deferred_absorptions(),
                          ref_dropped=jrt.dropped_mesh_elements(),
                          port_dropped=trt.dropped_mesh_elements()))
    monkeypatch.setattr(jengine, "inertial_properties", _transposed_inertial_properties)
    alt = JRuntime(build, jc, enable_fracturing=False)
    for rec in steps:
        alt.step(1)
        rec["alt"] = alt.sim
    monkeypatch.undo()
    return dict(steps=steps, n_active0=n_active0, port_rt=trt, cfg=tc,
                host_syncs=trt.host_syncs)


def check_steps(run):
    for i, rec in enumerate(run["steps"]):
        ref, port, alt = rec["ref"], rec["port"], rec["alt"]
        jv, tv = ref.voxels, port.voxels
        for f in ("alive", "split_pending"):
            np.testing.assert_array_equal(getattr(tv, f).numpy(), np.asarray(getattr(jv, f)),
                                          err_msg=f"step {i + 1}: {f}")
        diff = tv.sdf.numpy().astype(np.int32) - np.asarray(jv.sdf).astype(np.int32)
        n_flips = int((diff != 0).sum())
        assert n_flips <= FLIP_SHARE * diff.size and np.abs(diff).max(initial=0) <= 1, \
            (i + 1, n_flips)
        for f in SLOT_FIELDS:
            np.testing.assert_array_equal(getattr(port.meshes, f).numpy(),
                                          np.asarray(getattr(ref.meshes, f)),
                                          err_msg=f"step {i + 1}: {f}")
        assert rec["port_deferred"] == rec["ref_deferred"], i + 1
        assert rec["port_dropped"] == rec["ref_dropped"], i + 1
        for f in BODY_FIELDS:
            want = np.asarray(getattr(ref.phys.bodies, f))
            spread = np.abs(np.asarray(getattr(alt.phys.bodies, f)) - want).max()
            tol = 8 * spread + 1e-6 * max(np.abs(want).max(), 1.0)
            err = np.abs(getattr(port.phys.bodies, f).numpy() - want).max()
            assert err <= tol, (i + 1, f, err, spread)
    assert run["host_syncs"] == READS_PER_STEP * len(run["steps"])


@pytest.fixture(scope="module")
def small_run():
    mp = pytest.MonkeyPatch()
    try:
        return run_both(32, 2, 12.0, 6, mp)
    finally:
        mp.undo()


def test_chunked_steps_match_reference(small_run):
    check_steps(small_run)
    # the absorber removed voxels
    assert int((small_run["steps"][-1]["port"].voxels.sdf < 0).sum()) < small_run["n_active0"]


def test_chunked_frame_matches_dense_render(small_run):
    rt = small_run["port_rt"]
    cfg = small_run["cfg"]
    cfg.tpu.render_width, cfg.tpu.render_height = 128, 80
    cfg.rendering.shadow_mapping.enabled = False  # as the reference's own comparison
    sim = rt.sim
    chunked = TRuntime(_build_of(rt, sim), cfg, enable_fracturing=False)
    img_c = chunked.render().numpy()
    pool = sim.voxels
    dense_meshes = remesh_objects(pool, cfg.tpu.mesh_merge_levels, rt.info["mesh_vert_cap"],
                                  rt.info["mesh_tri_cap"], rt.params.material_table)
    dense = TRuntime(_build_of(rt, sim._replace(meshes=dense_meshes)), cfg,
                     enable_fracturing=False)
    img_d = dense.render().numpy()
    n_tris = int(chunked.scene().tri_active.sum())
    score = rgb_hybrid_compare(img_c, img_d)
    assert n_tris > 0 and img_c.std() > 1.0
    assert score >= PARITY_BAR, score


def _build_of(rt, sim):
    from impact_tpu_torch.runtime.setup import SceneBuild

    return SceneBuild(sim=sim, params=rt.params, info=rt.info)
