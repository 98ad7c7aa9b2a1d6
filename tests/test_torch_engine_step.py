"""The slice as a whole: the port's engine step against impact_tpu on the CPU.

* Tumbler: a 3-box tumbler compiled by the reference and stepped there until
  boxes touch the ground, then carried over by the bridge and stepped N more
  times in both packages. The jacobi solve sums per-body impulses in another
  order than JAX, so body state is held to a tolerance taken from the
  reference itself: 8× the largest difference between impact_tpu's one-hot
  and segment-sum accumulation paths over the same N steps, plus 1e-6 of
  the quantity's magnitude.
* Fracture: the fracturing scene at reduced depth (12 fragment slots) is
  compiled by each package and stepped through its fracture event and the
  split checks after it, with the uniforms JAX draws from its key handed to
  the port. Event step, fragment count, alive and pending masks, and
  per-slot voxel counts and i8 SDFs must be equal.
"""

import jax
import numpy as np
import pytest
import torch

import impact_tpu.physics.solver as jsolver
from impact_tpu.ecs import components as C
from impact_tpu.models import fracturing as jfracturing
from impact_tpu.models import voxel_box_tumbler as jtumbler
from impact_tpu.runtime import HeadlessRuntime as JRuntime
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch import bridge
from impact_tpu_torch.models.bench import bench_fracture_scene
from impact_tpu_torch.models import voxel_box_tumbler as ttumbler
from impact_tpu_torch.runtime import HeadlessRuntime as TRuntime
from impact_tpu_torch.runtime import compile_scene as tcompile
from impact_tpu_torch.utils.config import EngineConfig as TConfig

BODY_FIELDS = ("position", "orientation", "momentum", "angular_momentum", "velocity",
               "angular_velocity")
SETTLE, N_STEPS = 300, 24
N_FRAG = 12


def _configure(cfg, n_objects, n_bodies):
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies = n_objects, n_bodies
    t.voxel_grid_size = 32
    t.sdf_encoding = "i8"
    t.solver_mode = "jacobi"
    t.render_width, t.render_height = 64, 48
    cfg.physics.simulator.initial_time_step_duration = 0.005
    if hasattr(t, "steps_per_dispatch"):
        t.steps_per_dispatch = 1
    return cfg


@pytest.fixture(scope="module")
def tumbler():
    jc = _configure(JConfig(), 4, 20)
    jc.tpu.max_contacts = 256
    build = jcompile(jtumbler(n_boxes=3, seed=3), jc)
    rt = JRuntime(build, jc, enable_fracturing=False)
    rt.step(SETTLE)
    start = rt.sim
    rt.step(N_STEPS)
    return dict(cfg=jc, build=build, start=start, end=rt.sim)


def _body_diff(a, b, f):
    return np.abs(np.asarray(getattr(a.phys.bodies, f)) - np.asarray(getattr(b.phys.bodies, f)))


def test_tumbler_compile_matches_reference(tumbler):
    tc = _configure(TConfig(), 4, 20)
    tc.tpu.max_contacts = 256
    got = tcompile(ttumbler(3, 3), tc, device="cpu").sim
    ref = tumbler["build"].sim
    # mass, COM and inertia are float32 sums over ~10⁴ voxels taken in
    # another order: relative 1e-4
    for f in ref.phys.bodies._fields:
        a, b = getattr(got.phys.bodies, f).numpy(), np.asarray(getattr(ref.phys.bodies, f))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=f)
    for f in ref.probes._fields:
        np.testing.assert_array_equal(getattr(got.probes, f).numpy(),
                                      np.asarray(getattr(ref.probes, f)), err_msg=f)


def test_bridged_tumbler_steps_within_reference_spread(tumbler, monkeypatch):
    ref_end = tumbler["end"]
    assert int(np.asarray(ref_end.phys.solver_cache.active).sum()) > 0
    # the reference's segment-sum path over the same steps
    monkeypatch.setattr(jsolver, "SEGMENT_ACCUMULATION_MIN_BODIES", 0)
    alt = JRuntime(tumbler["build"], tumbler["cfg"], enable_fracturing=False)
    alt.sim = tumbler["start"]
    alt.step(N_STEPS)
    monkeypatch.undo()

    tc = _configure(TConfig(), 4, 20)
    tc.tpu.max_contacts = 256
    build = bridge.scene_build_from_reference(tumbler["build"], device="cpu")
    build.sim = bridge.sim_state_from_reference(tumbler["start"], device="cpu")
    rt = TRuntime(build, tc, enable_fracturing=False)
    rt.step(N_STEPS)
    for f in BODY_FIELDS:
        ref = np.asarray(getattr(ref_end.phys.bodies, f))
        spread = _body_diff(ref_end, alt.sim, f).max()
        tol = 8 * spread + 1e-6 * max(np.abs(ref).max(), 1.0)
        err = np.abs(getattr(rt.sim.phys.bodies, f).numpy() - ref).max()
        assert err <= tol, (f, err, spread)
    assert rt.host_syncs == 2 * N_STEPS  # split candidates + dirty objects per step


def _jax_fracture_build():
    jc = _configure(JConfig(), N_FRAG + 4, N_FRAG + 8)
    jc.tpu.max_contacts = 1024
    jc.tpu.max_fracture_fragments, jc.tpu.max_fracture_events = N_FRAG, 1
    world = jfracturing()
    for eid in world.entities_with(C.FracturingProperties):
        world.set_field(eid, C.FracturingProperties, "fracture_radius", 2.5)
        world.set_field(eid, C.FracturingProperties, "impulse_threshold", 5.0)
    return jc, jcompile(world, jc)


def jax_event_uniforms(key, n_seeds):
    """What the reference draws at its first event: split(key) → sub, then
    three uniform vectors from split(sub, 3) (engine.py:540,
    interaction.py:744-758)."""
    _, sub = jax.random.split(key)
    kt, kp, kr = jax.random.split(sub, 3)
    draws = (jax.random.uniform(kt, (n_seeds,), minval=-0.5, maxval=0.5),
             jax.random.uniform(kp, (n_seeds,), minval=-0.5, maxval=0.5),
             jax.random.uniform(kr, (n_seeds,)))
    return tuple(torch.from_numpy(np.array(d)) for d in draws)


def test_fracture_scene_steps_through_event_and_splits():
    jc, jbuild = _jax_fracture_build()
    tc = _configure(TConfig(), N_FRAG + 4, N_FRAG + 8)
    tc.tpu.max_contacts = 1024
    tc.tpu.max_fracture_fragments, tc.tpu.max_fracture_events = N_FRAG, 1
    tbuild = tcompile(bench_fracture_scene(), tc, device="cpu")
    np.testing.assert_array_equal(tbuild.sim.voxels.sdf.numpy(), np.asarray(jbuild.sim.voxels.sdf))
    uniforms = jax_event_uniforms(jbuild.sim.rng, N_FRAG)
    jrt = JRuntime(jbuild, jc)
    trt = TRuntime(tbuild, tc, fracture_uniforms=lambda gen, n: uniforms)
    alive0 = int(np.asarray(jrt.sim.voxels.alive).sum())
    event = None
    for i in range(1, 201):
        jrt.step(1)
        trt.step(1)
        j_alive = int(np.asarray(jrt.sim.voxels.alive).sum())
        assert int(trt.sim.voxels.alive.sum()) == j_alive, i
        if j_alive > alive0 and event is None:
            event = i
        if event is not None and i >= event + 4:
            break
    assert event is not None and j_alive - alive0 >= 2
    jv, tv = jrt.sim.voxels, trt.sim.voxels
    np.testing.assert_array_equal(tv.alive.numpy(), np.asarray(jv.alive))
    np.testing.assert_array_equal(tv.split_pending.numpy(), np.asarray(jv.split_pending))
    np.testing.assert_array_equal((tv.sdf < 0).sum(dim=(1, 2, 3)).numpy(),
                                  (np.asarray(jv.sdf) < 0).sum(axis=(1, 2, 3)))
    np.testing.assert_array_equal(tv.sdf.numpy(), np.asarray(jv.sdf))
    np.testing.assert_allclose(trt.sim.phys.bodies.position.numpy(),
                               np.asarray(jrt.sim.phys.bodies.position), atol=1e-3)
    # three device reads per step with fracturing on
    assert trt.host_syncs == 3 * i


@pytest.mark.parametrize("path", ["chunked grids", "absorbers", "distance rules",
                                  "mesh models"])
def test_paths_outside_the_slice_raise(path, tumbler):
    """Chunked grids (64³ and up), absorbers, distance rules and mesh-model
    entities are ported: a 64³ scene resolves to the chunked path and
    steps, the reference's absorbers bridge and carve, its distance rules
    and mesh-model entities (BallPit's sphere meshes) bridge field for
    field (the bridge refused distance rules until they were ported)."""
    from impact_tpu_torch.models.bench import bench_chunked_config, bench_chunked_scene
    from impact_tpu_torch.voxel.chunk_mesh import ChunkMeshPool

    if path == "chunked grids":
        cfg = bench_chunked_config(64)
        cfg.tpu.chunked_remesh = None
        rt = TRuntime(tcompile(bench_chunked_scene(64), cfg, device="cpu"), cfg,
                      enable_fracturing=False)
        rt.step(1)
        assert cfg.tpu.chunked_remesh is True and isinstance(rt.sim.meshes, ChunkMeshPool)
        assert int(rt.sim.meshes.active.sum()) > 0
        assert bool(torch.isfinite(rt.sim.phys.bodies.position).all())
        return
    if path == "absorbers":
        build = tumbler["build"]
        a = build.params.absorbers
        # a sphere of radius 2 on the first box's body, at its centre
        params = build.params._replace(absorbers=a._replace(
            sph_body=a.sph_body.at[0].set(int(build.sim.voxels.body_index[0])),
            sph_radius=a.sph_radius.at[0].set(2.0), sph_mask=a.sph_mask.at[0].set(True)))
        tp = bridge.engine_params_from_reference(params, device="cpu")
        for f in tp.absorbers._fields:
            np.testing.assert_array_equal(getattr(tp.absorbers, f).numpy(),
                                          np.asarray(getattr(params.absorbers, f)), err_msg=f)
        tc = _configure(TConfig(), 4, 20)
        tc.tpu.max_contacts = 256
        tb = bridge.scene_build_from_reference(build, device="cpu")
        tb.params = tp
        rt = TRuntime(tb, tc, enable_fracturing=False)
        before = rt.sim.voxels.sdf.clone()
        rt.step(1)
        # codes change where the sphere overlaps a grid: box 0's and the
        # empty corner of box 1's grid, not box 2's, 10 m above
        n_changed = (rt.sim.voxels.sdf != before).flatten(1).sum(dim=1).tolist()
        assert n_changed[0] > 1000 and n_changed[2] == 0
        return
    if path == "mesh models":
        from test_torch_snapshot_scenes import reference_build

        jbuild = reference_build("BallPit")
        mi = jbuild.params.mesh_instances
        tp = bridge.engine_params_from_reference(jbuild.params, device="cpu")
        assert mi.alive.shape[0] == 12 and bool(np.asarray(mi.alive).all())
        for f in tp.mesh_instances._fields:
            np.testing.assert_array_equal(getattr(tp.mesh_instances, f).numpy(),
                                          np.asarray(getattr(mi, f)), err_msg=f)
        return
    build = tumbler["build"]
    r = build.params.dist_rules
    params = build.params._replace(dist_rules=r._replace(
        body=r.body.at[0].set(int(build.sim.voxels.body_index[1])),
        obj_slot=r.obj_slot.at[0].set(1), removal_d2=r.removal_d2.at[0].set(400.0),
        mask=r.mask.at[0].set(True)))
    tp = bridge.engine_params_from_reference(params, device="cpu")
    for f in tp.dist_rules._fields:
        np.testing.assert_array_equal(getattr(tp.dist_rules, f).numpy(),
                                      np.asarray(getattr(params.dist_rules, f)), err_msg=f)
    np.testing.assert_array_equal(tp.casts_shadows_base.numpy(),
                                  np.asarray(params.casts_shadows_base))
