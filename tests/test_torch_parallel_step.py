"""The engine step sharded over the voxel-object pool
(``impact_tpu_torch/parallel/step.py``) on CPU ranks over gloo: equal
(``torch.equal`` on every leaf, which takes −0.0 for 0.0) to the port's
single-process step on the tumbler (4×1 and 8×1 meshes), across the
Fracturing scene's fracture and across the 64³ asteroid's carve and split;
within the bars of ``tests/test_parallel.py:88-103`` of the reference's
single-device step; and the pod step of ``tests/test_parallel.py:245`` at
1024 slots on 4 ranks (local dims, the collectives' sizes, no grid moved).

The 8 ranks are spawned once for the module; the event scenes start from a
checkpoint the parent writes a few steps before the event, and the parent
steps its reference while the ranks step theirs."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from impact_tpu.ecs import components as JC
from impact_tpu.models import voxel_box_tumbler as jtumbler
from impact_tpu.runtime import compile_scene as jcompile
from impact_tpu.runtime.engine import make_engine_step as jmake_step
from impact_tpu.utils.config import EngineConfig as JConfig
from impact_tpu_torch.parallel import jobs
from impact_tpu_torch.parallel.world import World
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene

FRACTURE_STEP = 51  # the Fracturing scene's event at small_config, on the CPU
BEFORE_EVENT = 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(8, device="cpu", store_dir=tmp_path_factory.mktemp("world"))
    yield w
    w.close()


@contextlib.contextmanager
def one_thread():
    """The ranks run one thread each; the reference does too, so that
    reductions sum in the same order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def reference(name):
    w, cfg = jobs.scene(name)
    return HeadlessRuntime(compile_scene(w, cfg, device="cpu"), cfg)


def assert_equal_states(got: dict, rt):
    want = jobs.state_arrays(rt.sim)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert torch.equal(torch.from_numpy(got[k]), torch.from_numpy(v)), \
            f"{k}: {int((got[k] != v).sum())} elements differ"


@pytest.fixture(scope="module")
def tumbler_two_steps():
    """The single-process tumbler after 2 steps, shared by the 4×1 and 8×1
    cases."""
    with one_thread():
        rt = reference("tumbler")
        rt.step(2)
    return rt


def test_tumbler_4x1_equals_single_process(world, tumbler_two_steps):
    rt = tumbler_two_steps
    res = world.run(jobs.step_job, "tumbler", 4, 2)
    assert [r is None for r in res] == [False] * 4 + [True] * 4
    assert_equal_states(res[0]["state"], rt)
    assert {r["local_dims"]["voxels/sdf"][0] for r in res[:4]} == {2}
    assert {r["host_syncs"] for r in res[:4]} == {rt.host_syncs}


def _jax_tumbler_two_steps():
    world = jtumbler(n_boxes=2)
    for eid in world.entities_with(JC.VoxelBox):
        for f in ("extent_x", "extent_y", "extent_z"):
            world.set_field(eid, JC.VoxelBox, f, 6.0)
    cfg = JConfig()
    cfg.tpu.max_voxel_objects = 8
    cfg.tpu.max_bodies = 16
    cfg.tpu.max_contacts = 128
    cfg.tpu.voxel_grid_size = 16
    cfg.physics.simulator.initial_time_step_duration = 0.01
    build = jcompile(world, cfg)
    step = jax.jit(jmake_step(build.params, cfg, build.info["mesh_vert_cap"],
                              build.info["mesh_tri_cap"]))
    return step(step(build.sim, build.params), build.params)


def test_tumbler_8x1_equals_single_process_and_reference(world, tumbler_two_steps):
    rt = tumbler_two_steps
    world.submit(jobs.step_job, "tumbler", 8, 2)
    jsim = _jax_tumbler_two_steps()
    got = world.collect()[0]["state"]
    assert_equal_states(got, rt)
    # tests/test_parallel.py:88-103's bars against the reference
    np.testing.assert_allclose(got["phys/bodies/position"],
                               np.asarray(jsim.phys.bodies.position), atol=1e-5)
    np.testing.assert_allclose(got["phys/bodies/momentum"],
                               np.asarray(jsim.phys.bodies.momentum), atol=1e-4)
    np.testing.assert_array_equal(got["voxels/alive"], np.asarray(jsim.voxels.alive))
    np.testing.assert_allclose(got["voxels/sdf"].astype(np.float32),
                               np.asarray(jsim.voxels.sdf).astype(np.float32), atol=1e-6)


def test_fracture_across_ranks_equals_single_process(world, tmp_path):
    """Fracturing at small_config (4 slots, one per rank) from a checkpoint
    3 steps before its fracture, 6 steps: the fragments land in slots of
    other ranks, and voxel objects on different ranks touch."""
    with one_thread():
        rt = reference("fracturing")
        rt.step(FRACTURE_STEP - BEFORE_EVENT)
        assert int(rt.sim.voxels.alive.sum()) == 2
        ckpt = rt.save_checkpoint(tmp_path / "before_fracture.npz")
        world.submit(jobs.step_job, "fracturing", 4, 2 * BEFORE_EVENT, str(ckpt))
        rt.step(2 * BEFORE_EVENT)
    res = world.collect()[:4]
    assert int(rt.sim.voxels.alive.sum()) == 4
    assert_equal_states(res[0]["state"], rt)
    receivers = [r["coordinate"][0] for r in res if r["received"]]
    assert len(receivers) >= 2 and 0 not in receivers, receivers
    assert res[0]["cross_pairs"], "no active contact between objects of different ranks"
    # the fracture's target grid is broadcast from its owner
    assert any(_is_grid(tuple(s), 16) for r in res for rec in r["records"]
               for s, _ in rec["parts"])


def test_asteroid_carve_and_split_across_ranks_equals_single_process(world):
    """The filled 64³ asteroid (dense remesh, 4 slots): the absorber's carve
    splits it on the first step into slots 1 and 2, on ranks 1 and 2."""
    world.submit(jobs.step_job, "asteroid", 4, 1)
    with one_thread():
        rt = reference("asteroid")
        rt.step(1)
    res = world.collect()[:4]
    assert_equal_states(res[0]["state"], rt)
    assert [r["received"] for r in res] == [0, 1, 1, 0]
    assert rt.sim.voxels.alive.tolist() == [True, True, True, False]


def test_gated_carve_equals_single_process(world):
    """The 32³ asteroid in 16 slots, twice the absorption gate's cap: the
    gate ranks the whole pool and each rank carves its own objects."""
    world.submit(jobs.step_job, "carve", 4, 3)
    with one_thread():
        rt = reference("carve")
        sdf0 = rt.sim.voxels.sdf.clone()
        rt.step(3)
    res = world.collect()[:4]
    assert rt.config.tpu.absorption_gate_cap < rt.config.tpu.max_voxel_objects
    assert not torch.equal(rt.sim.voxels.sdf, sdf0), "the absorber carved nothing"
    assert_equal_states(res[0]["state"], rt)


def test_distance_rules_equal_single_process(world):
    """A box under distance rules: its shadows off, then its slot dead and
    its body empty, as in the single-process step."""
    world.submit(jobs.step_job, "rules", 4, 6)
    with one_thread():
        rt = reference("rules")
        assert bool(rt.sim.voxels.alive[0])
        rt.step(6)
    res = world.collect()[:4]
    assert not bool(rt.sim.voxels.alive[0]) and not bool(rt.sim.voxels.casts_shadows[0])
    assert_equal_states(res[0]["state"], rt)


def _is_grid(shape, g):
    return len(shape) >= 4 and shape[-1] >= g and shape[-2] >= g and shape[-3] >= g - 1


def test_pod_step_at_1024_slots(world):
    """tests/test_parallel.py:245 on 4 ranks: every object-axis leaf split
    (local leading dim O/4), no collective above 1.5 object-axis shards of
    the largest leaf, none of a grid's shape (a step with no event moves no
    grid), finite bodies and 6 objects alive."""
    res = world.run(jobs.step_job, "pod", 4, 1, gather=False, serial_build=True)[:4]
    o, g = jobs.POD_OBJECTS, 16
    for r in res:
        dims = r["local_dims"]
        for path in ("voxels/sdf", "voxels/vtype", "meshes/tri_pos", "probes/pos_local"):
            assert dims[path][0] == o // 4, (path, dims[path])
        shard_bytes = max(r["local_bytes"][p] for p, d in dims.items() if d and d[0] == o // 4)
        assert r["records"], "the step issued no collective"
        worst = max(rec["bytes"] for rec in r["records"])
        assert worst <= 1.5 * shard_bytes, (worst, shard_bytes)
        grids = [rec for rec in r["records"]
                 if any(_is_grid(tuple(s), g) for s, _ in rec["parts"])]
        assert not grids, grids
        assert r["finite"] and r["n_alive"] == 6


def test_space_axis_and_chunked_mode_raise(world):
    """The sharded step refuses what it does not shard: a pool that does
    not divide over the objects axis, slabs it cannot split along x (G not
    a multiple of the space axis, a slab not a multiple of the probe block
    or of 2**mesh_merge_levels; each names the slab constraint) and chunked
    mode (naming the ROADMAP.md item that ports it)."""
    errors = world.run(jobs.guards_job)[0]
    assert "do not divide" in errors["step"]
    assert "slab constraint" in errors["slab_divide"] and "does not divide" in errors["slab_divide"]
    assert "slab constraint" in errors["slab_probe"] and "probe block" in errors["slab_probe"]
    assert "slab constraint" in errors["slab_merge"] and "mesh_merge_levels" in errors["slab_merge"]
    assert "chunked" in errors["chunked"] and "ROADMAP.md" in errors["chunked"]
