"""The engine step with the voxel grids also split along x (the ``space``
axis, ``impact_tpu_torch/parallel/step.py``) on CPU ranks over gloo.

* Slab labels (``step.slab_labels``: the labels of each slab, the face
  label pairs resolved over the row) equal the whole grid's labels exactly,
  the port's and the reference's (``impact_tpu/voxel/interaction.py``).
* Slab meshes and probes (``step.slab_meshes_and_probes``) equal the whole
  grids' ``remesh_objects`` and ``extract_probes`` exactly (the vertex
  materials ``vert_type``, ``vert_type2`` and ``vert_blend`` included), at
  merge levels 0 and 2 and with caps that cut.
* The tumbler on 2×2 and 4×2 meshes equals the port's single-process step
  on every leaf and stays within ``tests/test_parallel.py:88-103``'s bars
  of the reference's single-device step.
* Across the Fracturing scene's fracture (2×2) and the filled 64³
  asteroid's carve and split (1×4), the sharded state equals, on every
  leaf, a single-process run whose inertia sums each object slab by slab
  in slab order, as the row sums it; against the plain single-process
  step the grids, flags, meshes and probe choices are equal and the bodies
  differ by the rounding of those sums (the first quantity that moves is
  named in the assertion). So do voxel pairs sampled across slab faces
  (i8 corner words on 2×2, f32 on 1×4 slabs of 4 planes), the gated carve
  and the distance rules.
* A 64-slot pod step on 2×2 without an event: local dims, halo transfers,
  no grid- or slab-shaped collective, none above 1.5 object-axis shards.
* The dry run steps on (n/2, 2).

The 8 ranks are spawned once for the module."""

import contextlib

import jax
import numpy as np
import pytest
import torch

from impact_tpu.voxel.interaction import connected_component_labels as jlabels
from impact_tpu_torch.ops.ccl_pallas import connected_component_labels_plain
from impact_tpu_torch.parallel import jobs
from impact_tpu_torch.parallel.world import World
from impact_tpu_torch.runtime import HeadlessRuntime, compile_scene, engine
from impact_tpu_torch.voxel.collision import extract_probes
from impact_tpu_torch.voxel.object import VoxelObjectPool

FRACTURE_STEP = 51  # the Fracturing scene's event at small_config, on the CPU
BEFORE_EVENT = 3
# tests/test_parallel.py:88-103
POS_ATOL, MOMENTUM_ATOL = 1e-5, 1e-4
# the leaves that follow the inertia sums: the bodies, what the solver and
# the contacts made from them, the grid origins (origin − COM) and the
# probe positions (voxel centre + origin)
INERTIA_FOLLOWERS = ("phys/", "voxels/origin", "probes/pos_local", "prev_")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(8, device="cpu", store_dir=tmp_path_factory.mktemp("world"))
    yield w
    w.close()


@contextlib.contextmanager
def one_thread():
    """The ranks run one thread each, so that reductions sum in the same
    order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def runtime(name):
    w, cfg = jobs.scene(name)
    return HeadlessRuntime(compile_scene(w, cfg, device="cpu"), cfg)


def differing(got: dict, want: dict):
    """{leaf: max abs difference} of the leaves that are not equal."""
    assert set(got) == set(want)
    out = {}
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if not torch.equal(torch.from_numpy(got[k]), torch.from_numpy(v)):
            out[k] = float(np.abs(got[k].astype(np.float64) - v.astype(np.float64)).max())
    return out


# --- slab labels ---------------------------------------------------------------------


def _label_grids(g: int) -> np.ndarray:
    """[5,G,G,G]: random blobs, a serpentine that winds across the x faces
    many times, an empty grid, a full one, and a grid whose middle slabs are
    empty and whose edge slabs are full."""
    rng = np.random.default_rng(3)
    blobs = rng.uniform(size=(g, g, g)) < 0.45
    snake = np.zeros((g, g, g), bool)
    for j in range(0, g, 2):  # rows along x joined at alternate ends
        snake[:, j, 0] = True
        if j + 1 < g:
            snake[-1 if j % 4 == 0 else 0, j + 1, 0] = True
    snake[:, :, g // 2] = rng.uniform(size=(g, g)) < 0.6
    edges = np.zeros((g, g, g), bool)
    edges[: g // 4], edges[-g // 4:] = True, True
    return np.stack([blobs, snake, np.zeros((g, g, g), bool), np.ones((g, g, g), bool), edges])


@pytest.mark.parametrize("n_space", [2, 4])
def test_slab_labels_equal_whole_grid_labels(world, n_space):
    occ = _label_grids(16)
    res = world.run(jobs.slab_labels_job, occ, n_space)
    got = res[0]["labels"]
    want = connected_component_labels_plain(torch.as_tensor(occ)).numpy()
    np.testing.assert_array_equal(got, want)
    ref = np.stack([np.asarray(jlabels(jax.numpy.asarray(o))) for o in occ])
    np.testing.assert_array_equal(got, ref)
    # the serpentine's slabs hold more components than the grid: they join
    # across the faces
    gx = 16 // n_space
    per_slab = sum(len(np.unique(connected_component_labels_plain(
        torch.as_tensor(occ[1:2, s * gx:(s + 1) * gx])).numpy())) - 1 for s in range(n_space))
    assert len(np.unique(got[1][occ[1]])) < per_slab
    assert all(np.array_equal(r["slab"], occ[:, i * gx:(i + 1) * gx])
               for i, r in enumerate(res[:n_space]))
    assert all(len(r["halos"]) == (1 if i else 0) for i, r in enumerate(res[:n_space]))


# --- slab meshes and probes ----------------------------------------------------------


def _mesh_pool(encoding: str):
    """Three 16³ objects: a ball with speckles, a box (planar faces, so
    quads merge) and an empty slot."""
    g, rng = 16, np.random.default_rng(5)
    x = np.arange(g) + 0.5
    i, j, k = np.meshgrid(x, x, x, indexing="ij")
    ball = np.sqrt((i - 7.3) ** 2 + (j - 8.1) ** 2 + (k - 8.6) ** 2) - 5.2
    ball = np.where(rng.uniform(size=ball.shape) < 0.03, -ball, ball)
    box = np.maximum(np.abs(i - 8.0) - 5.0, np.maximum(np.abs(j - 8.0) - 3.0, np.abs(k - 8.0) - 6.0))
    ext = 0.25
    sdf = np.clip(np.stack([ball, box, np.full_like(ball, 2.0)]) * ext, -2 * ext, 2 * ext)
    sdf = sdf.astype(np.float32)
    if encoding == "i8":
        sdf = np.clip(np.round(sdf / (ext * 0.02)), -128, 127).astype(np.int8)
    return dict(alive=np.array([True, True, False]), body_index=np.arange(3),
                voxel_extent=np.full(3, ext, np.float32),
                origin=np.full((3, 3), -2.0, np.float32), sdf=sdf,
                vtype=rng.integers(0, 3, (3, g, g, g)).astype(np.int32),
                mesh_dirty=np.ones(3, bool), split_pending=np.zeros(3, bool),
                casts_shadows=np.ones(3, bool))


@pytest.mark.parametrize("merge_levels,caps,encoding,n_space", [
    (0, (4000, 8000), "f32", 2), (2, (4000, 8000), "i8", 4), (2, (300, 500), "f32", 2)])
def test_slab_meshes_and_probes_equal_whole_grids(world, merge_levels, caps, encoding, n_space):
    pool = _mesh_pool(encoding)
    resp = np.tile(np.array([[0.2, 0.5, 0.4]], np.float32), (3, 1))
    table = np.random.default_rng(1).uniform(size=(3, 10)).astype(np.float32)
    res = world.run(jobs.slab_mesh_job, pool, resp, n_space, merge_levels, *caps, table)
    whole = VoxelObjectPool(**{k: torch.as_tensor(v) for k, v in pool.items()})
    want_mesh = engine.remesh_objects(whole, merge_levels, *caps, torch.as_tensor(table))
    want_probes = extract_probes(whole, torch.as_tensor(resp))
    want = {f"meshes/{k}": v.numpy() for k, v in want_mesh._asdict().items()}
    want.update({f"probes/{k}": v.numpy() for k, v in want_probes._asdict().items()})
    # the vertex materials merge across the slabs as the positions do
    assert {"meshes/vert_type", "meshes/vert_type2", "meshes/vert_blend"} <= set(want)
    assert (want["meshes/vert_blend"][want["meshes/vert_active"]] > 0).any()
    for r in res[:n_space]:
        assert differing(r, want) == {}
    if caps[0] < 1000:  # the caps cut: vertices and triangles dropped
        assert want_mesh.n_dropped_verts.sum() > 0 and want_mesh.n_dropped_tris.sum() > 0


# --- the engine step -----------------------------------------------------------------


def _jax_tumbler_two_steps():
    from impact_tpu.ecs import components as JC
    from impact_tpu.models import voxel_box_tumbler as jtumbler
    from impact_tpu.runtime import compile_scene as jcompile
    from impact_tpu.runtime.engine import make_engine_step as jmake_step
    from impact_tpu.utils.config import EngineConfig as JConfig

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


def test_tumbler_on_2x2_and_4x2_equals_single_process_and_reference(world):
    world.submit(jobs.step_job, "tumbler", 2, 2, n_space_axis=2)
    with one_thread():
        rt = runtime("tumbler")
        rt.step(2)
    want = jobs.state_arrays(rt.sim)
    res22 = world.collect()
    world.submit(jobs.step_job, "tumbler", 4, 2, n_space_axis=2)
    jsim = _jax_tumbler_two_steps()
    res42 = world.collect()
    for res, shape in ((res22, (2, 2)), (res42, (4, 2))):
        n = shape[0] * shape[1]
        assert [r is None for r in res] == [False] * n + [True] * (8 - n)
        got = res[0]["state"]
        assert differing(got, want) == {}, shape
        assert {r["local_dims"]["voxels/sdf"] for r in res[:n]} == {(8 // shape[0], 8, 16, 16)}
        assert {r["host_syncs"] for r in res[:n]} == {rt.host_syncs}
        # the contacts' right halo plane, once a step, on every rank but the last of a row
        assert [sum(x["op"] == "halo" for x in r["records"]) for r in res[:n]] == \
            [2 * (c[1] == 0) for c in (r["coordinate"] for r in res[:n])]
        np.testing.assert_allclose(got["phys/bodies/position"],
                                   np.asarray(jsim.phys.bodies.position), atol=POS_ATOL)
        np.testing.assert_allclose(got["phys/bodies/momentum"],
                                   np.asarray(jsim.phys.bodies.momentum), atol=MOMENTUM_ATOL)
        np.testing.assert_array_equal(got["voxels/alive"], np.asarray(jsim.voxels.alive))
        np.testing.assert_allclose(got["voxels/sdf"].astype(np.float32),
                                   np.asarray(jsim.voxels.sdf).astype(np.float32), atol=1e-6)


def _event_run(world, tmp_path, name, shape, before, n):
    """(the ranks' results after ``n`` sharded steps from a checkpoint
    ``before`` steps in, the slab-ordered single-process state, the plain
    single-process runtime)."""
    with one_thread():
        rt = runtime(name)
        rt.step(before)
        ckpt = rt.save_checkpoint(tmp_path / f"{name}.npz")
        world.submit(jobs.step_job, name, shape[0], n, str(ckpt), n_space_axis=shape[1],
                     record_labels=True)
        plain = runtime(name)
        plain.load_checkpoint(ckpt)
        with jobs.slab_ordered_inertia(shape[1]):
            rt.step(n)
        plain.step(n)
    return world.collect(), jobs.state_arrays(rt.sim), plain


def _against_plain(got, plain):
    """The leaves that differ from the plain single-process step: only those
    that follow the inertia sums, bodies within the bars or the first
    that leaves them named."""
    diff = differing(got, jobs.state_arrays(plain.sim))
    assert all(k.startswith(INERTIA_FOLLOWERS) for k in diff), diff
    return diff


def test_fracture_on_2x2_equals_single_process(world, tmp_path):
    """Fracturing at small_config (4 slots, 2×2) from 3 steps before its
    fracture, 4 steps: the target's slabs are gathered over its row, the
    fragments land on the other row; every leaf equals the slab-ordered
    run's. Against the plain run the fragments' inertia differs by the
    rounding of the second moments' sums; one step past the event it has turned the
    orientations, and positions and momenta are within the bars."""
    res, want, plain = _event_run(world, tmp_path, "fracturing", (2, 2),
                                  FRACTURE_STEP - BEFORE_EVENT, BEFORE_EVENT + 1)
    got = res[0]["state"]
    assert differing(got, want) == {}
    assert int(got["voxels/alive"].sum()) == 4
    assert [r["received"] for r in res[:4]] == [0, 0, 2, 2]
    assert all(r["event_bytes"] > 0 for r in res[:4])
    diff = _against_plain(got, plain)
    # the first that moves: the fragments' inertia, by the rounding of its
    # float32 sums (a few ulps); it turns the orientations, positions and
    # momenta stay in the bars
    assert 0 < diff["phys/bodies/inertia_body"] <= 4 * np.spacing(
        np.abs(got["phys/bodies/inertia_body"]).max())
    assert diff.get("phys/bodies/position", 0.0) <= POS_ATOL, diff
    assert diff.get("phys/bodies/momentum", 0.0) <= MOMENTUM_ATOL, diff


def test_asteroid_carve_and_split_on_1x4_equals_single_process(world, tmp_path):
    """The filled 64³ asteroid on 1×4 (slabs of 16 planes): the carve
    splits it on the first step; its labels are each slab's kernel labels
    merged over the row. Every leaf equals the slab-ordered run's; against
    the plain run the grids, flags, meshes and probe choices are equal and
    the COM of the 1.8e7 kg body moves by the rounding of its float32 sums
    (positions past the 1e-5 bar: the plain run's own COM sum is off the
    float64 one by more)."""
    res, want, plain = _event_run(world, tmp_path, "asteroid", (1, 4), 0, 1)
    got = res[0]["state"]
    assert differing(got, want) == {}
    assert plain.sim.voxels.alive.tolist() == [True, True, True, False]
    assert [r["received"] for r in res[:4]] == [2, 2, 2, 2]
    assert all(x.shape == (1, 16, 64, 64) for r in res[:4] for x in r["labelled"])
    assert all(r["labelled"] for r in res[:4])
    diff = _against_plain(got, plain)
    assert "phys/bodies/mass" in diff and diff["phys/bodies/mass"] <= np.spacing(
        np.float32(np.abs(got["phys/bodies/mass"]).max()))


@pytest.mark.parametrize("name,shape,n", [("fracturing_i8", (2, 2), 5),
                                          ("fracturing", (1, 4), 8)])
def test_voxel_pairs_across_slabs_equal_single_process(world, tmp_path, name, shape, n):
    """Fracturing's projectile against its target (from step 26, before
    any fracture) with i8 codes on 2×2 (packed corner words) and f32 on
    1×4 (slabs of 4 planes): the voxel pair samples are read on the slab
    that holds their cell and summed over the row; every leaf equals the
    slab-ordered single-process run's, and the last step holds contacts
    between the two voxel objects."""
    from impact_tpu_torch.voxel.collision import VOXEL_KEY_BASE

    res, want, plain = _event_run(world, tmp_path, name, shape, 26, n)
    assert differing(res[0]["state"], want) == {}
    c = plain.sim.phys.solver_cache
    voxel_bodies = set(plain.sim.voxels.body_index.tolist())
    pairs = [(a, b) for a, b, k, on in zip(c.body_a.tolist(), c.body_b.tolist(), c.key.tolist(),
                                            c.active.tolist())
             if on and k >= VOXEL_KEY_BASE and a in voxel_bodies and b in voxel_bodies]
    assert pairs, "no voxel pair contact"


@pytest.mark.parametrize("name,n", [("carve", 2), ("rules", 6)])
def test_gated_carve_and_distance_rules_on_2x2(world, tmp_path, name, n):
    """The 32³ asteroid in twice the absorption gate's cap of slots (the
    gate ranks the whole pool, each slab carves its part) and a box under
    distance rules (its slot dies), on 2×2: every leaf equals the
    slab-ordered single-process run's."""
    res, want, plain = _event_run(world, tmp_path, name, (2, 2), 0, n)
    assert differing(res[0]["state"], want) == {}
    if name == "carve":
        assert not np.array_equal(want["voxels/sdf"], jobs.state_arrays(
            runtime("carve").sim)["voxels/sdf"]), "the absorber carved nothing"
    else:
        assert not want["voxels/alive"][0]


def _is_grid(shape, g, gx):
    return len(shape) >= 4 and ((shape[-1] >= g and shape[-2] >= g and shape[-3] >= g - 1)
                                or (shape[-1] >= g and shape[-2] >= g and shape[-3] >= gx))


def test_pod_step_on_2x2_moves_no_grid(world):
    """The pod's config at 64 slots on 2×2, one step without an event:
    local sdf dims [16, 8, 16, 16], halo transfers recorded, no collective
    of a grid's or a slab's shape, none above 1.5 object-axis shards of the
    largest leaf, finite bodies and 6 objects alive."""
    res = world.run(jobs.step_job, "pod_small", 2, 1, gather=False, n_space_axis=2)[:4]
    o, g = jobs.POD_SMALL_OBJECTS, 16
    for r in res:
        dims = r["local_dims"]
        assert dims["voxels/sdf"] == (o // 2, g // 2, g, g)
        assert dims["probes/pos_local"][0] == o // 2 and dims["meshes/tri_pos"][0] == o // 2
        shard_bytes = max(r["local_bytes"][p] for p, d in dims.items()
                          if d and d[0] == o // 2)
        worst = max(rec["bytes"] for rec in r["records"])
        assert worst <= 1.5 * shard_bytes, (worst, shard_bytes)
        assert not [rec for rec in r["records"]
                    if any(_is_grid(tuple(s), g, g // 2) for s, _ in rec["parts"])]
        assert r["finite"] and r["n_alive"] == 6 and r["event_bytes"] == 0
    assert [any(x["op"] == "halo" for x in r["records"]) for r in res] == [True, False] * 2


def test_dryrun_on_2x2(world):
    """The dry run's job on 4 of the ranks: the full engine step on the
    (n/2, 2) mesh, with halo transfers, then the min filter on it."""
    reports = world.run(jobs.dryrun_job, 4)
    assert reports[4:] == [None] * 4
    r = reports[0]
    assert r["finite"] and r["halo_equal"] and r["step_halos"] > 0
    assert r["mesh"] == (2, 2) and r["halo_mesh"] == (2, 2)
    assert jobs.dryrun_mesh(4) == (2, 2) and jobs.dryrun_mesh(8) == (4, 2)
    assert jobs.dryrun_mesh(2) == (2, 1) and jobs.dryrun_mesh(3) == (3, 1)


def test_a_mesh_over_every_rank_meets_after_the_dry_run(world):
    """The dry run's job builds each of its meshes on every rank, those
    outside it too, so a mesh over all 8 ranks built after it meets: a
    process group that only some ranks create puts their group counts out
    of step, and the next mesh's rendezvous never completes."""
    assert world.run(jobs.dryrun_job, 4)[4:] == [None] * 4
    assert world.run(jobs.solve_guard_job, 1024, timeout=60) == [None] * 8
