"""The scenes and the rank jobs of the multi-device checks: the dry run, the
tests on CPU ranks and ``chip_smoke.py``'s parallel phase run these in the
ranks of a :class:`~.world.World` (module-level functions of the port, so a
spawned rank imports nothing else).

A job builds its scene on its rank (``compile_scene`` is deterministic, so
every rank builds the same state), optionally loads a checkpoint the parent
wrote, shards the state, steps it with the sharded step and returns what
the parent checks as numpy arrays and plain values.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ecs import components as C
from ..models import fracturing, voxel_box_tumbler
from ..models.bench import bench_chunked_config, bench_chunked_fill_scene
from ..ops import ccl_pallas as k2
from ..physics import scan_solver
from ..physics.collision import ContactBuffer
from ..physics.solver import empty_solver_cache, prepare_contacts
from ..physics.state import KIND_DYNAMIC, empty_body_state
from ..render.pipeline import fp32_render
from ..runtime import engine
from ..runtime.checkpoint import load_checkpoint
from ..runtime.setup import compile_scene
from ..utils.config import ConstraintSolverConfig, EngineConfig
from ..voxel import inertia, interaction
from ..voxel.chunk_mesh import empty_chunk_mesh_pool
from ..voxel.object import VoxelObjectPool
from . import solver as psolver
from .halo import make_sharded_min_filter_x
from .mesh import (
    OBJECTS_SPACE,
    gather_bodies,
    gather_sim_state,
    gather_tensor,
    grid_slab,
    leaves_with_path,
    make_device_mesh,
    shard_bodies,
    shard_sim_state,
    shard_tensor,
)
from .step import make_sharded_engine_step, ordered_sum, slab_labels, slab_meshes_and_probes

POD_OBJECTS = 1024  # tests/test_parallel.py:245's pool
POD_SMALL_OBJECTS = 64  # the pod's config at a pool the CPU ranks step in seconds
SOLVE_MESH = (4, 2)  # the body-sharded solve's mesh (tests/test_parallel.py:205-242)


def small_config() -> EngineConfig:
    """The dry run's config (``__graft_entry__.py:35-47``)."""
    cfg = EngineConfig()
    cfg.tpu.max_voxel_objects = 4
    cfg.tpu.max_bodies = 12
    cfg.tpu.max_contacts = 128
    cfg.tpu.voxel_grid_size = 16
    cfg.tpu.render_width = 128
    cfg.tpu.render_height = 96
    cfg.tpu.solver_mode = "jacobi"
    cfg.physics.simulator.initial_time_step_duration = 0.01
    return cfg


def _boxes(n_boxes: int, extent: float = 6.0):
    world = voxel_box_tumbler(n_boxes=n_boxes)
    for eid in world.entities_with(C.VoxelBox):
        for f in ("extent_x", "extent_y", "extent_z"):
            world.set_field(eid, C.VoxelBox, f, extent)
    return world


def _rule_world():
    """A voxel box 9.9 m from a kinematic anchor, drifting away at 2 m/s:
    its shadows are off beyond 6 m, it is removed beyond 10 m (a few steps
    in; the distance-rule scene of tests/test_runtime_features.py:202-245,
    started near its removal)."""
    from ..ecs import World

    w = World()
    anchor = w.create_entity(C.ReferenceFrame(position=(0.0, 0.0, 0.0)),
                             C.KinematicRigidBodyMarker())
    w.create_entity(
        C.ReferenceFrame(position=(9.9, 0.0, 0.0)), C.Motion(linear_velocity=(2.0, 0.0, 0.0)),
        C.VoxelBox(voxel_extent=0.25, extent_x=6, extent_y=6, extent_z=6),
        C.SameVoxelType(voxel_type=0), C.DynamicVoxels(),
        C.DistanceTriggeredRules(anchor_id=anchor, no_shadowing_dist_squared=36.0,
                                 removal_dist_squared=100.0))
    return w


def scene(name: str, n_objects_axis: int = 1):
    """(world, config) of a named multi-device scene:

    * ``tumbler``: ``tests/test_parallel.py:54-63`` (2 boxes of 6 voxels,
      8 slots of 16³, 128 contact slots);
    * ``quick_start``: README's quick start (4 boxes, 8 slots, the scan
      solver at the default sizes);
    * ``dryrun``: 2 boxes at ``small_config``, 2 slots per objects-axis rank
      and at least 4 (``__graft_entry__.py:96-99``);
    * ``fracturing``: the Fracturing scene at ``small_config``;
    * ``asteroid``: the filled 64³ asteroid and its absorber at
      ``bench_chunked_config(64)``, dense (``chunked_remesh`` off);
    * ``carve``: the same at 32³ in twice the absorption gate's cap of
      slots, so the object-gated carve runs;
    * ``rules``: a box under distance rules, removed a few steps in;
    * ``pod``: 6 boxes in 1024 slots of 16³, i8, jacobi, 4096 contact slots
      (``tests/test_parallel.py:245``);
    * ``pod_small``: the same in 64 slots;
    * any of them with ``_i8`` appended: with i8 SDF codes."""
    if name.endswith("_i8"):
        world, cfg = scene(name[:-3], n_objects_axis)
        cfg.tpu.sdf_encoding = "i8"
        return world, cfg
    if name == "tumbler":
        cfg = EngineConfig()
        cfg.tpu.max_voxel_objects = 8
        cfg.tpu.max_bodies = 16
        cfg.tpu.max_contacts = 128
        cfg.tpu.voxel_grid_size = 16
        cfg.physics.simulator.initial_time_step_duration = 0.01
        return _boxes(2), cfg
    if name == "quick_start":
        cfg = EngineConfig()
        cfg.tpu.max_voxel_objects = 8
        cfg.tpu.max_bodies = 24
        return voxel_box_tumbler(n_boxes=4), cfg
    if name == "dryrun":
        cfg = small_config()
        cfg.tpu.max_voxel_objects = max(4, 2 * n_objects_axis)
        cfg.tpu.max_bodies = cfg.tpu.max_voxel_objects + 8
        return voxel_box_tumbler(n_boxes=2), cfg
    if name == "fracturing":
        return fracturing(), small_config()
    if name == "asteroid":
        cfg = bench_chunked_config(64)
        cfg.tpu.chunked_remesh = False
        return bench_chunked_fill_scene(64), cfg
    if name == "carve":
        cfg = bench_chunked_config(32)
        cfg.tpu.chunked_remesh = False
        cfg.tpu.max_voxel_objects = 2 * cfg.tpu.absorption_gate_cap
        cfg.tpu.max_bodies = cfg.tpu.max_voxel_objects + 8
        return bench_chunked_fill_scene(32), cfg
    if name == "rules":
        cfg = EngineConfig()
        t = cfg.tpu
        t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 4, 16, 8, 16
        t.solver_mode = "jacobi"
        cfg.physics.simulator.initial_time_step_duration = 0.01
        cfg.physics.rigid_body_force.drag_load_map_config.directory = None
        return _rule_world(), cfg
    if name in ("pod", "pod_small"):
        n = POD_OBJECTS if name == "pod" else POD_SMALL_OBJECTS
        cfg = EngineConfig()
        cfg.tpu.max_voxel_objects = n
        cfg.tpu.max_bodies = n + 16
        cfg.tpu.max_contacts = 4096
        cfg.tpu.voxel_grid_size = 16
        cfg.tpu.sdf_encoding = "i8"
        cfg.tpu.solver_mode = "jacobi"
        cfg.physics.simulator.initial_time_step_duration = 0.01
        return _boxes(6), cfg
    raise KeyError(name)


@contextlib.contextmanager
def slab_ordered_inertia(n_slabs: int):
    """The single-process engine's inertia summed per object slab by slab,
    in slab order (``step.ordered_sum``), as a row of ``n_slabs`` ranks sums
    it: the plain version of the sharded step's inertia, for holding a
    space-sharded run against a single-process one."""
    plain = engine.inertial_properties

    def props(pool, type_density, x0=0, reduce=None):
        gx = pool.grid_size // n_slabs
        firsts = [inertia.first_moment_sums(
            pool._replace(sdf=pool.sdf[:, s * gx:(s + 1) * gx].contiguous(),
                          vtype=pool.vtype[:, s * gx:(s + 1) * gx].contiguous()),
            type_density, s * gx) for s in range(n_slabs)]
        first = ordered_sum(torch.stack([f[2] for f in firsts]))
        com = inertia.center_of_mass(first)
        second = ordered_sum(torch.stack([inertia.second_moment_sums(m, pos, com)
                                          for m, pos, _ in firsts]))
        return inertia.inertia_from_sums(first, second, pool.voxel_extent)

    engine.inertial_properties = props
    try:
        yield
    finally:
        engine.inertial_properties = plain


def state_arrays(sim) -> dict:
    """The state's tensors as numpy arrays by field path, and the fracture
    generator's state under ``rng_state``."""
    out = {}
    for path, leaf in leaves_with_path(sim):
        if isinstance(leaf, torch.Tensor):
            out[path] = leaf.detach().cpu().numpy()
        elif isinstance(leaf, torch.Generator):
            out["rng_state"] = leaf.get_state().numpy()
    return out


def _barrier(mesh):
    """Every rank of the mesh: each waits for its column, then its row."""
    for axis in ("objects", "space"):
        dist.barrier(group=mesh.comm.groups[axis][0])


def _mesh(ctx, n_objects_axis: int, n_space_axis: int = 1):
    n = n_objects_axis * n_space_axis
    return make_device_mesh(n_objects_axis, n_space_axis, device=ctx.device,
                            backend=ctx.backend, ranks=None if n == ctx.world_size else range(n))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_job(ctx, name: str, n_objects_axis: int, n_steps: int, checkpoint=None,
             gather: bool = True, serial_build: bool = False, record_labels: bool = False,
             n_space_axis: int = 1):
    """Build scene ``name`` on every rank (one rank after another with
    ``serial_build``, to bound the host's peak), start from ``checkpoint``
    if given, shard it over an (n_objects_axis, n_space_axis) mesh and take
    ``n_steps`` sharded steps. Returns, per rank: the local dims of the
    sharded leaves, the collectives of the steps, host staging, the bytes
    of the events' grid moves, the slots this rank received (objects that
    came alive here), the pairs of voxel objects on different rows with
    active contacts in any step (as body slots), step times, device peak
    memory over the step beyond the state (on the card), the kernel
    launches of the steps, with ``record_labels`` every occupancy grid (or
    slab) the rank labelled, and, on rank 0 with ``gather``, the whole
    state after the steps."""
    mesh = _mesh(ctx, n_objects_axis, n_space_axis)
    if mesh is None:
        return None
    dev = ctx.device
    world, cfg = scene(name, n_objects_axis)

    def build_local():
        build = compile_scene(world, cfg, device=dev)
        sim = build.sim
        if checkpoint is not None:
            sim, _ = load_checkpoint(checkpoint, sim, device=dev)
        return shard_sim_state(mesh, sim), build.params, build.info

    if serial_build:  # the whole state exists on one rank at a time
        flat = mesh.coordinate[0] * n_space_axis + mesh.coordinate[1]
        for r in range(n_objects_axis * n_space_axis):
            if r == flat:
                local, params, info = build_local()
            _barrier(mesh)
    else:
        local, params, info = build_local()
    step = make_sharded_engine_step(params, cfg, mesh, info["mesh_vert_cap"],
                                    info["mesh_tri_cap"])
    comm = mesh.comm
    o_loc = cfg.tpu.max_voxel_objects // n_objects_axis
    owner_of_body = {int(b): i // o_loc for i, b in enumerate(
        comm.all_gather(local.voxels.body_index).tolist())}
    comm.clear()
    state_bytes = sum(t.numel() * t.element_size() for _, t in leaves_with_path(local)
                      if isinstance(t, torch.Tensor))
    if dev.type == "cuda":
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    received, cross, step_ms, labelled = 0, set(), [], []
    run_labels = interaction.connected_component_labels_batched

    def rec_labels(occ):
        labelled.append(occ.cpu().numpy())
        return run_labels(occ)

    for counter in (scan_solver.LAUNCHES, k2.LAUNCHES):
        counter.reset()
    if record_labels:
        interaction.connected_component_labels_batched = rec_labels
    try:
        for _ in range(n_steps):
            alive0 = local.voxels.alive
            _sync(dev)
            t0 = time.perf_counter()
            with fp32_render():  # as HeadlessRuntime.step: float32 matmuls on the card
                local = step(local)
            _sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            received += int((local.voxels.alive & ~alive0).sum())
            c = local.phys.solver_cache
            for a, b in zip(c.body_a[c.active].tolist(), c.body_b[c.active].tolist()):
                oa, ob = owner_of_body.get(a), owner_of_body.get(b)
                if oa is not None and ob is not None and oa != ob:
                    cross.add((min(a, b), max(a, b)))
    finally:
        interaction.connected_component_labels_batched = run_labels
    launches = {**scan_solver.LAUNCHES, **k2.LAUNCHES}
    peak_extra = (torch.cuda.max_memory_allocated(dev) - base) if dev.type == "cuda" else None
    records = [r._asdict() for r in comm.records]
    out = dict(
        rank=ctx.rank, coordinate=mesh.coordinate, received=received,
        cross_pairs=sorted(cross), step_ms=step_ms, host_syncs=step.host_syncs,
        staged_bytes=comm.staged_bytes, records=records, state_bytes=state_bytes,
        event_bytes=step.event_bytes,
        launches=launches, labelled=labelled,
        peak_extra_bytes=peak_extra,
        local_dims={p: tuple(t.shape) for p, t in leaves_with_path(local)
                    if isinstance(t, torch.Tensor)},
        local_bytes={p: t.numel() * t.element_size() for p, t in leaves_with_path(local)
                     if isinstance(t, torch.Tensor)},
        finite=bool(torch.isfinite(local.phys.bodies.position).all()),
        n_alive=int(comm.all_gather(local.voxels.alive).sum()))
    if gather:
        whole = gather_sim_state(mesh, local)
        out["state"] = state_arrays(whole) if mesh.coordinate[0] == 0 else None
    return out


def halo_job(ctx, grid: np.ndarray, n_objects_axis: int, n_space_axis: int):
    """The sharded 3-point min filter of ``grid`` [O, Gx, Gy, Gz] on an
    (n_objects_axis, n_space_axis) mesh → the gathered result on the first
    rank, and the halo collectives."""
    mesh = _mesh(ctx, n_objects_axis, n_space_axis)
    if mesh is None:
        return None
    g = torch.as_tensor(grid, device=ctx.device)
    out = make_sharded_min_filter_x(mesh)(shard_tensor(mesh, g, OBJECTS_SPACE))
    whole = gather_tensor(mesh, out, OBJECTS_SPACE)
    halos = [r._asdict() for r in mesh.comm.records if r.op == "halo"]
    return dict(out=whole.cpu().numpy() if ctx.rank == 0 else None, halos=halos,
                coordinate=mesh.coordinate, staged_bytes=mesh.comm.staged_bytes)


def dryrun_mesh(n_devices: int) -> tuple:
    """The dry run's mesh: (n/2, 2) for even n ≥ 4, as the reference's
    (``__graft_entry__.py:92-99``), else (n, 1)."""
    n_space = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return n_devices // n_space, n_space


def dryrun_job(ctx, n_devices: int):
    """The dry run on one rank (``__graft_entry__.py:65-140``): one full
    sharded step of ``scene("dryrun")`` on the ``dryrun_mesh``, then the
    halo min filter of the stepped grids on the same mesh, held against
    the plain 3-point min."""
    n_obj, n_space = dryrun_mesh(n_devices)
    t0 = time.perf_counter()
    out = step_job(ctx, "dryrun", n_obj, 1, n_space_axis=n_space)
    step_s = time.perf_counter() - t0
    # every rank makes every mesh, those outside it too: a process group
    # that only some ranks create puts their group count out of step, and
    # the next mesh over every rank never meets
    mesh = _mesh(ctx, n_obj, n_space)
    if out is None:  # a rank outside the mesh
        return None
    sdf = torch.as_tensor(out.pop("state")["voxels/sdf"]) if ctx.rank == 0 else None
    shape = list(out["local_dims"]["voxels/sdf"])
    shape[0] *= n_obj
    shape[1] *= n_space
    grid = sdf.to(ctx.device) if sdf is not None else torch.empty(shape, device=ctx.device)
    grid = mesh.comm.broadcast(grid.float(), 0, "objects")
    if n_space > 1:
        grid = mesh.comm.broadcast(grid, 0, "space")
    t1 = time.perf_counter()
    got = gather_tensor(mesh, make_sharded_min_filter_x(mesh)(
        shard_tensor(mesh, grid, OBJECTS_SPACE)), OBJECTS_SPACE)
    pad = torch.nn.functional.pad(grid, (0, 0, 0, 0, 1, 1), value=float("inf"))
    want = torch.minimum(torch.minimum(pad[:, :-2], pad[:, 1:-1]), pad[:, 2:])
    halos = sum(r["op"] == "halo" for r in out["records"])
    return dict(step_s=step_s, halo_s=time.perf_counter() - t1, finite=out["finite"],
                mesh=(n_obj, n_space), halo_mesh=(n_obj, n_space),
                halo_equal=bool(torch.equal(got, want)), records=len(out["records"]),
                step_halos=halos)


def slab_labels_job(ctx, occ: np.ndarray, n_space_axis: int):
    """The labels of bool grids ``occ`` [B,G,G,G] split into slabs on a
    (1, n_space_axis) mesh (``step.slab_labels``): every rank's slab labels,
    its labels launches (on the card) and halo records, and on the first
    rank the gathered labels."""
    mesh = _mesh(ctx, 1, n_space_axis)
    if mesh is None:
        return None
    k2.LAUNCHES.reset()
    local = shard_tensor(mesh, torch.as_tensor(occ, device=ctx.device), OBJECTS_SPACE)
    lab = slab_labels(mesh, grid_slab(mesh, occ.shape[-1]), local)
    whole = gather_tensor(mesh, lab, OBJECTS_SPACE)
    return dict(labels=whole.cpu().numpy() if ctx.rank == 0 else None,
                slab=local.cpu().numpy(), launches=dict(k2.LAUNCHES),
                halos=[r._asdict() for r in mesh.comm.records if r.op == "halo"])


def slab_mesh_job(ctx, pool: dict, response: np.ndarray, n_space_axis: int,
                  merge_levels: int, vert_cap: int, tri_cap: int, material_table: np.ndarray):
    """The meshes and probes of a pool (``pool``: VoxelObjectPool fields as
    numpy arrays, whole grids) meshed slab by slab on a (1, n_space_axis)
    mesh (``step.slab_meshes_and_probes``): every rank's result as numpy
    arrays by field."""
    mesh = _mesh(ctx, 1, n_space_axis)
    if mesh is None:
        return None
    dev = ctx.device
    whole = VoxelObjectPool(**{k: torch.as_tensor(v, device=dev) for k, v in pool.items()})
    sub = whole._replace(sdf=shard_tensor(mesh, whole.sdf, OBJECTS_SPACE),
                         vtype=shard_tensor(mesh, whole.vtype, OBJECTS_SPACE))
    meshes, probes = slab_meshes_and_probes(
        mesh, grid_slab(mesh, whole.grid_size), sub, torch.as_tensor(response, device=dev),
        merge_levels, vert_cap, tri_cap, torch.as_tensor(material_table, device=dev))
    out = {f"meshes/{k}": v.cpu().numpy() for k, v in meshes._asdict().items()}
    out.update({f"probes/{k}": v.cpu().numpy() for k, v in probes._asdict().items()})
    return out


def mesh_job(ctx, grid: np.ndarray, n_objects_axis: int, n_space_axis: int):
    """The mesh's names, shape and this rank's coordinate, and a round trip
    of ``grid`` [O, Gx, ...] sharded over objects × space: each block
    doubled plus one, gathered (on the first rank)."""
    mesh = _mesh(ctx, n_objects_axis, n_space_axis)
    if mesh is None:
        return None
    local = shard_tensor(mesh, torch.as_tensor(grid, device=ctx.device), OBJECTS_SPACE)
    whole = gather_tensor(mesh, local * 2 + 1, OBJECTS_SPACE)
    return dict(axis_names=mesh.axis_names, dim_names=tuple(mesh.torch_mesh.mesh_dim_names),
                shape=mesh.shape, coordinate=mesh.coordinate, local_shape=tuple(local.shape),
                out=whole.cpu().numpy() if ctx.rank == 0 else None)


def guards_job(ctx):
    """On 4 ranks: the ValueErrors of a pool that does not divide over the
    objects axis (sharding it, and the sharded step), of slabs the step
    cannot split along x (G not a multiple of the space axis, a slab not a
    multiple of the probe block or of 2**mesh_merge_levels), and of chunked
    mode. Each names what it refuses."""
    meshes = _mesh(ctx, 4), _mesh(ctx, 1, 4)  # every rank makes every mesh
    if meshes[0] is None:
        return None
    world, cfg = scene("dryrun", 3)  # 6 slots
    build = compile_scene(world, cfg, device=ctx.device)
    caps = build.info["mesh_vert_cap"], build.info["mesh_tri_cap"]
    errors = {}

    def expect(name, fn):
        try:
            fn()
        except ValueError as e:
            errors[name] = str(e)

    expect("shard", lambda: shard_sim_state(meshes[0], build.sim))
    expect("step", lambda: make_sharded_engine_step(build.params, cfg, meshes[0], *caps))
    world, cfg = scene("dryrun", 2)  # 4 slots
    build = compile_scene(world, cfg, device=ctx.device)
    for name, g, levels in (("slab_divide", 18, 2), ("slab_probe", 24, 2),
                            ("slab_merge", 16, 3)):
        bad = scene("dryrun", 2)[1]
        bad.tpu.voxel_grid_size, bad.tpu.mesh_merge_levels = g, levels
        expect(name, lambda c=bad: make_sharded_engine_step(build.params, c, meshes[1], *caps))
    cfg.tpu.chunked_remesh = True
    expect("chunked", lambda: make_sharded_engine_step(build.params, cfg, meshes[0], *caps))
    return errors


def solver_scene(n_bodies: int, n_contacts: int, device, seed: int = 11, warm: bool = False):
    """``tests/test_parallel.py:142-187``'s random contact scene from numpy
    with ``seed``: (whole bodies, the prepared contacts, the default
    ConstraintSolverConfig) on ``device``. With ``warm``, the contacts are
    prepared against a cache that holds every slot's key, normal and
    tangent with random impulses, so the solve warm-starts."""
    rng = np.random.default_rng(seed)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    b = empty_body_state(n_bodies, device)
    b = b._replace(
        kind=torch.full((n_bodies,), KIND_DYNAMIC, dtype=b.kind.dtype, device=device),
        inv_mass=t(rng.uniform(0.2, 2.0, n_bodies)),
        inv_inertia_body=torch.eye(3, device=device).expand(n_bodies, 3, 3).contiguous(),
        position=t(rng.normal(size=(n_bodies, 3))),
        momentum=t(rng.normal(size=(n_bodies, 3))))
    ia = rng.integers(0, n_bodies, n_contacts)
    ib = (ia + 1 + rng.integers(0, n_bodies - 1, n_contacts)) % n_bodies
    nrm = rng.normal(size=(n_contacts, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    buf = ContactBuffer(
        active=t(rng.uniform(size=n_contacts) < 0.9, torch.bool),
        key=torch.arange(n_contacts, dtype=torch.int64, device=device),
        body_a=t(ia, torch.int64), body_b=t(ib, torch.int64),
        position=t(rng.normal(size=(n_contacts, 3))), normal=t(nrm),
        depth=t(rng.uniform(0.0, 0.05, n_contacts)),
        response=t(np.tile([[0.3, 0.6, 0.4]], (n_contacts, 1))))
    cfg = ConstraintSolverConfig()
    cache = empty_solver_cache(n_contacts, device)
    if warm:
        cold = prepare_contacts(b, buf, cache, cfg)
        cache = cache._replace(key=buf.key, normal=cold.normal, tangent=cold.tangent,
                               impulses=t(rng.uniform(0.0, 0.05, (n_contacts, 3))),
                               active=buf.active)
    return b, prepare_contacts(b, buf, cache, cfg), cfg


def solver_config(cfg, iterations):
    """``cfg`` with (velocity, correction) ``iterations``; None keeps its own."""
    if iterations is not None:
        cfg.n_iterations, cfg.n_positional_correction_iterations = iterations
    return cfg


def tree_arrays(tree) -> dict:
    return {f: t.detach().cpu().numpy() for f, t in tree._asdict().items()}


def solve_job(ctx, n_bodies: int, n_contacts: int, mode: str, iterations=None, seed: int = 11,
              warm: bool = False, reps: int = 1):
    """The body-sharded contact solve (``solver.sharded_solve_contacts``) of
    ``solver_scene(n_bodies, n_contacts, seed, warm)`` on the SOLVE_MESH:
    the contacts prepared whole on every rank, the bodies sharded, one
    warm-up solve, then ``reps`` timed ones. Returns, per rank: the solve's
    ms (each timed one), the collectives of the last one, host staging, the
    device peak of the last one over its inputs (on the card), the scan
    launches of the timed ones, with ``mode="scan"`` the last call of
    ``scan_iterations`` (inputs and outputs), the whole cache, and on the
    first rank the gathered bodies."""
    mesh = _mesh(ctx, *SOLVE_MESH)
    if mesh is None:
        return None
    dev = ctx.device
    whole, prep, cfg = solver_scene(n_bodies, n_contacts, dev, seed, warm)
    cfg = solver_config(cfg, iterations)
    local = shard_bodies(mesh, whole)
    comm = mesh.comm
    scan_calls = []
    run_scan = psolver.scan_iterations

    def rec_scan(*args):
        out = run_scan(*args)
        scan_calls[:] = [(args, out)]
        return out

    def solve():
        with fp32_render():  # float32 matmuls on the card
            return psolver.sharded_solve_contacts(mesh, local, prep, cfg, mode)

    solve()
    ms, peak = [], None
    scan_solver.LAUNCHES.reset()
    psolver.scan_iterations = rec_scan
    try:
        for i in range(reps):
            comm.clear()
            _sync(dev)
            if dev.type == "cuda" and i == reps - 1:
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            out, cache = solve()
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        psolver.scan_iterations = run_scan
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev) - base
    records = [r._asdict() for r in comm.records]
    staged = comm.staged_bytes
    gathered = gather_bodies(mesh, out)
    scan = None
    if scan_calls:
        args, res = scan_calls[0]
        v, w, pos, ori, inv_mass, inv_inertia, sprep, acc, n_it, n_corr, factor = args
        scan = dict(inputs=dict(tensors=[x.cpu().numpy() for x in (v, w, pos, ori, inv_mass,
                                                                   inv_inertia, acc)],
                                prep=tree_arrays(sprep), scalars=(n_it, n_corr, factor)),
                    outputs=[x.cpu().numpy() for x in res])
    return dict(rank=ctx.rank, coordinate=mesh.coordinate, ms=ms, records=records,
                staged_bytes=staged, peak_extra_bytes=peak,
                launches=dict(scan_solver.LAUNCHES), scan=scan, local_rows=out.n,
                cache=tree_arrays(cache),
                bodies=tree_arrays(gathered) if ctx.rank == 0 else None)


def solve_guard_job(ctx, n_bodies: int):
    """The ValueError of shard_bodies for N bodies that do not divide over
    the SOLVE_MESH's objects axis, or None if it shards."""
    mesh = _mesh(ctx, *SOLVE_MESH)
    if mesh is None:
        return None
    try:
        shard_bodies(mesh, empty_body_state(n_bodies, ctx.device))
    except ValueError as e:
        return str(e)
    return None


def chunked_refusal_job(ctx):
    """The dry run's dense state with its meshes replaced by an empty chunk
    pool (a chunked state's ``meshes``, whose overflow counters are 0-d):
    the ValueErrors of ``shard_sim_state`` and of the sharded step with
    ``tpu.chunked_remesh`` on a 2×2 mesh."""
    mesh = _mesh(ctx, 2, 2)
    if mesh is None:
        return None
    world, cfg = scene("dryrun", 2)
    build = compile_scene(world, cfg, device=ctx.device)
    sim = build.sim._replace(meshes=empty_chunk_mesh_pool(
        16, 64, cfg.tpu.max_voxel_objects, cfg.tpu.voxel_grid_size, device=ctx.device))
    errors = {}
    try:
        shard_sim_state(mesh, sim)
    except ValueError as e:
        errors["shard"] = str(e)
    cfg.tpu.chunked_remesh = True
    try:
        make_sharded_engine_step(build.params, cfg, mesh, build.info["mesh_vert_cap"],
                                 build.info["mesh_tri_cap"])
    except ValueError as e:
        errors["step"] = str(e)
    return errors
