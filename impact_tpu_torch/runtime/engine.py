"""The engine step: physics with voxel contacts, absorption, fracture, split
detection, the inertia/remesh/probe sync of changed objects and, on chunked
grids, the budgeted chunk remesh (port of ``impact_tpu/runtime/engine.py``;
ref: engine/src/engine.rs and the frame task DAG of engine/src/tasks.rs).

Voxel object slot ``i`` binds rigid-body slot ``voxel_body_offset + i``, so
a new fragment activates a precomputed slot instead of allocating.

Chunked mode (``tpu.chunked_remesh``, on by default at G ≥ 64) keeps the
surface meshes in a shared pool of chunk-submesh slots
(``voxel/chunk_mesh.py``): absorbers carve only the chunk windows they
overlap and dirty only those chunks, objects that a split or fracture just
created detach from their old slots, the object sync keeps inertia and
probes, and up to ``chunk_remesh_budget`` dirty chunks re-mesh a step.

The reference traces its data-dependent branches (``lax.cond`` around a
fracture event, each split candidate, the remesh sync and the chunk
remesh). Here each is a host ``if`` on values read from the device, one
read per decision: one for the fracture event (when fracturing is on), one
for the split candidates, one for the dirty objects and, in chunked mode,
one for the dirty chunks. ``step.host_syncs`` counts them. Scenes without
absorbers skip absorption statically, as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..math import quaternion as quat
from ..math.quaternion import cross
from ..physics.driven_motion import _scatter
from ..physics.state import KIND_DYNAMIC, compute_velocities, synchronize_momenta
from ..physics.step import PhysicsParams, PhysicsState, physics_step
from ..render.camera import Camera
from ..render.lights import LightPools
from ..render.pipeline import RenderState
from ..scene.assembly import MeshInstancePool, StaticGeometry
from ..voxel.chunk_mesh import (
    ChunkMeshPool,
    mark_chunks_dirty,
    mark_objects_dirty,
    remesh_chunks,
    reset_objects,
)
from ..voxel.collision import (
    VoxelProbes,
    extract_probes,
    merge_contact_buffers,
    stable_topk,
    voxel_contacts,
)
from ..voxel.encoding import sdf_world
from ..voxel.inertia import inertial_properties
from ..voxel.interaction import (
    AbsorberPools,
    apply_absorption,
    apply_absorption_chunk_gated,
    connected_component_labels,
    draw_fracture_uniforms,
    fracture_object,
    split_off_disconnected_regions,
)
from ..voxel.mesh import (
    CompactMesh,
    bake_mesh_materials,
    compact_mesh,
    compact_mesh_slab,
    surface_nets,
    surface_nets_blocks,
)
from ..voxel.object import VoxelObjectPool, occupancy

# objects meshed per batched Surface Nets call in the remesh sync (bounds
# the temporaries of a fracture event's ~160 fresh fragments)
REMESH_CHUNK = 32


class SimState(NamedTuple):
    """Simulation state. Tensors are never updated in place, so a SimState
    kept aside (``HeadlessRuntime.reset_world``) stays valid; the generator
    is the one mutable member."""

    phys: PhysicsState
    voxels: VoxelObjectPool
    meshes: CompactMesh | ChunkMeshPool  # [O, ...], or the chunk slots in chunked mode
    probes: VoxelProbes  # [O,P] collision probes, refreshed on remesh
    render: RenderState
    prev_position: torch.Tensor  # f32[N,3] body poses at the previous step
    prev_orientation: torch.Tensor  # f32[N,4]
    rng: torch.Generator  # fracture seeds


class DistanceRulePools(NamedTuple):
    """Distance-triggered rules (ref: impact_scene DistanceTriggeredRules,
    systems.rs:80): beyond a distance from an anchor body the entity stops
    casting shadows, beyond another it is removed."""

    body: torch.Tensor  # i64[Dr] ruled entity's body slot
    anchor_body: torch.Tensor  # i64[Dr]
    obj_slot: torch.Tensor  # i64[Dr] voxel-object slot, −1 = not a voxel object
    no_shadow_d2: torch.Tensor  # f32[Dr]
    removal_d2: torch.Tensor  # f32[Dr]
    mask: torch.Tensor  # bool[Dr]


def empty_distance_rule_pools(cap: int = 16, device="cuda") -> DistanceRulePools:
    return DistanceRulePools(
        body=torch.zeros(cap, dtype=torch.int64, device=device),
        anchor_body=torch.zeros(cap, dtype=torch.int64, device=device),
        obj_slot=torch.full((cap,), -1, dtype=torch.int64, device=device),
        no_shadow_d2=torch.full((cap,), 1e30, device=device),
        removal_d2=torch.full((cap,), 1e30, device=device),
        mask=torch.zeros(cap, dtype=torch.bool, device=device),
    )


def apply_distance_rules(phys: PhysicsState, pool: VoxelObjectPool, rules: DistanceRulePools,
                         casts_shadows_base):
    """Beyond ``no_shadow_d2`` from its anchor a ruled voxel object stops
    casting shadows (and casts again within it); beyond ``removal_d2`` its
    body becomes empty (kind 0) and its object slot dies (ref:
    runtime/engine.py:_apply_distance_rules). Masked-off rules write a
    spare row that is dropped, where the reference scatters to index
    ``n_objects`` with mode="drop"."""
    b = phys.bodies
    d2 = ((b.position[rules.body] - b.position[rules.anchor_body]) ** 2).sum(dim=-1)
    remove = rules.mask & (d2 > rules.removal_d2)
    no_shadow = rules.mask & (d2 > rules.no_shadow_d2)
    kind = _scatter(b.kind, rules.body, rules.mask,
                         torch.where(remove, 0, b.kind[rules.body]))
    on_obj = rules.mask & (rules.obj_slot >= 0)
    slot = torch.clamp(rules.obj_slot, min=0)
    alive = _scatter(pool.alive, slot, on_obj, pool.alive[slot] & ~remove)
    casts = _scatter(pool.casts_shadows, slot, on_obj,
                          casts_shadows_base[slot] & ~no_shadow)
    return (phys._replace(bodies=b._replace(kind=kind)),
            pool._replace(alive=alive, casts_shadows=casts))


class EngineParams(NamedTuple):
    """Scene-constant parameters."""

    phys_params: PhysicsParams
    lights: LightPools
    absorbers: AbsorberPools
    type_density: torch.Tensor  # f32[T]
    voxel_response: torch.Tensor  # f32[O,3]
    fracturable: torch.Tensor  # bool[O]
    fracture_threshold: torch.Tensor  # f32[O]
    fracture_radius: torch.Tensor  # f32[O]
    camera: Camera
    static_geometry: StaticGeometry
    dist_rules: DistanceRulePools  # empty_distance_rule_pools where a scene has none
    casts_shadows_base: torch.Tensor  # bool[O] shadow casting from the scene
    mesh_instances: MeshInstancePool  # renderable mesh-model entities
    material_table: torch.Tensor  # f32[T,10]


def gather_objects(pool: VoxelObjectPool, idx) -> VoxelObjectPool:
    """The pool at object slots ``idx``."""
    return VoxelObjectPool(*(a[idx] for a in pool))


def _put(t, idx, rows):
    """t with rows ``idx`` replaced (a new tensor)."""
    return t.index_copy(0, idx, rows.to(t.dtype))


# the body fields the object sync rewrites, in this order
BODY_SYNC_FIELDS = ("kind", "mass", "inv_mass", "inertia_body", "inv_inertia_body", "position")


def voxel_body_rows(phys: PhysicsState, pool: VoxelObjectPool, type_density, sync_mask,
                    x0: int = 0, reduce=None):
    """(the rows of BODY_SYNC_FIELDS of the objects' bodies, the objects'
    grid origins) after the sync of the masked objects: mass and inertia
    from the grids, each body origin at its object's COM (the position
    shifts by R·Δcom and the grid origin compensates; ref:
    object/inertia.rs property transfer). A pool of slabs sums its
    inertia over the slabs with ``reduce`` (``inertial_properties``)."""
    mass, com, inertia = inertial_properties(pool, type_density, x0, reduce)
    b = phys.bodies
    bidx = pool.body_index
    sm = sync_mask & pool.alive & (mass > 1e-9)
    sm1, sm2, sm3 = sm[:, None], sm[:, None, None], sm
    new_pos = b.position[bidx] + quat.rotate(b.orientation[bidx], com)
    inv_inertia = torch.linalg.inv(inertia + torch.eye(3, device=inertia.device) * 1e-12)
    rows = (torch.where(sm3, KIND_DYNAMIC, b.kind[bidx]),
            torch.where(sm3, mass, b.mass[bidx]),
            torch.where(sm3, 1.0 / torch.clamp(mass, min=1e-9), b.inv_mass[bidx]),
            torch.where(sm2, inertia, b.inertia_body[bidx]),
            torch.where(sm2, inv_inertia, b.inv_inertia_body[bidx]),
            torch.where(sm1, new_pos, b.position[bidx]))
    return rows, torch.where(sm1, pool.origin - com, pool.origin)


def put_body_rows(phys: PhysicsState, bidx, rows) -> PhysicsState:
    """phys with the BODY_SYNC_FIELDS rows of bodies ``bidx`` replaced."""
    b = phys.bodies
    return phys._replace(bodies=b._replace(**{
        f: _put(getattr(b, f), bidx, r) for f, r in zip(BODY_SYNC_FIELDS, rows)}))


def _sync_voxel_bodies(phys: PhysicsState, pool: VoxelObjectPool, type_density, sync_mask):
    """Refresh body mass/inertia for the masked voxel objects and keep each
    body origin at its object's COM (``voxel_body_rows``)."""
    rows, origin = voxel_body_rows(phys, pool, type_density, sync_mask)
    return put_body_rows(phys, pool.body_index, rows), pool._replace(origin=origin)


def _inherit_fragment_motion(phys: PhysicsState, pool: VoxelObjectPool, src_body, new_mask):
    """New fragment bodies take the source body's pose and the source's point
    velocity at their position (momentum conservation per fragment)."""
    b = phys.bodies
    bidx = pool.body_index
    v, w = compute_velocities(b)
    src_pos, src_ori = b.position[src_body], b.orientation[src_body]
    nm = new_mask[:, None]
    b = b._replace(
        position=_put(b.position, bidx, torch.where(nm, src_pos[None, :], b.position[bidx])),
        orientation=_put(b.orientation, bidx,
                         torch.where(nm, src_ori[None, :], b.orientation[bidx])),
    )
    r = b.position[bidx] - src_pos[None, :]
    v_point = v[src_body][None, :] + cross(w[src_body][None, :], r)
    vv = _put(v, bidx, torch.where(nm, v_point, v[bidx]))
    ww = _put(w, bidx, torch.where(nm, w[src_body][None, :], w[bidx]))
    sel = torch.zeros(b.n, dtype=torch.bool, device=new_mask.device)
    sel[bidx] = new_mask
    sel = sel[:, None]
    synced = synchronize_momenta(b, vv, ww)
    b = b._replace(
        momentum=torch.where(sel, synced.momentum, b.momentum),
        angular_momentum=torch.where(sel, synced.angular_momentum, b.angular_momentum),
        velocity=torch.where(sel, vv, b.velocity),
        angular_velocity=torch.where(sel, ww, b.angular_velocity),
    )
    return phys._replace(bodies=b)


def _free_slots(alive):
    """Free object slots first, in slot order; −1 past the last free one."""
    order = torch.argsort(alive.to(torch.uint8), stable=True)
    return torch.where(~alive[order], order, -1)


def event_slots(free_all, e: int, n: int):
    """The ``n`` free slots of event ``e`` (disjoint ranges of ``free_all``;
    all −1 past its end)."""
    lo = e * n
    if lo + n <= free_all.shape[0]:
        return free_all[lo:lo + n]
    return torch.full((n,), -1, dtype=torch.int64, device=free_all.device)


def fracture_candidates(phys: PhysicsState, pool: VoxelObjectPool, params, n_events: int):
    """(the ``n_events`` objects of highest contact impulse, each object's
    impulse where it exceeds its fracture threshold else −inf, each
    object's strongest contact slot) from the solver cache (ref:
    fracturing.rs:508). Reads only the pool's per-object vectors."""
    cache = phys.solver_cache
    imp_n = torch.where(cache.active, cache.impulses[:, 0], 0.0)
    bo = pool.body_index[:, None]
    involved = (cache.body_a[None, :] == bo) | (cache.body_b[None, :] == bo)  # [O,C]
    imp_per_obj = torch.where(involved, imp_n[None, :], 0.0).max(dim=1).values
    best_contact = torch.argmax(torch.where(involved, imp_n[None, :], -1.0), dim=1)
    exceed = params.fracturable & pool.alive & (imp_per_obj > params.fracture_threshold)
    ranked = torch.where(exceed, imp_per_obj, float("-inf"))
    return stable_topk(ranked, n_events), ranked, best_contact


def impact_point_local(phys: PhysicsState, contact, body):
    """The solver cache's contact point ``contact`` in ``body``'s frame."""
    b = phys.bodies
    return quat.inverse_rotate(b.orientation[body],
                               phys.solver_cache.position[contact] - b.position[body])


class MeshSlab(NamedTuple):
    """A sub-pool of slabs to mesh as whole grids (``remesh_objects``):
    the slab's first x plane, its place among ``count`` slabs, the two x
    planes right of it (sdf and vtype, [K,2,G,G]; unread at the last slab),
    and the slabs' ``gather`` and ``combine`` (``compact_mesh_slab``)."""

    x0: int
    index: int
    count: int
    right_sdf: torch.Tensor
    right_vtype: torch.Tensor
    gather: object
    combine: object


def remesh_objects(sub: VoxelObjectPool, merge_levels: int, vert_cap: int, tri_cap: int,
                   material_table, slab: MeshSlab | None = None) -> CompactMesh:
    """Surface Nets + compaction + material bake of a gathered sub-pool, in
    batches of REMESH_CHUNK objects. With ``slab``, the sub-pool holds
    slabs and every slab of its objects gets the objects' whole meshes: it
    meshes its cells and the quads whose lower cell it holds (reading the
    right planes) and the slabs' compacted pieces are combined
    (``compact_mesh_slab``)."""
    world = sdf_world(sub.sdf, sub.voxel_extent)
    vtype = sub.vtype
    if slab is not None and slab.index < slab.count - 1:
        ext = sub.voxel_extent
        world = torch.cat([world, sdf_world(slab.right_sdf, ext)], dim=1)
        vtype = torch.cat([vtype, slab.right_vtype], dim=1)
    parts = []
    for lo in range(0, world.shape[0], REMESH_CHUNK):
        sdf_b, vt_b = world[lo:lo + REMESH_CHUNK], vtype[lo:lo + REMESH_CHUNK]
        if slab is None:
            mesh = compact_mesh(surface_nets(sdf_b, vt_b, merge_levels), vert_cap, tri_cap)
        else:
            verts, blocks = surface_nets_blocks(sdf_b, vt_b, merge_levels, slab.x0)
            n_own = sub.sdf.shape[1] - (1 if slab.index == slab.count - 1 else 0)
            mesh = compact_mesh_slab(verts, blocks, n_own, slab.index, vert_cap, tri_cap,
                                     slab.gather, slab.combine)
        parts.append(bake_mesh_materials(mesh, material_table))
    return CompactMesh(*(torch.cat(f) for f in zip(*parts)))


class StepPlan(NamedTuple):
    """The sizes and switches an engine step fixes when it is made."""

    dt: float
    n_substeps: int
    solver_cfg: object
    max_contacts: int
    o_max: int
    remesh_budget: int  # dirty objects synced and re-meshed per step
    impact_cfg: object
    n_seeds: int  # Voronoi seeds of a fracture event
    n_events: int  # fracture events per step
    n_split_objs: int  # split candidates checked per step
    n_split_regions: int  # regions extracted per candidate
    draw: object  # (generator, n_seeds) -> an event's uniforms
    absorb: bool  # the scene has absorbers and absorption is on
    rules: bool  # the scene has distance rules


def step_plan(params: EngineParams, config, enable_absorption: bool, enable_fracturing: bool,
              fracture_uniforms=None, *, remesh_budget: int | None = None) -> StepPlan:
    """The plan of the engine step of ``params`` under ``config`` (shared by
    ``make_engine_step`` and ``parallel.step.make_sharded_engine_step``).
    ``remesh_budget`` None takes the reference's default budget."""
    tc = config.tpu
    o_max = tc.max_voxel_objects
    impact_cfg = config.voxel.interaction.fracturing.impact
    if remesh_budget is None:
        remesh_budget = (min(o_max, max(4, tc.max_fracture_fragments * tc.max_fracture_events))
                         if enable_fracturing else min(o_max, 4))
    return StepPlan(
        dt=config.physics.simulator.initial_time_step_duration,
        n_substeps=config.physics.simulator.n_substeps,
        solver_cfg=config.physics.constraint_solver,
        max_contacts=tc.max_contacts,
        o_max=o_max,
        remesh_budget=int(remesh_budget),
        impact_cfg=impact_cfg,
        n_seeds=max(2, min(impact_cfg.max_fragment_count, tc.max_fracture_fragments, o_max)),
        n_events=min(tc.max_fracture_events, o_max),
        n_split_objs=max(1, min(tc.max_split_objects, o_max)),
        n_split_regions=max(1, min(tc.max_split_regions, o_max)),
        draw=fracture_uniforms or draw_fracture_uniforms,
        # scenes without absorbers skip the pass, without distance rules the
        # rules (the pools are scene constants)
        absorb=enable_absorption and bool(params.absorbers.sph_mask.any()
                                          or params.absorbers.cap_mask.any()),
        rules=bool(params.dist_rules.mask.any()),
    )


def make_engine_step(params: EngineParams, config, mesh_vert_cap: int, mesh_tri_cap: int,
                     enable_voxel_contacts: bool = True, enable_absorption: bool = True,
                     enable_splitting: bool = True, enable_fracturing: bool = True,
                     remesh_budget: int | None = None, fracture_uniforms=None):
    """The engine step ``step(sim) -> SimState`` for the scene constants
    ``params``, with the features fixed (ref: runtime/engine.py:214-222:
    without voxel contacts the physics step gets no probe contacts, without
    absorption the absorbers carve nothing). Up to ``remesh_budget`` dirty
    objects are synced and re-meshed per step, lowest slots first, the rest
    staying dirty (None: the reference's default, max_fracture_fragments ×
    max_fracture_events with fracturing, else 4, at most the pool). ``fracture_uniforms(
    generator, n_seeds)`` draws an event's uniforms (default
    ``draw_fracture_uniforms``; the tests pass JAX's)."""
    tc = config.tpu
    chunked = bool(tc.chunked_remesh)
    (dt, n_substeps, solver_cfg, max_contacts, o_max, remesh_budget, impact_cfg, n_seeds,
     n_events, n_split_objs, n_split_regions, draw, absorb, rules) = step_plan(
        params, config, enable_absorption, enable_fracturing, fracture_uniforms,
        remesh_budget=remesh_budget)

    def host(t):
        step.host_syncs += 1
        return t.tolist()

    def extra_contacts(pool, probes):
        def fn(bodies, contacts):
            vc = voxel_contacts(pool, probes, params.phys_params.collidables, bodies.position,
                                bodies.orientation, max_contacts)
            return merge_contact_buffers(contacts, vc, max_contacts)

        return fn

    def maybe_fracture(phys: PhysicsState, pool: VoxelObjectPool, gen):
        """Fracture the objects whose contact impulse exceeds their threshold,
        up to ``n_events`` per step (ref: fracturing.rs:508)."""
        top_obj, ranked, best_contact = fracture_candidates(phys, pool, params, n_events)
        # free-slot ranges per event, disjoint, computed up front
        free_all = _free_slots(pool.alive)
        valid = host(torch.isfinite(ranked[top_obj]))
        for e in range(n_events):
            if not valid[e]:
                continue
            target = top_obj[e]
            free = event_slots(free_all, e, n_seeds - 1)
            tb = pool.body_index[target]
            impact_local = impact_point_local(phys, best_contact[target], tb)
            pool2 = fracture_object(pool, target, impact_local, draw(gen, n_seeds), free,
                                    params.fracture_radius[target], n_seeds, impact_cfg)
            phys = _inherit_fragment_motion(phys, pool2, tb, pool2.alive & ~pool.alive)
            pool = pool2
        return phys, pool

    def maybe_split(phys: PhysicsState, pool: VoxelObjectPool):
        """Check up to ``n_split_objs`` pending objects, extracting up to
        ``n_split_regions`` regions of each (ref: extraction.rs:78)."""
        candidates = pool.split_pending & pool.alive
        cand_objs = stable_topk(candidates.to(torch.int32), n_split_objs)
        free_all = _free_slots(pool.alive)
        flags = host(candidates[cand_objs])
        valid = [e for e in range(n_split_objs) if flags[e]]
        if not valid:
            return phys, pool
        # One labelling call labels every valid candidate. The reference labels
        # and extracts them one after another; the batch is the same because
        # an extraction writes only its own object and free slots, and the
        # candidates are alive (never free), so no extraction changes the
        # grid, extent, origin or body of a later candidate.
        objs = cand_objs[valid]
        labels = connected_component_labels(occupancy(pool)[objs])
        for k, e in enumerate(valid):
            obj = cand_objs[e]
            slots = event_slots(free_all, e, n_split_regions)
            pool2, _, _ = split_off_disconnected_regions(pool, obj, slots, labels[k])
            phys = _inherit_fragment_motion(phys, pool2, pool.body_index[obj],
                                            pool2.alive & ~pool.alive)
            pool = pool2
        return phys, pool

    def sync_dirty(phys, pool, meshes, probes):
        """Inertia/COM sync, remesh (dense mode) and probe refresh of up to
        ``remesh_budget`` dirty objects, lowest slots first. The reference
        computes a fixed-size gather of ``remesh_budget`` slots and masks
        the clean ones out; only the dirty ones are computed here."""
        idx = torch.nonzero(pool.mesh_dirty).flatten()[:remesh_budget]  # reads the count
        step.host_syncs += 1
        if idx.numel() == 0:
            return phys, pool, meshes, probes
        sub = gather_objects(pool, idx)
        sel = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
        phys, sub = _sync_voxel_bodies(phys, sub, params.type_density, sel)
        pool = pool._replace(origin=_put(pool.origin, idx, sub.origin),
                             mesh_dirty=_put(pool.mesh_dirty, idx, ~sel))
        if not chunked:
            new_mesh = remesh_objects(sub, tc.mesh_merge_levels, mesh_vert_cap, mesh_tri_cap,
                                      params.material_table)
            meshes = CompactMesh(*(_put(old, idx, new) for old, new in zip(meshes, new_mesh)))
        new_probes = extract_probes(sub, params.voxel_response[idx])
        probes = VoxelProbes(*(_put(old, idx, new) for old, new in zip(probes, new_probes)))
        return phys, pool, meshes, probes

    def absorption(phys, pool):
        """Step 2 (ref task ApplyVoxelAbsorption): the chunk-gated carve in
        chunked mode, with its changed objects and dirty chunks; else the
        object-gated (or dense) pass, which marks whole objects dirty."""
        b = phys.bodies
        if chunked:
            # the reference's float32 step count, rounded half to even
            step_no = torch.round(phys.time / dt).to(torch.int64)
            pool, changed, chunks, _ = apply_absorption_chunk_gated(
                pool, params.absorbers, b.position, b.orientation, tc.absorption_chunk_budget,
                rotation=step_no * tc.absorption_chunk_budget)
            return pool, changed, chunks
        pool = apply_absorption(pool, params.absorbers, b.position, b.orientation,
                                gate_cap=min(tc.absorption_gate_cap, o_max))
        return pool, None, None

    def step(sim: SimState) -> SimState:
        phys, pool = sim.phys, sim.voxels
        prev_pos, prev_ori = phys.bodies.position, phys.bodies.orientation
        if rules:
            phys, pool = apply_distance_rules(phys, pool, params.dist_rules,
                                              params.casts_shadows_base)
        phys = physics_step(phys, params.phys_params, dt, n_substeps, solver_cfg, max_contacts,
                            tc.solver_mode,
                            extra_contacts(pool, sim.probes) if enable_voxel_contacts else None)
        absorb_changed = absorb_chunks = None
        if absorb:
            pool, absorb_changed, absorb_chunks = absorption(phys, pool)
        if enable_fracturing:
            phys, pool = maybe_fracture(phys, pool, sim.rng)
        if enable_splitting:
            phys, pool = maybe_split(phys, pool)
        meshes = sim.meshes
        if chunked:
            # object slots a split or fracture just filled detach from their
            # old submesh slots; topology events and older dirt re-mesh whole
            # objects, the carve only its chunks (and joins mesh_dirty so the
            # inertia and probe sync still runs for carved objects)
            meshes = reset_objects(meshes, pool.alive & ~sim.voxels.alive)
            meshes = mark_objects_dirty(meshes, pool.mesh_dirty)
            if absorb_chunks is not None:
                meshes = mark_chunks_dirty(meshes, absorb_chunks)
                pool = pool._replace(mesh_dirty=pool.mesh_dirty | absorb_changed)
        phys, pool, meshes, probes = sync_dirty(phys, pool, meshes, sim.probes)
        if chunked and host((meshes.chunk_dirty & pool.alive[:, None]).any()):
            # step 5b: the budgeted chunk remesh (ref: mesh.rs:360)
            meshes = remesh_chunks(meshes, pool, params.material_table, tc.chunk_remesh_budget,
                                   tc.chunk_vert_cap, merge_levels=tc.mesh_merge_levels)
        return SimState(phys=phys, voxels=pool, meshes=meshes, probes=probes, render=sim.render,
                        prev_position=prev_pos, prev_orientation=prev_ori, rng=sim.rng)

    step.host_syncs = 0
    return step
